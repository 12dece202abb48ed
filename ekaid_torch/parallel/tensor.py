"""Tensor parallelism over the mesh's 'model' axis (the port of the
reference's P(None, 'model') / P('model', None) parameter shardings,
`ekaid_tpu/parallel/mesh.py`).

The reference names the shardings and XLA inserts the collectives. Here
a sharded parameter is this rank's block of the full tensor (`Shard`),
and the layers that hold one (`models/layers.py`) run their products
through the conjugate ops below, each a `torch.autograd.Function` over
the model group:

  * `copy_in`: the identity, whose backward sums the gradient over the
    group (a replicated input entering a sharded product);
  * `reduce_out`: the sum over the group, whose backward is the
    identity (partial products leaving a row-parallel product);
  * `gather_last`: the blocks of the group joined along the last dim,
    whose backward keeps this rank's block (a column-parallel output);
  * `take_slice`: this rank's columns of a replicated input, whose
    backward gathers every rank's (the input of a row-parallel product).

Everything outside the sharded products is replicated over the model
group and computed the same on each of its ranks. The collectives are
`all_reduce` and `all_gather` (the list form) only: gloo takes CUDA
tensors for both. A collective that fails raises.

`shard_parameters` cuts a model's rule-matched parameters to this
rank's blocks; `full_tensor` and `full_state` join them again (for a
snapshot or K1's weights), `local_state` cuts a full state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ekaid_torch.parallel.mesh import all_reduce_sum, param_shardings


@dataclass(frozen=True)
class Shard:
    """Rank `index` of `parts`'s block of parameter `name` of a module:
    rows (dim 0) or columns (dim 1) [start, stop) of the full tensor's
    `size` along `dim`."""
    name: str
    dim: int
    size: int
    index: int
    parts: int
    group: object

    def bounds(self, index: Optional[int] = None) -> Tuple[int, int]:
        i = self.index if index is None else index
        n = self.size // self.parts
        return i * n, (i + 1) * n

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor."""
        a, b = self.bounds()
        return full.narrow(self.dim, a, b - a)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x (all of one shape) joined along `dim`, in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.index, ctx.n = dist.get_rank(group), x.shape[-1]
        return gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spans, index, group):
        ctx.spans, ctx.group, ctx.width = spans, group, x.shape[-1]
        a, b = spans[index]
        return x[..., a:b]

    @staticmethod
    def backward(ctx, g):
        # the ranks' blocks may differ in width: each is padded to the
        # widest for the gather and cut back after it
        widest = max(b - a for a, b in ctx.spans)
        pad = g.new_zeros(*g.shape[:-1], widest)
        pad[..., :g.shape[-1]] = g
        parts = gather(pad[None], ctx.group, 0)
        out = g.new_zeros(*g.shape[:-1], ctx.width)
        for (a, b), part in zip(ctx.spans, parts):
            out[..., a:b] = part[..., :b - a]
        return out, None, None, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceOut.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherLast.apply(x, group)


def take_slice(x: torch.Tensor, spans: List[Tuple[int, int]], index: int,
               group) -> torch.Tensor:
    """x[..., spans[index]]; `spans` holds every rank's [start, stop)."""
    return _Slice.apply(x, spans, index, group)


# ---- the sharded products -------------------------------------------------

def column_product(policy, x: torch.Tensor, w: torch.Tensor,
                   shard: Shard) -> torch.Tensor:
    """x @ W for W sharded by columns: this rank's columns from the
    whole input, rounded to the compute dtype, then every rank's joined
    (the whole output on every rank)."""
    y = policy.mm(copy_in(policy.cast_compute(x), shard.group),
                  policy.cast_compute(w))
    return gather_last(y, shard.group)


def row_partial(policy, x: torch.Tensor, w: torch.Tensor, shard: Shard,
                offset: int = 0) -> torch.Tensor:
    """This rank's f32 part of x @ W for W sharded by rows, where x's
    feature j meets W's row offset + j: the features that fall in this
    rank's rows times those rows (zeros where none fall). The sum of
    every rank's part (`reduce_out`) is the product."""
    width = x.shape[-1]

    def span(i):
        a, b = shard.bounds(i)
        a = min(max(a - offset, 0), width)
        return a, max(a, min(b - offset, width))

    spans = [span(i) for i in range(shard.parts)]
    a, b = spans[shard.index]
    lo = a + offset - shard.bounds()[0]
    xs = take_slice(policy.cast_compute(x), spans, shard.index, shard.group)
    return torch.matmul(xs.float(),
                        policy.cast_compute(w)[lo:lo + b - a].float())


# ---- sharding a model ------------------------------------------------------

def shard_parameters(model: nn.Module, mesh) -> Dict[str, Shard]:
    """Cut every parameter of `model` that a rule of
    `parallel.mesh.param_shardings` shards to this rank's block, in
    place, and mark its module (`module.shard`). Nothing is cut on a
    model axis of 1. A rule-matched parameter of a module that cannot
    run it sharded (no `shardable` entry for that name and dim) raises.
    Returns the shards by parameter name."""
    if mesh.model == 1:
        return {}
    if mesh.model_group is None:
        raise ValueError(f"mesh.model={mesh.model} needs a joined process "
                         "group")
    dims = param_shardings(((n, tuple(p.shape))
                            for n, p in model.named_parameters()),
                           mesh.model)
    out = {}
    with torch.no_grad():
        for name, dim in dims.items():
            if dim is None:
                continue
            owner, _, pname = name.rpartition(".")
            module = model.get_submodule(owner)
            if dim not in getattr(module, "shardable", {}).get(pname, ()):
                raise ValueError(f"{name}: {type(module).__name__} cannot "
                                 f"run its {pname} sharded along dim {dim}")
            p = getattr(module, pname)
            shard = Shard(pname, dim, p.shape[dim], mesh.m, mesh.model,
                          mesh.model_group)
            p.data = shard.take(p.data).clone()
            module.shard = out[name] = shard
    return out


def shards(model: nn.Module) -> Dict[str, Shard]:
    """The sharded parameters of `model` by name."""
    return {(f"{prefix}." if prefix else "") + m.shard.name: m.shard
            for prefix, m in model.named_modules()
            if getattr(m, "shard", None) is not None}


def full_tensor(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The full tensor of which `t` is the block `shard` (t itself when
    shard is None): a collective of the model group."""
    if shard is None:
        return t
    return gather(t.detach(), shard.group, shard.dim)


def full_state(sd: Mapping[str, torch.Tensor], by_name: Mapping[str, Shard]
               ) -> Dict[str, torch.Tensor]:
    """A state keyed by parameter name with every sharded entry joined
    to its full tensor, in `sd`'s order (a collective of the model
    group)."""
    return {k: full_tensor(v, by_name.get(k)) for k, v in sd.items()}


def local_state(sd: Mapping[str, torch.Tensor], by_name: Mapping[str, Shard]
                ) -> Dict[str, torch.Tensor]:
    """A full state cut to this rank's blocks."""
    return {k: (by_name[k].take(torch.as_tensor(v)) if k in by_name else v)
            for k, v in sd.items()}
