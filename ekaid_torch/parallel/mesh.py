"""The data x model mesh over `torch.distributed` (counterpart of
`ekaid_tpu/parallel/mesh.py`).

The reference lays its devices out as a ('data', 'model') grid: each
batch shards over 'data', and the widest parameter matrices shard over
'model' by `DEFAULT_PARAM_RULES`. Here the grid is the processes of a
`torch.distributed` group, one device each:

  * `init_from_env` joins the group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT): NCCL
    for CUDA devices, gloo for the CPU. The local device is
    cuda:LOCAL_RANK. Without WORLD_SIZE it joins nothing; a group joined
    before (any backend) is kept.
  * `make_mesh` places this process on the grid: rank r sits at
    (d, m) = divmod(r, model), the row-major order of the reference's
    `devices.reshape(data, model)`. It makes one data group per m (the
    ranks that hold the same shards and split the batch) and one model
    group per d (the ranks that split the shards of one batch).
  * `param_shardings` maps each parameter name to the dim its rule
    shards (1 for the reference's P(None, 'model'), 0 for
    P('model', None)) or None, falling back to None where the dim does
    not divide the model axis, as the reference does.
  * `wrap` puts a module in `DistributedDataParallel` over the data
    group, which averages the gradients over it in its backward.
  * `all_reduce_sum` sums a tensor over a group: the loss's global
    denominators (the answer tokens and the pairs of the whole batch)
    and the reported losses, over the data group.

The products over the model group are in `parallel/tensor.py`.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

#: seconds a rank waits in a group's collective before it raises
GROUP_TIMEOUT_S = 600

# (param-path regex, sharded dim) -- first match wins. Paths are the
# parameter names with '.' read as '/'; kernels are [in, out]. The
# reference's rules, its P(None, 'model') as dim 1, P('model', None) as 0.
DEFAULT_PARAM_RULES: Sequence[Tuple[str, int]] = (
    # vocabulary logits: shard the vocab (output) dim
    (r".*speaker/logit/kernel$", 1),
    # decoder fusion embed (3072 -> 1024): shard output
    (r".*speaker/embed/kernel$", 1),
    # GAT head mixers (H*D -> D): shard the wide input dim
    (r".*linear_out_2/kernel$", 0),
    # GAT self-loop projections ((D+Q) -> D): shard input
    (r".*self_weights/WNDense_0/v$", 0),
    # question GRU input projection (600 -> 3H): shard output
    (r".*question/GRU_0/w_ih$", 1),
    # LSTM input projections: shard input (concat features are wide)
    (r".*lstm/w_ih$", 0),
)


@dataclass(frozen=True)
class Mesh:
    """This process's place on the data x model grid. `data_group` and
    `model_group` are None without a joined group."""
    rank: int
    world: int
    device: torch.device
    data: int
    model: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def d(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.model

    @property
    def m(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """Whether a process group is joined (world 1 included)."""
        return dist.is_available() and dist.is_initialized()


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device="cuda") -> torch.device:
    """Join the process group `torchrun` describes in the environment
    and return this process's device: cuda:LOCAL_RANK for a CUDA
    `device`, the CPU for 'cpu'. Without WORLD_SIZE in the environment
    (a plain `python -m ...` run) nothing is joined and `device` comes
    back as given."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


def make_mesh(mesh_cfg, device) -> Mesh:
    """The grid of the joined group, checked against `mesh_cfg`: `model`
    must divide the world, and `data` is -1 or world / model. Every rank
    must call this at the same point: it makes the groups, all of them
    on every rank, in one order."""
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    model = mesh_cfg.model
    if model < 1 or world % model:
        raise ValueError(
            f"mesh.model={model} does not divide the {world} process(es) "
            f"of the group; start a multiple of {max(model, 1)} processes "
            f"with torchrun --nproc_per_node, or set mesh.model to a "
            f"divisor of {world}")
    data = world // model
    if mesh_cfg.data not in (-1, data):
        raise ValueError(
            f"mesh.data={mesh_cfg.data} but the data axis has {data} "
            f"process(es); set mesh.data to -1 or {data}, or start "
            f"{mesh_cfg.data * model} processes with torchrun "
            f"--nproc_per_node")
    data_group = model_group = None
    if joined and model > 1:
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               timeout=timeout)
            if m == rank % model:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)],
                               timeout=timeout)
            if d == rank // model:
                model_group = g
    elif joined:
        data_group = dist.group.WORLD
    return Mesh(rank, world, torch.device(device), data, model, data_group,
                model_group)


def param_shardings(params: Iterable[Tuple[str, Tuple[int, ...]]],
                    model: int) -> Dict[str, Optional[int]]:
    """Each (name, shape)'s sharded dim over a model axis of `model`, or
    None: no rule of DEFAULT_PARAM_RULES matches, or the first that
    matches names a dim that the shape lacks or that `model` does not
    divide (replicated, as the reference falls back)."""
    compiled = [(re.compile(pat), dim) for pat, dim in DEFAULT_PARAM_RULES]
    out = {}
    for name, shape in params:
        path, out[name] = name.replace(".", "/"), None
        for pat, dim in compiled:
            if pat.match(path):
                if dim < len(shape) and shape[dim] % model == 0:
                    out[name] = dim
                break
    return out


def wrap(module: nn.Module, mesh: Mesh) -> nn.Module:
    """`module` in DistributedDataParallel over the mesh's data group,
    on its device. Parameters a step leaves unused (the auxiliary head
    `fc1` has no loss) are found in each backward."""
    ids = [mesh.device] if mesh.device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(
        module, device_ids=ids, find_unused_parameters=True,
        process_group=mesh.data_group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new contiguous tensor: t summed over the ranks of `group`
    (default: the joined group)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
