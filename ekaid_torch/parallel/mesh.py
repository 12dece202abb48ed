"""The data axis over `torch.distributed` (counterpart of
`ekaid_tpu/parallel/mesh.py`).

The reference lays its devices out as a ('data', 'model') grid. The
port keeps the data axis only: every process of a `torch.distributed`
group holds the whole model on its own device and takes its part of
each batch. The model (54.8 M parameters at flagship widths) fits one
card many times over, so `mesh.model` must be 1.

  * `init_from_env` joins the group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT): NCCL
    for CUDA devices, gloo for the CPU. The local device is
    cuda:LOCAL_RANK. Without WORLD_SIZE it joins nothing; a group joined
    before (any backend) is kept.
  * `make_mesh` places this process on the data axis, which is the
    whole joined group: rank r at index r.
  * `wrap` puts a module in `DistributedDataParallel` over the group,
    which averages the gradients over it in its backward.
  * `all_reduce_sum` sums a tensor over the group: the loss's global
    denominators (the answer tokens and the pairs of the whole batch)
    and the reported losses. `gather` joins the ranks' blocks of a
    data-sharded decode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis: index `rank` of `data`
    processes, on `device`."""
    rank: int
    data: int
    device: torch.device

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
    """The data axis of the joined group (one process without one),
    checked against `mesh_cfg`: `model` must be 1, and `data` -1 or the
    group's size."""
    if mesh_cfg.model != 1:
        raise ValueError(
            f"mesh.model={mesh_cfg.model}: the port has no model axis "
            "(every process holds the whole model); set mesh.model to 1 "
            "and split the batch over processes with mesh.data")
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    data = dist.get_world_size() if joined else 1
    if mesh_cfg.data not in (-1, data):
        raise ValueError(
            f"mesh.data={mesh_cfg.data} but the data axis has {data} "
            f"process(es); set mesh.data to -1 or {data}, or start "
            f"{mesh_cfg.data} processes with torchrun --nproc_per_node")
    return Mesh(rank, data, torch.device(device))


def wrap(module: nn.Module, mesh: Mesh) -> nn.Module:
    """`module` in DistributedDataParallel over the joined group, on the
    mesh's device. Parameters a step leaves unused (the auxiliary head
    `fc1` has no loss) are found in each backward."""
    ids = [mesh.device] if mesh.device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(
        module, device_ids=ids, find_unused_parameters=True)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor: t summed over the joined group."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's x (all of one shape) joined along `dim`, in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)
