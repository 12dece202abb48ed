"""Data parallelism over `torch.distributed` (counterpart of
`ekaid_tpu/parallel/mesh.py`).

The reference shards each batch over the 'data' axis of a device mesh,
and XLA sums the gradients across it. Here that axis is the processes
of a `torch.distributed` group, one device each:

  * `init_from_env` joins the group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT): NCCL
    for CUDA devices, gloo for the CPU. The local device is
    cuda:LOCAL_RANK. Without WORLD_SIZE it joins nothing.
  * `DataAxis` is this process's rank, the world size and its device,
    read from the group (world 1 without one); `data_axis` checks the
    config's mesh against it.
  * `wrap` puts a module in `DistributedDataParallel`, which averages
    the gradients over the ranks in its backward.
  * `all_reduce_sum` sums a tensor over the ranks: the loss's global
    denominators (the answer tokens and the pairs of the whole batch)
    and the reported losses.

The reference's 'model' axis shards the widest matrices; at its
default of 1 it changes nothing, and it only changes where a product
runs, never its result. It is not ported: `mesh.model` other than 1
raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class DataAxis:
    """This process's place on the data axis."""
    rank: int
    world: int
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


def data_axis(mesh_cfg, device) -> DataAxis:
    """The data axis of this process, checked against `mesh_cfg`:
    `data` of -1 or the world size is the group; `model` must be 1."""
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    if mesh_cfg.model != 1:
        raise NotImplementedError(
            f"mesh.model={mesh_cfg.model}: the 'model' axis (tensor "
            "parallelism) is not ported; the port shards only the data "
            "axis (mesh.model 1)")
    if mesh_cfg.data not in (-1, world):
        raise ValueError(
            f"mesh.data={mesh_cfg.data} but the data axis has {world} "
            f"process(es); set mesh.data to -1 or {world}, or start "
            f"{mesh_cfg.data} processes with torchrun --nproc_per_node")
    return DataAxis(rank, world, torch.device(device))


def wrap(module: nn.Module, axis: DataAxis) -> nn.Module:
    """`module` in DistributedDataParallel on the axis's device.
    Parameters a step leaves unused (the auxiliary head `fc1` has no
    loss) are found in each backward."""
    ids = [axis.device] if axis.device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(
        module, device_ids=ids, find_unused_parameters=True)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: t summed over the ranks of the joined group."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out
