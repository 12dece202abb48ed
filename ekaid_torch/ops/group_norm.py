"""GroupNorm over channels-last maps with its ReLU and residual add fused:
the K5 kernel, its plain version and the rule that picks between them.

The ResNet trunks (`models/detector/backbone.py`: the mode0 R101, the
detectors' R50-FPN) normalise every convolution's output with
GroupNorm(32): statistics and the affine in f32, eps 1e-6, the result
rounded once to the compute dtype, then a ReLU, or (a bottleneck's last
norm) the residual added in the compute dtype and a ReLU.

* `group_norm_plain`: that chain in torch, as the trunk has always run
  it; every CPU, f32 or gradient-carrying call takes it.
* `group_norm_kernel`: for a bf16 channels-last CUDA map, one launch of
  `ekaid_torch/csrc/group_norm.cu::ekaid_group_norm` on the current
  stream, writing a fresh channels-last bf16 map (so the next
  convolution's layout copy is a no-op). It computes the same function;
  only the order in which the statistics are summed differs.
  `group_norm_kernel.launches` counts the launches that run at once: a
  launch recorded into a CUDA graph runs at each replay, which no
  Python sees, and is not counted. It never falls back: it raises for
  what the kernel does not take.
* `kernel_applies`: the rule. The kernel runs where the map is a bf16
  channels-last CUDA tensor, no gradient is required (grad mode off, or
  nothing involved requires grad) and its shape is one the kernel takes
  (`supported`); everything else runs `group_norm_plain`.

`plan` chooses how a call is cut into blocks from what it observes
(images N, positions P = H * W, channels C and the card's SMs): each
image's channels into `blocks` channel blocks of whole groups, its
positions into `split` chunks handled by one cluster, until the card
holds a block on every SM, and whether each block's chunk fits in
shared memory (`cached`: one read from device memory) or is streamed
twice.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

MAX_GROUPS = 32          # csrc/group_norm.cu::kMaxGroups
MAX_SPLIT = 8            # blocks of a cluster (the portable size)
THREADS = 256            # most threads a block (kThreads)
CACHE_BYTES = 96 * 1024  # shared memory a cached block may take (2 an SM)
MAX_SMEM = 128 * 1024    # the kernel's limit (kMaxSmem)
BLOCKS_PER_SM = 1        # the blocks a call aims to put on each SM
MIN_BLOCK_BYTES = 4096   # no cut leaves a block less than this to read
MIN_ROW_BYTES = 32       # a block's channels at one position: a sector
WIDE_ROW_BYTES = 64      # channel blocks this wide are cut first
MOMENTS_BYTES = 12       # one partial (n, mean, M2) in shared memory
MAX_COUNT = 1 << 24      # elements of a group an f32 count holds exactly

_EPILOGUES = {(False, False): 0, (True, False): 1, (True, True): 2}


@dataclass(frozen=True)
class Plan:
    blocks: int      # channel blocks an image (whole groups)
    split: int       # position chunks an image: the cluster's blocks
    threads: int     # threads a block
    cached: bool     # each chunk held in shared memory


def _threads(vpr: int) -> int:
    """Threads of a block whose rows are `vpr` 16-byte vectors: a
    multiple of the warp and of the row, at most THREADS (0: none)."""
    base = vpr * 32 // math.gcd(vpr, 32)
    return 0 if base > THREADS else base * (THREADS // base)


def _smem(p: int, c: int, blocks: int, split: int, threads: int,
          gpv: int, cached: bool) -> int:
    tile = -(-p // split) * (c // blocks) * 2 if cached else 0
    return tile + threads * gpv * MOMENTS_BYTES


def _min_blocks(c: int, groups: int) -> int:
    """The fewest channel blocks whose row a block's threads can take (0:
    none)."""
    blocks = 1
    while not _threads(c // blocks // 8):
        blocks *= 2
        if groups % blocks or (c // blocks) % 8:
            return 0
    return blocks


@functools.lru_cache(maxsize=1024)
def plan(n: int, p: int, c: int, groups: int, sms: int) -> Plan:
    """How a call over n images of p positions and c channels is cut on
    a card of `sms` SMs (see the module's doc). Raises ValueError for a
    shape the kernel does not take."""
    if not supported(c, groups, p):
        raise ValueError(f"group_norm kernel: no plan for C={c}, "
                         f"groups={groups}, P={p}")
    cpg = c // groups
    gpv = 8 // cpg if cpg < 8 else 1

    def can_cut(b: int) -> bool:
        return groups % b == 0 and (c // b) % 8 == 0 and \
            (c // b) * 2 >= MIN_ROW_BYTES and _threads(c // b // 8) > 0

    def tile(b: int, s: int) -> int:
        return -(-p // s) * (c // b) * 2

    def room(b: int, s: int) -> bool:
        return n * b * s < BLOCKS_PER_SM * sms

    blocks, split = _min_blocks(c, groups), 1
    while room(blocks, split) and can_cut(2 * blocks) and \
            (c // (2 * blocks)) * 2 >= WIDE_ROW_BYTES and \
            tile(2 * blocks, split) >= MIN_BLOCK_BYTES:
        blocks *= 2
    while room(blocks, split) and split < MAX_SPLIT and \
            tile(blocks, 2 * split) >= MIN_BLOCK_BYTES:
        split *= 2
    while room(blocks, split) and can_cut(2 * blocks) and \
            tile(2 * blocks, split) >= MIN_BLOCK_BYTES:
        blocks *= 2

    def cached_smem(b: int, s: int) -> int:
        return _smem(p, c, b, s, _threads(c // b // 8), gpv, True)

    # cut further where that makes each chunk fit in shared memory
    b, s = blocks, split
    while cached_smem(b, s) > CACHE_BYTES and s < MAX_SPLIT:
        s *= 2
    while cached_smem(b, s) > CACHE_BYTES and can_cut(2 * b):
        b *= 2
    cached = cached_smem(b, s) <= CACHE_BYTES
    if cached:
        blocks, split = b, s
    return Plan(blocks, split, _threads(c // blocks // 8), cached)


@functools.lru_cache(maxsize=1024)
def supported(c: int, groups: int, p: int) -> bool:
    """Whether the kernel takes C channels in `groups` groups over P
    positions: 16-byte channel vectors, a group a divisor or a multiple
    of a vector, at most MAX_GROUPS groups, a row of a block within its
    threads, and every group's count exact in f32."""
    if not (0 < groups <= MAX_GROUPS and c % groups == 0 and c % 8 == 0):
        return False
    cpg = c // groups
    if (8 % cpg if cpg < 8 else cpg % 8) or p * cpg >= MAX_COUNT:
        return False
    return _min_blocks(c, groups) > 0


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def epilogue(y: torch.Tensor, relu: bool = False,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The trunk's epilogue in the compute dtype: the residual added,
    then the ReLU (each where asked)."""
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     dtype: torch.dtype, relu: bool = False,
                     residual: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """GroupNorm of x [N, C, H, W] in f32, rounded once to `dtype`, then
    `epilogue`."""
    y = F.group_norm(x.float(), groups, scale.float(), bias.float(),
                     eps=eps)
    return epilogue(y.to(dtype), relu, residual)


def _is_map(t: torch.Tensor) -> bool:
    """A dense channels-last [N, C, H, W] map (by its strides: cheaper on
    the host than `is_contiguous(memory_format=...)`)."""
    if t.dim() != 4:
        return False
    _, c, h, w = t.shape
    return t.stride() == (h * w * c, 1, w * c, c)


def kernel_applies(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, residual: Optional[torch.Tensor] = None
                   ) -> bool:
    """The rule of the module's doc: whether `group_norm_kernel` runs
    this call."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and _is_map(x)):
        return False
    if residual is not None and (residual.dtype != x.dtype
                                 or residual.shape != x.shape):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, bias, residual)):
        return False
    return supported(x.shape[1], groups, x.shape[2] * x.shape[3])


def _check(x, scale, bias, groups, relu, residual) -> None:
    """The kernel's refusals, in an order the CPU can reach: the device
    last."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"group_norm kernel: x is {x.dtype}, want bf16")
    if not _is_map(x) or x.data_ptr() % 16:
        raise ValueError("group_norm kernel: x must be a channels-last "
                         "[N, C, H, W] map on a 16-byte boundary")
    n, c, h, w = x.shape
    if not supported(c, groups, h * w):
        raise ValueError(f"group_norm kernel: C={c} in {groups} groups "
                         f"over {h}x{w} is not a shape it takes")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or not t.is_contiguous() or \
                t.dtype != scale.dtype or \
                t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"group_norm kernel: {name} must be a "
                             f"contiguous f32 or bf16 [{c}] like scale")
    if residual is not None:
        if not relu:
            raise ValueError("group_norm kernel: a residual add comes "
                             "with the ReLU")
        if residual.dtype != x.dtype or residual.shape != x.shape or \
                not _is_map(residual) or residual.data_ptr() % 16:
            raise ValueError("group_norm kernel: the residual must be a "
                             "channels-last bf16 map shaped like x")
    for t in (scale, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError("group_norm kernel: operands on "
                             f"{t.device} and {x.device}")
    if not x.is_cuda:
        raise ValueError(f"group_norm kernel: x is on {x.device}; the "
                         "kernel runs on a CUDA device")


def group_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float,
                      relu: bool = False,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """`group_norm_plain` at bf16 by the K5 kernel: x a channels-last bf16
    CUDA map [N, C, H, W], scale and bias f32 or bf16 [C], residual (with
    `relu`) a map like x. Returns a new channels-last bf16 map."""
    from ekaid_torch import kernels
    _check(x, scale, bias, groups, relu, residual)
    n, c, h, w = x.shape
    dev = x.device
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pl = plan(n, h * w, c, groups, _sms(dev.index))
    lib = kernels.load("group_norm")

    def launch():
        return lib.ekaid_group_norm(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            int(scale.dtype == torch.bfloat16),
            _EPILOGUES[(bool(relu), residual is not None)], n, h * w, c,
            groups, pl.blocks, pl.split, pl.threads, int(pl.cached), eps,
            torch.cuda.current_stream(dev).cuda_stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    kernels.check(lib, err, "group_norm kernel launch")
    if not torch.cuda.is_current_stream_capturing():
        group_norm_kernel.launches += 1
    return y


group_norm_kernel.launches = 0


def norm_bytes(n: int, p: int, c: int, residual: bool) -> int:
    """The least bytes one call moves: the bf16 map read once and
    written once, and the residual read once."""
    return n * p * c * 2 * (3 if residual else 2)
