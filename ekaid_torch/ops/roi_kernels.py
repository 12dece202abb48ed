"""Multilevel ROIAlign by hat matrices: the K2 and K3 kernels and their
plain versions.

Counterpart of `ekaid_tpu/ops/pallas_roi.py`. Its two Pallas kernels
pool every ROI of a batch as `a_y . patch . b_x^T` over a fixed 48x56
patch of the ROI's FPN level, where a_y and b_x are the bin-averaged
bilinear hat matrices (sampling ratio s, half-pixel offset, samples
outside [-1, H] weightless, the others clamped):

* `multilevel_roi_align_canvas` (K2, roi_backend 'canvas', the
  extraction default): the first product takes a_y rounded to the
  feature dtype, with f32 accumulation; the second is f32;
* `multilevel_roi_align_pallas` (K3, roi_backend 'pallas'): every
  operand in f32.

Both round the result once to the feature dtype. The ROI geometry
(`_roi_geometry`) is the reference's: the FPN level heuristic plus the
documented elongated-ROI bump to the first level whose 44-px cap fits
the long side, the patch row start, and the column start aligned down
to 8, which also fixes which columns the patch holds.

For a CUDA tensor each wrapper launches its instance of
`ekaid_torch/csrc/roi_align.cu` and counts the launch in its
`launches`; it never falls back. The kernels have no backward: with
grad mode on, an input that requires grad is refused (`refuse_grad`).
The kernel computes the geometry
itself from the raw boxes and a table of the levels (`level_table`),
so the wrapper runs no torch op but the output's `torch.empty`. It
takes level maps of f32 or bf16 whose channels are a multiple of 16
bytes, 16-byte aligned, and raises on others. For a CPU tensor it runs
its plain version (`..._plain`): the geometry and the hat matrices
built in torch, the patches gathered, two einsums, in chunks of 256
ROIs.

Level maps are NHWC: [B, H, W, C] with rois [B, R, 4] -> [B, R, out,
out, C], or [H, W, C] with rois [R, 4] -> [R, out, out, C].
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ekaid_torch.ops.roi_align import assign_levels, log2_f32, true_div

PATCH_Y = 48      # >= a ROI's span at its level, +1 bilinear, +1 floor
PATCH_X = 56      # + 7 px of slack for the 8-aligned column start
LEVEL_CAP = 44.0  # the longest side a ROI may span at its level (px)
PLAIN_CHUNK = 256
MAX_LEVELS = 8     # csrc/roi_align.cu::kMaxLevels
MAX_OUT = 16       # ::kMaxOut
MAX_SAMPLING = 4   # ::kMaxS


def _roi_geometry(flat_rois: torch.Tensor, scales: Sequence[float],
                  heights: Sequence[int], out_size: int, s: int,
                  min_level: int, num_levels: int):
    """Per-ROI level (with the elongated-ROI bump) and patch geometry.
    Returns (lvl_idx int64 [R], fmeta f32 [R, 8]: y/x origin relative to
    the patch, bin h/w, y/x hi relative to the patch, patch row/col
    start). Every division is a true one and log2 is rounded once
    (`roi_align.true_div`, `log2_f32`), so the CPU, the card and the
    kernel give the same bits."""
    levels = assign_levels(flat_rois, min_level=min_level,
                           max_level=min_level + num_levels - 1)
    lvl_idx = levels.long() - min_level
    long_side = torch.clamp(torch.maximum(
        flat_rois[:, 2] - flat_rois[:, 0], flat_rois[:, 3] - flat_rois[:, 1]),
        min=0.0)
    l_needed = torch.ceil(log2_f32(torch.clamp(
        true_div(long_side * float(scales[0]), LEVEL_CAP), min=1e-6))).long()
    lvl_idx = torch.clamp(torch.maximum(lvl_idx, l_needed), 0,
                          num_levels - 1)

    dev = flat_rois.device
    h_arr = torch.tensor(heights, dtype=torch.float32, device=dev)[lvl_idx]
    py_arr = torch.clamp(h_arr, max=float(PATCH_Y))
    px_arr = torch.clamp(h_arr, max=float(PATCH_X))
    scale_arr = torch.tensor(scales, dtype=torch.float32,
                             device=dev)[lvl_idx]
    x1 = flat_rois[:, 0] * scale_arr - 0.5
    y1 = flat_rois[:, 1] * scale_arr - 0.5
    bin_w = true_div((flat_rois[:, 2] - flat_rois[:, 0]) * scale_arr,
                     out_size)
    bin_h = true_div((flat_rois[:, 3] - flat_rois[:, 1]) * scale_arr,
                     out_size)
    first_y = y1 + bin_h * (0.5 / s)
    first_x = x1 + bin_w * (0.5 / s)
    ys = torch.minimum(torch.clamp(torch.floor(first_y), min=0.0),
                       h_arr - py_arr)
    xs = torch.floor(torch.minimum(torch.clamp(torch.floor(first_x),
                                               min=0.0),
                                   h_arr - px_arr) / 8.0) * 8.0  # exact
    fmeta = torch.stack([y1 - ys, x1 - xs, bin_h, bin_w,
                         (h_arr - 1.0) - ys, (h_arr - 1.0) - xs, ys, xs],
                        dim=1).float()
    return lvl_idx, fmeta


def _hats(fmeta: torch.Tensor, out_size: int, s: int):
    """The bin-averaged hat matrices: a_y [R, out, PATCH_Y], b_x
    [R, out, PATCH_X], f32. The kernel builds the same taps with the
    same operations."""
    dev = fmeta.device
    i = torch.arange(out_size * s, device=dev)
    grid = (i // s).float() + true_div((i % s).float() + 0.5, s)  # [os]

    def hat(origin, binsz, hi, start, patch):
        raw = origin[:, None] + binsz[:, None] * grid[None]    # [R, os]
        absc = raw + start[:, None]
        full = hi + start + 1.0
        ins = ((absc >= -1.0) & (absc <= full[:, None])).float()
        cl = torch.minimum(torch.clamp(raw, min=0.0), hi[:, None])
        p = torch.arange(patch, dtype=torch.float32, device=dev)
        w = torch.clamp(1.0 - torch.abs(cl[..., None] - p), min=0.0)
        w = w * ins[..., None]                                  # [R, os, P]
        return (w * (1.0 / s)).reshape(-1, out_size, s, patch).sum(2)

    f = fmeta.unbind(1)
    return (hat(f[0], f[2], f[4], f[6], PATCH_Y),
            hat(f[1], f[3], f[5], f[7], PATCH_X))


def _batched(fmaps, rois):
    """Level maps [B, H, W, C] and rois [B, R, 4], and whether the call
    was batched."""
    if rois.dim() == 3:
        return list(fmaps), rois, True
    return [f[None] for f in fmaps], rois[None], False


def _check_levels(fmaps):
    """The reference's refusals of a pyramid; returns the heights."""
    heights = tuple(int(f.shape[1]) for f in fmaps)
    for f in fmaps:
        if f.shape[1] != f.shape[2]:
            raise ValueError("level maps must be square")
        if f.dtype != fmaps[0].dtype or f.shape[-1] != fmaps[0].shape[-1]:
            raise ValueError("level maps must share dtype and channels")
    for h in heights:
        # the column start is aligned down to 8: the right-edge samples
        # stay inside the patch only when W - PATCH_X is a multiple of 8
        if (h - min(PATCH_X, h)) % 8:
            raise ValueError(f"level width {h}: W - {PATCH_X} must be a "
                             "multiple of 8; use multilevel_roi_align")
    if heights[-1] > min(PATCH_Y, PATCH_X):
        raise ValueError(f"top-level map {heights[-1]} exceeds the "
                         f"{PATCH_Y}x{PATCH_X} patch; use "
                         "multilevel_roi_align")
    return heights


def _prepare(fmaps, rois, scales, out_size, s, min_level):
    """Checks; batched views; flat ROIs with image index, level and
    geometry (the plain versions' inputs)."""
    fmaps, rois, batched = _batched(fmaps, rois)
    heights = _check_levels(fmaps)
    b, r_per = rois.shape[0], rois.shape[1]
    flat = rois.reshape(-1, 4).float()
    img = torch.arange(b, device=rois.device).repeat_interleave(r_per)
    lvl_idx, fmeta = _roi_geometry(flat, scales, heights, out_size, s,
                                   min_level, len(fmaps))
    return fmaps, batched, b, r_per, heights, img, lvl_idx, fmeta


def _finish(out, batched, b, r_per, out_size):
    out = out.reshape(b, r_per, out_size, out_size, out.shape[-1])
    return out if batched else out[0]


def _pool_plain(fmaps, rois, scales, out_size, sampling_ratio, min_level,
                round_a: bool):
    fmaps, batched, b, r_per, heights, img, lvl_idx, fmeta = _prepare(
        fmaps, rois, scales, out_size, sampling_ratio, min_level)
    dt, C, dev = fmaps[0].dtype, fmaps[0].shape[-1], rois.device
    table = torch.cat([f.reshape(b, -1, C) for f in fmaps], 1)
    sizes = torch.tensor([h * h for h in heights], device=dev)
    offsets = torch.cumsum(sizes, 0) - sizes
    h_lvl = torch.tensor(heights, device=dev)
    py = torch.arange(PATCH_Y, device=dev)
    px = torch.arange(PATCH_X, device=dev)
    outs = []
    for sl in torch.arange(img.shape[0], device=dev).split(PLAIN_CHUNK):
        fm = fmeta[sl]
        a_y, b_x = _hats(fm, out_size, sampling_ratio)
        if round_a:
            a_y = a_y.to(dt).float()
        h = h_lvl[lvl_idx[sl]][:, None, None]
        rows = fm[:, 6].long()[:, None, None] + py[None, :, None]
        cols = fm[:, 7].long()[:, None, None] + px[None, None, :]
        inside = (rows < h) & (cols < h)                  # [n, Py, Px]
        idx = (offsets[lvl_idx[sl]][:, None, None]
               + torch.minimum(rows, h - 1) * h + torch.minimum(cols, h - 1))
        patch = table[img[sl][:, None, None], idx].float()
        patch = torch.where(inside[..., None], patch, torch.zeros((), device=dev))
        t = torch.einsum("noy,nyxc->noxc", a_y, patch)
        outs.append(torch.einsum("npx,noxc->nopc", b_x, t).to(dt))
    return _finish(torch.cat(outs), batched, b, r_per, out_size)


def multilevel_roi_align_canvas_plain(fmaps, rois, scales, out_size=7,
                                      sampling_ratio=2, min_level=2):
    """K2's function in plain torch."""
    return _pool_plain(fmaps, rois, scales, out_size, sampling_ratio,
                       min_level, round_a=True)


def multilevel_roi_align_pallas_plain(fmaps, rois, scales, out_size=7,
                                      sampling_ratio=2, min_level=2):
    """K3's function in plain torch."""
    return _pool_plain(fmaps, rois, scales, out_size, sampling_ratio,
                       min_level, round_a=False)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LevelTable(ctypes.Structure):
    """csrc/roi_align.cu::Levels: the level maps' pointers, heights and
    scales, their count and the first level."""
    _fields_ = [("ptr", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("num", ctypes.c_int),
                ("min_level", ctypes.c_int)]


def level_table(fmaps, scales, min_level: int) -> LevelTable:
    """The kernel's level table for level maps [B, H, W, C]."""
    if not 1 <= len(fmaps) <= MAX_LEVELS or len(scales) < len(fmaps):
        raise ValueError(f"roi_align kernel: 1 to {MAX_LEVELS} levels, "
                         "each with its scale")
    t = LevelTable()
    for i, f in enumerate(fmaps):
        t.ptr[i] = f.data_ptr()
        t.h[i] = int(f.shape[1])
        t.scale[i] = float(scales[i])
    t.num = len(fmaps)
    t.min_level = min_level
    return t


class KernelArgs(NamedTuple):
    fmaps: list          # [B, H, W, C] each; the table points into them
    batched: bool
    b: int
    r_per: int
    table: LevelTable
    rois: torch.Tensor   # f32 [B * R, 4], contiguous


def _kernel_args(fmaps, rois, scales, out_size, sampling_ratio,
                 min_level) -> KernelArgs:
    """The reference's checks, the kernel's own refusals (feature type,
    16-byte channel vectors and alignment, sizes) and its arguments.
    Runs no device op for f32 contiguous boxes."""
    fmaps, rois, batched = _batched(fmaps, rois)
    _check_levels(fmaps)
    dev, dt = rois.device, fmaps[0].dtype
    if dt not in _DTYPES:
        raise ValueError(f"roi_align kernel: no {dt} instance")
    vec = 16 // fmaps[0].element_size()
    if fmaps[0].shape[-1] % vec:
        raise ValueError(f"roi_align kernel: {dt} channels must be a "
                         f"multiple of {vec} (16-byte vectors)")
    for f in fmaps:
        if f.device != dev or not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("roi_align kernel: level maps must be "
                             f"contiguous NHWC on {dev}, 16-byte aligned")
    if not (1 <= out_size <= MAX_OUT and 1 <= sampling_ratio <= MAX_SAMPLING):
        raise ValueError(f"roi_align kernel: out_size 1..{MAX_OUT}, "
                         f"sampling_ratio 1..{MAX_SAMPLING}")
    if fmaps[0].shape[0] != rois.shape[0]:
        raise ValueError("roi_align kernel: one image of level maps per "
                         "image of rois")
    flat = rois.reshape(-1, 4).float().contiguous()
    if flat.data_ptr() % 16:
        flat = flat.clone()
    return KernelArgs(fmaps, batched, rois.shape[0], rois.shape[1],
                      level_table(fmaps, scales, min_level), flat)


def _kernel_launch(args: KernelArgs, out, sampling_ratio, round_a: bool,
                   geo=None) -> None:
    """The launch alone, into `out` [B * R, out, out, C]; `geo` (f32
    [B * R, 10], or None) receives each ROI's image, level and patch
    geometry as the kernel computed them."""
    from ekaid_torch import kernels
    n = args.rois.shape[0]
    if n == 0:
        return
    lib = kernels.load("roi_align")
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekaid_roi_align(
            _DTYPES[out.dtype], int(round_a), ctypes.byref(args.table),
            args.rois.data_ptr(), n, args.r_per, out.data_ptr(),
            out.shape[-1], out.shape[1], sampling_ratio,
            None if geo is None else geo.data_ptr(), stream)
    kernels.check(lib, err, "roi_align kernel launch")


def resident_warps_per_sm(dtype, round_a: bool, sampling_ratio=2) -> int:
    """The kernel instance's resident warps per SM on the current card
    (from its registers and shared memory)."""
    from ekaid_torch import kernels
    lib = kernels.load("roi_align")
    fn = lib.ekaid_roi_align_warps_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    kernels.check(lib, fn(_DTYPES[dtype], int(round_a), sampling_ratio,
                          ctypes.byref(warps)), "roi_align occupancy")
    return warps.value


def kernel_geometry(fmaps, rois, scales, out_size=7, sampling_ratio=2,
                    min_level=2, round_a=True):
    """(image, level, fmeta f32 [B * R, 8]) as the kernel computes them,
    from one launch (for holding them against `_roi_geometry`)."""
    args = _kernel_args(fmaps, rois, scales, out_size, sampling_ratio,
                        min_level)
    n = args.rois.shape[0]
    out = torch.empty(n, out_size, out_size, args.fmaps[0].shape[-1],
                      dtype=args.fmaps[0].dtype, device=rois.device)
    geo = torch.full((n, 10), float("nan"), device=rois.device)
    _kernel_launch(args, out, sampling_ratio, round_a, geo)
    return geo[:, 0].long(), geo[:, 1].long(), geo[:, 2:]


def _launch(fmaps, rois, scales, out_size, sampling_ratio, min_level,
            round_a: bool):
    args = _kernel_args(fmaps, rois, scales, out_size, sampling_ratio,
                        min_level)
    out = torch.empty(args.rois.shape[0], out_size, out_size,
                      args.fmaps[0].shape[-1], dtype=args.fmaps[0].dtype,
                      device=rois.device)
    _kernel_launch(args, out, sampling_ratio, round_a)
    return _finish(out, args.batched, args.b, args.r_per, out_size)


class NoGradKernelError(RuntimeError):
    """A K2/K3 launch was asked for an input that requires grad."""


def refuse_grad(fmaps: Sequence[torch.Tensor], rois: torch.Tensor) -> None:
    """Raise NoGradKernelError when grad mode is on and a level map or
    the ROIs require grad. The kernels have no backward, as the
    reference's Pallas paths have none (inference only): their output
    would carry no gradient, so training pools through the gather form
    (`roi_align.multilevel_roi_align`) instead."""
    if torch.is_grad_enabled() and (
            rois.requires_grad or any(f.requires_grad for f in fmaps)):
        raise NoGradKernelError(
            "roi_align kernels are inference only (no backward): call them "
            "under torch.no_grad() or on inputs that need no gradient, or "
            "pool through ops/roi_align.py::multilevel_roi_align to train")


def _dispatch(wrapper, fmaps, rois, scales, out_size, sampling_ratio,
              min_level, round_a):
    if rois.device.type == "cpu":
        plain = (multilevel_roi_align_canvas_plain if round_a
                 else multilevel_roi_align_pallas_plain)
        return plain(fmaps, rois, scales, out_size, sampling_ratio,
                     min_level)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: no kernel for {rois.device}")
    refuse_grad(fmaps, rois)
    out = _launch(fmaps, rois, scales, out_size, sampling_ratio, min_level,
                  round_a)
    wrapper.launches += 1
    return out


def multilevel_roi_align_canvas(fmaps: Sequence[torch.Tensor],
                                rois: torch.Tensor, scales: Sequence[float],
                                out_size: int = 7, sampling_ratio: int = 2,
                                min_level: int = 2) -> torch.Tensor:
    """K2: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _dispatch(multilevel_roi_align_canvas, fmaps, rois, scales,
                     out_size, sampling_ratio, min_level, round_a=True)


def multilevel_roi_align_pallas(fmaps: Sequence[torch.Tensor],
                                rois: torch.Tensor, scales: Sequence[float],
                                out_size: int = 7, sampling_ratio: int = 2,
                                min_level: int = 2) -> torch.Tensor:
    """K3: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _dispatch(multilevel_roi_align_pallas, fmaps, rois, scales,
                     out_size, sampling_ratio, min_level, round_a=False)


multilevel_roi_align_canvas.launches = 0
multilevel_roi_align_pallas.launches = 0
