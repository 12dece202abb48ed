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
`launches`; it never falls back. For a CPU tensor it runs its plain
version (`..._plain`): the hat matrices built in torch, the patches
gathered, two einsums, in chunks of 256 ROIs.

Level maps are NHWC: [B, H, W, C] with rois [B, R, 4] -> [B, R, out,
out, C], or [H, W, C] with rois [R, 4] -> [R, out, out, C].
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ekaid_torch.ops.roi_align import assign_levels

PATCH_Y = 48      # >= a ROI's span at its level, +1 bilinear, +1 floor
PATCH_X = 56      # + 7 px of slack for the 8-aligned column start
LEVEL_CAP = 44.0  # the longest side a ROI may span at its level (px)
PLAIN_CHUNK = 256


def _roi_geometry(flat_rois: torch.Tensor, scales: Sequence[float],
                  heights: Sequence[int], out_size: int, s: int,
                  min_level: int, num_levels: int):
    """Per-ROI level (with the elongated-ROI bump) and patch geometry.
    Returns (lvl_idx int64 [R], fmeta f32 [R, 8]: y/x origin relative to
    the patch, bin h/w, y/x hi relative to the patch, patch row/col
    start)."""
    dev = flat_rois.device
    levels = assign_levels(flat_rois, min_level=min_level,
                           max_level=min_level + num_levels - 1)
    lvl_idx = levels.long() - min_level
    long_side = torch.clamp(torch.maximum(
        flat_rois[:, 2] - flat_rois[:, 0], flat_rois[:, 3] - flat_rois[:, 1]),
        min=0.0)
    l_needed = torch.ceil(torch.log2(torch.clamp(
        long_side * float(scales[0]) / LEVEL_CAP, min=1e-6))).long()
    lvl_idx = torch.clamp(torch.maximum(lvl_idx, l_needed), 0,
                          num_levels - 1)

    h_arr = torch.tensor(heights, dtype=torch.float32, device=dev)[lvl_idx]
    py_arr = torch.clamp(h_arr, max=float(PATCH_Y))
    px_arr = torch.clamp(h_arr, max=float(PATCH_X))
    scale_arr = torch.tensor(scales, dtype=torch.float32,
                             device=dev)[lvl_idx]
    x1 = flat_rois[:, 0] * scale_arr - 0.5
    y1 = flat_rois[:, 1] * scale_arr - 0.5
    bin_w = (flat_rois[:, 2] - flat_rois[:, 0]) * scale_arr / out_size
    bin_h = (flat_rois[:, 3] - flat_rois[:, 1]) * scale_arr / out_size
    first_y = y1 + bin_h * (0.5 / s)
    first_x = x1 + bin_w * (0.5 / s)
    ys = torch.minimum(torch.clamp(torch.floor(first_y), min=0.0),
                       h_arr - py_arr)
    xs = torch.floor(torch.minimum(torch.clamp(torch.floor(first_x),
                                               min=0.0),
                                   h_arr - px_arr) / 8.0) * 8.0
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
    grid = (i // s).float() + ((i % s).float() + 0.5) / s    # [os]

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


def _prepare(fmaps, rois, scales, out_size, s, min_level):
    """Checks; batched views; flat ROIs with image index, level and
    geometry."""
    batched = rois.dim() == 3
    if not batched:
        fmaps = [f[None] for f in fmaps]
        rois = rois[None]
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


def _kernel_inputs(fmaps, rois, scales, out_size, sampling_ratio,
                   min_level):
    """`_prepare` plus the kernel's device inputs: (fmaps, batched, b,
    r_per, heights, meta int32 [R, 2] (image, level), fmeta f32 [R, 8])."""
    fmaps, batched, b, r_per, heights, img, lvl_idx, fmeta = _prepare(
        fmaps, rois, scales, out_size, sampling_ratio, min_level)
    dev, dt = rois.device, fmaps[0].dtype
    if dt not in _DTYPES:
        raise ValueError(f"roi_align kernel: no {dt} instance")
    for f in fmaps:
        if f.device != dev or not f.is_contiguous():
            raise ValueError("roi_align kernel: level maps must be "
                             f"contiguous NHWC on {dev}")
    meta = torch.stack([img, lvl_idx], 1).to(torch.int32).contiguous()
    return fmaps, batched, b, r_per, heights, meta, fmeta.contiguous()


def _kernel_launch(fmaps, heights, meta, fmeta, out, sampling_ratio,
                   round_a: bool) -> None:
    """The launch alone, into `out` [R, out, out, C], on the inputs of
    `_kernel_inputs`."""
    from ekaid_torch import kernels
    dev = out.device
    lib = kernels.load("roi_align")
    ptrs = (ctypes.c_void_p * len(fmaps))(*[f.data_ptr() for f in fmaps])
    hs = (ctypes.c_int * len(fmaps))(*heights)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekaid_roi_align(
            _DTYPES[out.dtype], int(round_a),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(hs, ctypes.c_void_p), len(fmaps), meta.data_ptr(),
            fmeta.data_ptr(), out.data_ptr(), meta.shape[0], out.shape[-1],
            out.shape[1], sampling_ratio, stream)
    kernels.check(lib, err, "roi_align kernel launch")


def _launch(fmaps, rois, scales, out_size, sampling_ratio, min_level,
            round_a: bool):
    fmaps, batched, b, r_per, heights, meta, fmeta = _kernel_inputs(
        fmaps, rois, scales, out_size, sampling_ratio, min_level)
    out = torch.empty(meta.shape[0], out_size, out_size, fmaps[0].shape[-1],
                      dtype=fmaps[0].dtype, device=rois.device)
    _kernel_launch(fmaps, heights, meta, fmeta, out, sampling_ratio, round_a)
    return _finish(out, batched, b, r_per, out_size)


def _dispatch(wrapper, fmaps, rois, scales, out_size, sampling_ratio,
              min_level, round_a):
    if rois.device.type == "cpu":
        plain = (multilevel_roi_align_canvas_plain if round_a
                 else multilevel_roi_align_pallas_plain)
        return plain(fmaps, rois, scales, out_size, sampling_ratio,
                     min_level)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: no kernel for {rois.device}")
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
