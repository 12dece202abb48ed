"""ROIAlign: bilinear ROI pooling over FPN feature maps (gather form).

Counterpart of `ekaid_tpu/ops/roi_align.py` (the reference's 'xla'
backend): ROIAlignV2 semantics ("aligned=True": box coordinates shifted
by -0.5 pixel, each output bin averages a fixed `sampling_ratio` x
`sampling_ratio` grid of bilinear samples; samples outside [-1, H] are
zeroed, the others clamped). `multilevel_roi_align` assigns each ROI to
an FPN level with the canonical heuristic and pools every ROI with one
gather against a table of all levels, in chunks of 256 ROIs.

Feature maps are NHWC ([H, W, C] per level, one image). The gather form
is differentiable with respect to the maps and the boxes: the detector's
ROI loss trains through it, as the reference's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _bilinear_gather(fmap: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """fmap [H, W, C]; ys/xs [...] continuous coords -> [..., C]."""
    h, w = fmap.shape[0], fmap.shape[1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0 = y0.long()
    x0 = x0.long()

    def at(yi, xi):
        return fmap[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    v = (at(y0, x0) * ((1 - ly) * (1 - lx))[..., None]
         + at(y0, x0 + 1) * ((1 - ly) * lx)[..., None]
         + at(y0 + 1, x0) * (ly * (1 - lx))[..., None]
         + at(y0 + 1, x0 + 1) * (ly * lx)[..., None])
    inside = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
    return torch.where(inside[..., None], v, torch.zeros_like(v))


def roi_align(fmap: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              out_size: int = 7, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """fmap [H, W, C]; rois [R, 4] (x1, y1, x2, y2) in image coords ->
    [R, out_size, out_size, C]."""
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    s = sampling_ratio
    bin_h = roi_h / out_size
    bin_w = roi_w / out_size
    dev, dt = fmap.device, fmap.dtype
    bins = torch.arange(out_size, dtype=dt, device=dev)
    sub = (torch.arange(s, dtype=dt, device=dev) + 0.5) / s
    grid = bins[:, None] + sub[None, :]                  # [out, s]
    ys = y1[:, None, None] + bin_h[:, None, None] * grid[None]
    xs = x1[:, None, None] + bin_w[:, None, None] * grid[None]
    ys_b, xs_b = torch.broadcast_tensors(ys[:, :, :, None, None],
                                         xs[:, None, None, :, :])
    vals = _bilinear_gather(fmap, ys_b, xs_b)            # [R,out,s,out,s,C]
    return vals.mean(dim=(2, 4))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on every device. (On CUDA, PyTorch divides by
    a Python scalar as a product with the scalar's f32 reciprocal, which
    can differ by an ulp; a 0-d tensor on x's device is divided.)"""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """log2 of an f32 tensor, computed in double and rounded once to f32:
    the correctly rounded value but for ties of vanishing rarity, so the
    CPU, the card and the ROIAlign kernel (`csrc/roi_align.cu`) agree bit
    for bit. torch's f32 log2 and CUDA's log2f are each within an ulp,
    but not the same ulp, and a level flips on that ulp at a boundary."""
    return torch.log2(x.double()).float()


def assign_levels(rois: torch.Tensor, min_level: int = 2,
                  max_level: int = 5, canonical_size: float = 224.0,
                  canonical_level: int = 4) -> torch.Tensor:
    """FPN level per ROI (Detectron2 ROIPooler heuristic), int32. A
    discrete choice, taken on the detached boxes: no gradient flows
    through it (`jax.grad` gives 0 there; autograd through floor of
    sqrt(0) would give NaN for a zero-area ROI)."""
    rois = rois.detach()
    w = torch.clamp(rois[:, 2] - rois[:, 0], min=0.0)
    h = torch.clamp(rois[:, 3] - rois[:, 1], min=0.0)
    size = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level
                      + log2_f32(true_div(torch.clamp(size, min=1e-6),
                                          canonical_size)))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def multilevel_roi_align(fmaps: Sequence[torch.Tensor], rois: torch.Tensor,
                         scales: Sequence[float], out_size: int = 7,
                         sampling_ratio: int = 2, min_level: int = 2,
                         roi_chunk: Optional[int] = None) -> torch.Tensor:
    """fmaps: list of [H_l, W_l, C] (p2..p5); rois [R, 4] ->
    [R, out, out, C]. `roi_chunk` None pools in chunks of 256 ROIs
    (padding R up), 0 in one piece."""
    s = sampling_ratio
    os_ = out_size * s
    C = fmaps[0].shape[-1]
    dev = rois.device
    flat = torch.cat([f.reshape(-1, C) for f in fmaps], 0)
    dt = flat.dtype
    heights = torch.tensor([f.shape[0] for f in fmaps], device=dev)
    widths = torch.tensor([f.shape[1] for f in fmaps], device=dev)
    offsets = torch.tensor(
        [0] + list(np.cumsum([f.shape[0] * f.shape[1] for f in fmaps]))[:-1],
        device=dev)
    scale_arr = torch.tensor(scales, dtype=torch.float32, device=dev)
    max_level = min_level + len(fmaps) - 1
    pmat_np = np.zeros((out_size, os_), np.float32)
    for b in range(out_size):
        pmat_np[b, b * s:(b + 1) * s] = 1.0 / s
    pmat = torch.as_tensor(pmat_np, device=dev).to(dt)
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    grid = (bins[:, None] + sub[None, :]).reshape(-1)    # [out*s]

    def pool(rois):
        lvl_idx = (assign_levels(rois, min_level, max_level)
                   - min_level).long()
        r_scale = scale_arr[lvl_idx]
        x1 = rois[:, 0] * r_scale - 0.5
        y1 = rois[:, 1] * r_scale - 0.5
        roi_w = (rois[:, 2] - rois[:, 0]) * r_scale
        roi_h = (rois[:, 3] - rois[:, 1]) * r_scale
        ys = y1[:, None] + (roi_h / out_size)[:, None] * grid[None]
        xs = x1[:, None] + (roi_w / out_size)[:, None] * grid[None]
        ys_b = ys[:, :, None]                            # [R, os, 1]
        xs_b = xs[:, None, :]                            # [R, 1, os]
        y0 = torch.floor(ys_b)
        x0 = torch.floor(xs_b)
        ly = ys_b - y0
        lx = xs_b - x0
        y0i = y0.long()
        x0i = x0.long()
        h = heights[lvl_idx][:, None, None]
        w = widths[lvl_idx][:, None, None]
        off = offsets[lvl_idx][:, None, None]

        def flat_at(yi, xi):
            yc = torch.minimum(torch.clamp(yi, min=0), h - 1)
            xc = torch.minimum(torch.clamp(xi, min=0), w - 1)
            return flat[off + yc * w + xc]               # [R, os, os, C]

        w00 = ((1 - ly) * (1 - lx)).to(dt)
        w01 = ((1 - ly) * lx).to(dt)
        w10 = (ly * (1 - lx)).to(dt)
        w11 = (ly * lx).to(dt)
        v = (flat_at(y0i, x0i) * w00[..., None]
             + flat_at(y0i, x0i + 1) * w01[..., None]
             + flat_at(y0i + 1, x0i) * w10[..., None]
             + flat_at(y0i + 1, x0i + 1) * w11[..., None])
        inside = (ys_b >= -1.0) & (ys_b <= h) & (xs_b >= -1.0) & (xs_b <= w)
        v = torch.where(inside[..., None], v, torch.zeros((), dtype=dt,
                                                          device=dev))
        t = torch.einsum("pa,rabc->rpbc", pmat, v)       # avg sample rows
        return torch.einsum("qb,rpbc->rpqc", pmat, t)    # avg sample cols

    r = rois.shape[0]
    chunk = (256 if r > 256 else 0) if roi_chunk is None else roi_chunk
    if chunk and chunk < r:
        pad = (-r) % chunk
        rp = torch.cat([rois, rois.new_zeros(pad, 4)]) if pad else rois
        out = torch.cat([pool(c) for c in rp.split(chunk)])
        return out[:r]
    return pool(rois)
