"""Greedy NMS as an order, a suppression bitmask and a scan: the K4
kernels and their plain versions.

Counterpart of `ekaid_tpu/ops/pallas_nms.py`. Per image: take the live
row with the largest score (the lowest index among equal scores; -0.0
and 0.0 are equal), emit it, kill it and every row whose geometric IoU
with it exceeds the threshold, and repeat for `max_out` slots. A row is
live iff its score is above NEG / 2, so padding rows carry NEG and a NaN
score is dead. When nothing is live, every remaining slot is
(0, False). The selections are bit-equal to `ops/nms.py::nms` (the
blocked NMS) and `nms_argmax`.

IoU is evaluated in one order everywhere: area = max(x2 - x1, 0) *
max(y2 - y1, 0), iw/ih clamped at 0, union = (area + barea) - inter,
iou = inter / union where union > 0 else 0, each step rounded (the
kernels write them as `__fsub_rn`/`__fmul_rn`/`__fadd_rn`/`__fdiv_rn`,
so nothing is contracted into an FMA).

Three functions compute it:

* `nms_kernel_plain`: the function as `max_out` dependent steps in
  torch, with no host read; the gate for the others.
* `nms_bitmask_plain`: the kernels' algorithm in torch. The rows sorted
  by (score desc, index asc), dead rows last by index (a rank by
  counting); the suppression mask in sorted order, where bit b of word
  w of sorted row k (int64, bit 63 the sign) is set iff column
  l = 64 w + b is above k, below L (the live rows) and iou(k, l) >
  thresh; then a scan over chunks of 64 sorted rows: the chunk's
  removed word is the OR of word c of the rows kept so far, its
  candidates are resolved in order from their diagonal words, and the
  walk stops after `max_out` picks or L rows. Only words at or right of
  the diagonal of rows below L are read (`mask_words_written`).
* `nms_kernel`: for a CUDA tensor one call of
  `ekaid_torch/csrc/nms.cu::ekaid_nms`, which runs two kernels on the
  current stream in scratch the wrapper allocates (`scratch_bytes`):
  the order (a cluster of 8 blocks an image), then one cooperative
  launch in which producer blocks build the mask's tiles column by
  column while a warp per image scans the columns already whole, and
  the tiles the walk never reaches are not built. Counted in
  `nms_kernel.launches`, one per call. It never falls back. With
  `debug`, the call builds the whole mask and hands back the scratch's
  order, mask and counts, for holding them against
  `nms_bitmask_plain`. For a CPU tensor it runs `nms_kernel_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

NEG = -1e9
WORD = 64
# the order kernel sorts an image with a cluster of 8 blocks of at most
# 1024 threads, each thread holding 2 keys
MAX_ROWS = 8 * 2048
# the words of a column's bitmap of row tiles (csrc/nms.cu::kNzWords)
_NZ_WORDS = MAX_ROWS // WORD // 64
# rows of the plain mask and order computed at once
_PLAIN_ROWS = 256
# bit b of an int64 word; bit 63 is the sign
_BITS = torch.tensor([1 << b for b in range(WORD - 1)] + [-(1 << 63)],
                     dtype=torch.int64)


def _flatten(boxes: torch.Tensor, scores: torch.Tensor):
    """Checks; boxes [N, R, 4] and scores [N, R] f32 over the flattened
    leading dims."""
    if boxes.shape[:-1] != scores.shape or boxes.shape[-1:] != (4,):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)} and scores "
                         f"{tuple(scores.shape)} must be [..., R, 4] and "
                         "[..., R]")
    n, r = math.prod(scores.shape[:-1]), scores.shape[-1]
    return boxes.reshape(n, r, 4).float(), scores.reshape(n, r).float()


def nms_kernel_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float, max_out: int,
                     live_rows: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain torch. boxes [..., R, 4], scores [..., R]
    -> (indices [..., max_out] int32, valid [..., max_out] bool).

    `live_rows`, an int64 tensor of the flattened batch's length on the
    same device, gets each image's rows live at the start of every step
    added to it: the rows that the steps' IoU passes need."""
    lead = scores.shape[:-1]
    boxes, scores = _flatten(boxes, scores)
    n, r = scores.shape
    dev = scores.device
    idx_out = torch.zeros(n, max_out, dtype=torch.int32, device=dev)
    valid_out = torch.zeros(n, max_out, dtype=torch.bool, device=dev)
    if r and max_out:
        neg = torch.full_like(scores, NEG)
        masked = torch.where(scores > NEG / 2, scores, neg)
        x1, y1, x2, y2 = boxes.unbind(-1)
        area = (torch.clamp(x2 - x1, min=0.0)
                * torch.clamp(y2 - y1, min=0.0))
        ar = torch.arange(r, device=dev)
        beyond = torch.full_like(ar, r)
        for i in range(max_out):
            if live_rows is not None:
                live_rows += (masked > NEG).sum(-1)
            best_val = masked.amax(dim=-1, keepdim=True)           # [n, 1]
            best = torch.where(masked == best_val, ar, beyond).amin(
                dim=-1, keepdim=True)                               # [n, 1]
            ok = best_val > NEG
            bx1, by1, bx2, by2 = (torch.gather(c, 1, best)
                                  for c in (x1, y1, x2, y2))
            barea = torch.gather(area, 1, best)
            iw = torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1),
                             min=0.0)
            ih = torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1),
                             min=0.0)
            inter = iw * ih
            union = area + barea - inter
            iou = torch.where(union > 0, inter / union,
                              torch.zeros_like(inter))
            masked = torch.where((iou > iou_thresh) | (ar == best), neg,
                                 masked)
            idx_out[:, i] = torch.where(ok, best, 0)[:, 0].to(torch.int32)
            valid_out[:, i] = ok[:, 0]
    return (idx_out.reshape(*lead, max_out),
            valid_out.reshape(*lead, max_out))


# ---- the bitmask algorithm in torch ------------------------------------

def words_per_row(r: int) -> int:
    return -(-r // WORD)


def _bitmask_order(scores: torch.Tensor):
    """scores [n, R] -> (order [n, R] int64, live [n] int64): the rows in
    (score desc, index asc) order, dead rows last by index, each row's
    place its count of rows before it."""
    n, r = scores.shape
    dev = scores.device
    live = scores > NEG / 2
    key = torch.where(live, scores, torch.full_like(scores, -math.inf))
    ar = torch.arange(r, device=dev)
    rank = torch.empty(n, r, dtype=torch.int64, device=dev)
    for s in range(0, r, _PLAIN_ROWS):
        ki, ii = key[:, s:s + _PLAIN_ROWS, None], ar[s:s + _PLAIN_ROWS, None]
        kj = key[:, None, :]
        rank[:, s:s + _PLAIN_ROWS] = ((kj > ki) | ((kj == ki) & (ar < ii))
                                      ).sum(-1)
    order = torch.empty_like(rank).scatter_(1, rank,
                                            ar.expand(n, r).contiguous())
    return order, live.sum(-1)


def _bitmask_words(boxes: torch.Tensor, order: torch.Tensor,
                   live: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The suppression mask [n, R, W] int64 in sorted order, zero where
    the kernels write nothing."""
    n, r = order.shape
    dev = order.device
    w = words_per_row(r)
    sb = torch.gather(boxes, 1, order[..., None].expand(n, r, 4))
    x1, y1, x2, y2 = sb.unbind(-1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    col = torch.arange(r, device=dev)
    bits = _BITS.to(dev)
    mask = torch.zeros(n, r, w, dtype=torch.int64, device=dev)
    for s in range(0, r, _PLAIN_ROWS):
        rows = slice(s, s + _PLAIN_ROWS)
        bx1, by1, bx2, by2, barea = (v[:, rows, None]
                                     for v in (x1, y1, x2, y2, area))
        iw = torch.clamp(torch.minimum(x2[:, None], bx2)
                         - torch.maximum(x1[:, None], bx1), min=0.0)
        ih = torch.clamp(torch.minimum(y2[:, None], by2)
                         - torch.maximum(y1[:, None], by1), min=0.0)
        inter = iw * ih
        union = area[:, None] + barea - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
        k = col[rows, None]
        hit = ((iou > iou_thresh) & (col > k)
               & (col < live[:, None, None]) & (k < live[:, None, None]))
        hit = torch.nn.functional.pad(hit, (0, w * WORD - r))
        mask[:, rows] = (hit.view(n, -1, w, WORD).long() * bits).sum(-1)
    return mask


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """int64 words [...] -> their bits [..., 64] as bool."""
    return (words[..., None] & _BITS.to(words.device)) != 0


def _bitmask_scan(mask: torch.Tensor, order: torch.Tensor,
                  live: torch.Tensor, max_out: int):
    """The chunked scan over the mask: (indices [n, max_out] int32, valid
    [n, max_out] bool, rows walked [n], chunks walked [n], picks [n])."""
    n, r, w = mask.shape
    dev = mask.device
    idx = torch.zeros(n, max_out, dtype=torch.int32, device=dev)
    valid = torch.zeros(n, max_out, dtype=torch.bool, device=dev)
    kept = torch.zeros(n, r, dtype=torch.bool, device=dev)
    picks, walked, chunks = (torch.zeros(n, dtype=torch.int64, device=dev)
                             for _ in range(3))
    lane = torch.arange(WORD, device=dev)
    for c in range(w):
        base = c * WORD
        on = (base < live) & (picks < max_out)
        if not bool(on.any()):
            break
        chunks += on
        nc = (live - base).clamp(0, WORD)
        # word c of every row kept so far; rows past L are not candidates
        rem = (_unpack(mask[:, :, c]) & kept[..., None]).any(1)
        rem |= lane >= nc[:, None]
        rows = mask[:, base:base + WORD, c]
        diag = _unpack(torch.nn.functional.pad(rows,
                                               (0, WORD - rows.shape[1])))
        for i in range(WORD):                    # in order, in registers
            rem = rem | (diag[:, i] & ~rem[:, i, None])
        keep = ~rem & on[:, None]
        keep &= keep.cumsum(1) <= (max_out - picks)[:, None]
        nk = keep.sum(1)
        last = torch.where(keep, lane, -1).amax(1)
        walked = torch.where(on, torch.where(picks + nk >= max_out,
                                             base + last + 1, base + nc),
                             walked)
        img, i = keep.nonzero(as_tuple=True)
        slot = picks[img] + keep.cumsum(1)[img, i] - 1
        idx[img, slot] = order[img, base + i].to(torch.int32)
        valid[img, slot] = True
        kept[img, base + i] = True
        picks += nk
    return idx, valid, walked, chunks, picks


def mask_words_written(live: torch.Tensor, r: int) -> torch.Tensor:
    """bool [n, R, W]: the words of the whole mask (those the kernels
    write when they build all of it, and of which the scan may read any):
    at or right of the diagonal of rows below L, up to the word of row
    L - 1."""
    dev = live.device
    k = torch.arange(r, device=dev)[:, None]
    wi = torch.arange(words_per_row(r), device=dev)
    return ((k < live[:, None, None]) & (wi >= k // WORD)
            & (wi < (live[:, None, None] + WORD - 1) // WORD))


def nms_bitmask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thresh: float, max_out: int, debug: bool = False):
    """K4's function by the kernels' algorithm in plain torch: boxes
    [..., R, 4], scores [..., R] -> (indices [..., max_out] int32, valid
    [..., max_out] bool). With `debug`, a dict over the flattened batch
    instead: idx, valid, order [n, R] int32, live [n], mask [n, R, W]
    int64 and the scan's walked, chunks and picks [n], as `nms_kernel`'s
    debug output gives them."""
    lead = scores.shape[:-1]
    boxes, scores = _flatten(boxes, scores)
    order, live = _bitmask_order(scores)
    mask = _bitmask_words(boxes, order, live, iou_thresh)
    idx, valid, walked, chunks, picks = _bitmask_scan(mask, order, live,
                                                      max_out)
    if debug:
        return {"idx": idx, "valid": valid, "order": order.to(torch.int32),
                "live": live, "mask": mask, "walked": walked,
                "chunks": chunks, "picks": picks}
    return idx.reshape(*lead, max_out), valid.reshape(*lead, max_out)


# ---- the kernels -----------------------------------------------------------

def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _scratch_parts(n: int, r: int):
    """The kernels' scratch, as in csrc/nms.cu::carve: (name, bytes) in
    order, each part starting on a 16-byte boundary."""
    nr, w = n * r, words_per_row(r)
    return (("mask", nr * w * 8), ("boxes", nr * 16), ("order", nr * 4),
            ("stats", n * 4 * 4), ("done", n * w * 4),
            ("nz", n * w * _NZ_WORDS * 8), ("queue", 8),
            ("flags", (n + 1) * 4))


def scratch_bytes(n: int, r: int) -> int:
    """Bytes of scratch one call on n images of r rows needs."""
    return sum(_align16(b) for _, b in _scratch_parts(n, r))


def scratch_views(scratch: torch.Tensor, n: int, r: int
                  ) -> Dict[str, torch.Tensor]:
    """The kernels' scratch (uint8) as the order, the live rows, the mask
    ([n, R, W]: the kernels keep it as [n, W, R], word c of every row
    together), the scan's counts and the row tiles built in each column
    chunk (`tiles`, [n, W]), over the flattened batch."""
    at, parts = 0, {}
    for name, nbytes in _scratch_parts(n, r):
        parts[name] = scratch[at:at + nbytes]
        at += _align16(nbytes)
    stats = parts["stats"].view(torch.int32).view(n, 4)
    return {"order": parts["order"].view(torch.int32).view(n, r),
            "mask": parts["mask"].view(torch.int64).view(
                n, words_per_row(r), r).transpose(1, 2),
            "live": stats[:, 0], "walked": stats[:, 1],
            "chunks": stats[:, 2], "picks": stats[:, 3],
            "tiles": parts["done"].view(torch.int32).view(
                n, words_per_row(r))}


def _kernel_launch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_thresh: float, idx: torch.Tensor, valid: torch.Tensor,
                   scratch: torch.Tensor, full_mask: bool = False) -> None:
    """The launch alone: contiguous f32 boxes [N, R, 4] and scores
    [N, R] on one CUDA device into idx [N, M] int32 and valid [N, M]
    bool, with `scratch_bytes(N, R)` bytes of scratch, all made before.
    `full_mask` builds the whole mask, not only what the walk reads."""
    from ekaid_torch import kernels
    dev = scores.device
    lib = kernels.load("nms")
    n, r = scores.shape

    def launch():
        return lib.ekaid_nms(
            boxes.data_ptr(), scores.data_ptr(), ctypes.c_float(iou_thresh),
            idx.data_ptr(), valid.data_ptr(), scratch.data_ptr(), n, r,
            idx.shape[1], int(full_mask),
            torch.cuda.current_stream(dev).cuda_stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    kernels.check(lib, err, "nms kernel launch")


def kernel_buffers(n: int, r: int, max_out: int, device):
    """Empty idx [n, max_out] int32, valid [n, max_out] bool and the
    scratch of one call."""
    return (torch.empty(n, max_out, dtype=torch.int32, device=device),
            torch.empty(n, max_out, dtype=torch.bool, device=device),
            torch.empty(scratch_bytes(n, r), dtype=torch.uint8,
                        device=device))


def nms_kernel(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               max_out: int, debug: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: greedy NMS of one image (boxes [R, 4], scores [R]) or a batch
    (leading dims flattened) -> (indices [..., max_out] int32, valid
    [..., max_out] bool). The kernels for CUDA tensors, the plain version
    for CPU tensors; R may not exceed MAX_ROWS on either. `debug`, a dict
    (CUDA only), gets the call's `scratch_views` over the flattened
    batch, from a call that builds the whole mask."""
    r = scores.shape[-1]
    if r > MAX_ROWS:
        raise ValueError(f"nms kernel: {r} rows per image exceed the "
                         f"{MAX_ROWS} its order kernel sorts in shared "
                         "memory (8 blocks of 2048)")
    if max_out < 0:
        raise ValueError(f"nms kernel: max_out {max_out} < 0")
    if scores.device.type == "cpu" and debug is None:
        return nms_kernel_plain(boxes, scores, iou_thresh, max_out)
    if scores.device.type != "cuda":
        raise ValueError(f"nms kernel: no kernel for {scores.device}")
    if boxes.device != scores.device:
        raise ValueError("nms kernel: boxes and scores on different devices")
    lead = scores.shape[:-1]
    fb, fs = _flatten(boxes, scores)
    fb, fs = fb.contiguous(), fs.contiguous()
    n = fs.shape[0]
    idx, valid, scratch = kernel_buffers(n, r, max_out, fs.device)
    if n and max_out:
        _kernel_launch(fb, fs, iou_thresh, idx, valid, scratch,
                       full_mask=debug is not None)
        nms_kernel.launches += 1
        if debug is not None:
            debug.update(scratch_views(scratch, n, r))
    return idx.reshape(*lead, max_out), valid.reshape(*lead, max_out)


nms_kernel.launches = 0
