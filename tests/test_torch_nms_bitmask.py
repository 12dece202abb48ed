"""The bitmask form of the port's greedy NMS (ekaid_torch/ops/
nms_kernel.py::nms_bitmask_plain), which the K4 kernels in
csrc/nms.cu run, against the step-by-step plain version and the JAX
package, on the CPU.

Inputs, numpy from seeds: `chip_smoke.nms_hard_set` (ties, duplicates,
zero-area and inverted boxes, padding, nothing live) and
`chip_smoke.nms_edge_set` (-0.0 / 0.0 ties, NaN scores, one box
repeated, IoU 0 and -0.1, more slots than live rows, R of 1, 63, 64, 65
and 1000). The tolerance is exact: equal valid flags, and equal indices
under them, in order. Then the mask's word layout, what the scan reads,
the scratch's size and layout, and the ctypes entry against the C
signature. The kernels are held bit-equal to `nms_bitmask_plain` (order,
mask, counts) on the card by chip_smoke.py.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ekaid_tpu.ops.nms as jnms
from ekaid_torch import kernels
from ekaid_torch.ops import nms as tnms
from ekaid_torch.ops import nms_kernel as tnk

ROOT = Path(__file__).resolve().parent.parent
CASES = {name: (boxes, scores, iou, max_out) for name, boxes, scores, iou,
         max_out in chip_smoke.nms_hard_set() + chip_smoke.nms_edge_set()}


def T(x):
    return torch.as_tensor(np.array(x))


def assert_same(got, want):
    """Equal valid flags, equal indices under them."""
    (gi, gv), (wi, wv) = [(np.asarray(i), np.asarray(v, bool))
                          for i, v in (got, want)]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.where(gv, gi, -1), np.where(wv, wi, -1))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """`nms_pallas` with its pallas_call in interpret mode."""
    import jax.experimental.pallas as pl
    from ekaid_tpu.ops import pallas_nms as pn

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pn.pl, "pallas_call", interp)
    return pn.nms_pallas


@pytest.mark.parametrize("case", list(CASES))
def test_bitmask_matches_the_step_plain_version(case):
    """Against `nms_kernel_plain` and the port's blocked NMS, with the
    kernels' output types and (0, False) past the last pick."""
    boxes, scores, iou, max_out = CASES[case]
    got = tnk.nms_bitmask_plain(T(boxes), T(scores), iou, max_out)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert tuple(got[0].shape) == (*scores.shape[:-1], max_out)
    assert_same(got, tnk.nms_kernel_plain(T(boxes), T(scores), iou, max_out))
    assert_same(got, tnms.nms(T(boxes), T(scores), iou, max_out))
    assert (got[0].numpy()[~got[1].numpy()] == 0).all()


@pytest.mark.parametrize("case", list(CASES))
def test_bitmask_matches_pallas_interpret(case, pallas_interpret):
    boxes, scores, iou, max_out = CASES[case]
    want = jax.vmap(lambda b, s: pallas_interpret(b, s, iou, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    assert_same(tnk.nms_bitmask_plain(T(boxes), T(scores), iou, max_out),
                want)


@pytest.mark.parametrize("case", [c for c in CASES if c != "signed zeros"])
def test_bitmask_matches_jax_blocked_nms(case):
    boxes, scores, iou, max_out = CASES[case]
    want = jax.vmap(lambda b, s: jnms.nms(b, s, iou, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    assert_same(tnk.nms_bitmask_plain(T(boxes), T(scores), iou, max_out),
                want)


def test_jax_blocked_nms_ranks_zero_above_negative_zero():
    """The one difference from the JAX package's blocked `nms`: its
    survivors are the greedy ones (its sort takes -0.0 and 0.0 as
    equal), but its final `lax.top_k` ranks 0.0 above -0.0. So its
    selection is the full greedy list, stably re-ranked with 0.0 above
    -0.0, cut at max_out; `nms_pallas` and the port rank them as equal
    (the test above)."""
    boxes, scores, iou, max_out = CASES["signed zeros"]
    r = scores.shape[-1]
    full_i, full_v = tnk.nms_bitmask_plain(T(boxes), T(scores), iou, r)
    want_i, want_v = jax.vmap(lambda b, s: jnms.nms(b, s, iou, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    differs = False
    for img in range(scores.shape[0]):
        kept = full_i[img][full_v[img]].numpy()
        s = scores[img][kept]
        ranked = kept[np.lexsort((np.signbit(s), -s))][:max_out]
        np.testing.assert_array_equal(np.asarray(want_i[img])[
            np.asarray(want_v[img])], ranked)
        cut = full_i[img][:max_out][full_v[img][:max_out]].numpy()
        differs |= not np.array_equal(cut, ranked)
    assert differs                  # the case does reach the difference


def test_mask_word_layout():
    """Bit b of word w of sorted row k is iou(sorted k, sorted 64 w + b)
    > thresh for columns above k and below L, from a numpy loop in f32;
    every other bit is 0."""
    rng = np.random.default_rng(5)
    boxes, scores, iou, _ = CASES["max_out > L"]
    boxes, scores = boxes[:2], scores[:2].copy()
    scores[1, :40] = np.nan                       # L differs by image
    d = tnk.nms_bitmask_plain(T(boxes), T(scores), iou, 10, debug=True)
    n, r = scores.shape
    w = tnk.words_per_row(r)
    assert tuple(d["mask"].shape) == (n, r, w) and w == 3
    mask = d["mask"].numpy().view(np.uint64)
    for img in range(n):
        order, live = d["order"][img].numpy(), int(d["live"][img])
        assert live == int((scores[img] > tnk.NEG / 2).sum())
        sb = boxes[img][order]
        x1, y1, x2, y2 = sb.T
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        for k in rng.permutation(r)[:60]:
            iw = np.maximum(np.minimum(x2, x2[k]) - np.maximum(x1, x1[k]), 0)
            ih = np.maximum(np.minimum(y2, y2[k]) - np.maximum(y1, y1[k]), 0)
            inter = iw * ih
            union = area + area[k] - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(union > 0, inter / union, 0)
            col = np.arange(r)
            want = (ratio > np.float32(iou)) & (col > k) & (col < live) & (
                k < live)
            bits = (mask[img, k][:, None] >> np.arange(64, dtype=np.uint64)
                    ) & np.uint64(1)
            np.testing.assert_array_equal(bits.reshape(-1)[:r].astype(bool),
                                          want)
            assert not bits.reshape(-1)[r:].any()


def test_order_sorts_live_rows_then_dead_rows_by_index():
    """(score desc, index asc) with -0.0 == 0.0; NaN and NEG / 2 or below
    dead, after the live rows, by index."""
    scores = np.array([[0.0, -0.0, 0.5, np.nan, -0.0, -5e8, 0.5, -4.9e8,
                        0.0]], np.float32)
    boxes = np.zeros((1, 9, 4), np.float32)
    d = tnk.nms_bitmask_plain(T(boxes), T(scores), 0.5, 9, debug=True)
    assert d["order"][0].tolist() == [2, 6, 0, 1, 4, 8, 7, 3, 5]
    assert d["live"].tolist() == [7]


@pytest.mark.parametrize("case", ["hard set", "R=1000", "IoU -0.1",
                                  "max_out > L", "one box"])
def test_scan_reads_nothing_outside_the_written_words(case):
    """Words below the diagonal, of rows at or past L, or right of row
    L - 1's word may hold anything: the scan's result does not move."""
    boxes, scores, iou, max_out = CASES[case]
    d = tnk.nms_bitmask_plain(T(boxes), T(scores), iou, max_out, debug=True)
    mask, live = d["mask"], d["live"]
    written = tnk.mask_words_written(live, mask.shape[1])
    assert not mask[~written].any()
    g = torch.Generator().manual_seed(3)
    junk = torch.randint(-2 ** 62, 2 ** 62, mask.shape, generator=g)
    poisoned = torch.where(written, mask, junk)
    got = tnk._bitmask_scan(poisoned, d["order"].long(), live, max_out)
    want = (d["idx"], d["valid"], d["walked"], d["chunks"], d["picks"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_scan_counts(case):
    """picks = valid slots; the walk ends at the max_out-th pick (its
    sorted row + 1) or at L; chunks = ceil(rows walked / 64)."""
    boxes, scores, iou, max_out = CASES[case]
    d = tnk.nms_bitmask_plain(T(boxes), T(scores), iou, max_out, debug=True)
    assert torch.equal(d["picks"], d["valid"].sum(-1))
    assert torch.equal(d["chunks"], (d["walked"] + 63) // 64)
    full = d["picks"] < max_out
    assert torch.equal(d["walked"][full], d["live"][full])
    assert (d["walked"] <= d["live"]).all()
    if case == "max_out > L":
        assert d["live"].tolist() == [70] * 3 and full.all()


def test_scratch_bytes():
    """The mask rows' words, the sorted boxes, the order and the counts,
    each part on a 16-byte boundary (csrc/nms.cu::carve)."""
    assert tnk.words_per_row(1000) == 16 and tnk.words_per_row(4768) == 75
    mask = dict(tnk._scratch_parts(8, 1000))["mask"]
    assert mask == 8 * 1000 * 16 * 8                       # 128 KB an image
    mask = dict(tnk._scratch_parts(8, 4768))["mask"]
    assert mask == 8 * 4768 * 75 * 8                       # 22.9 MB
    flags = -(-(8 + 1) * 4 // 16) * 16
    assert tnk.scratch_bytes(8, 4768) == (
        8 * 4768 * (75 * 8 + 16 + 4) + 8 * 16 + 8 * 75 * 4 + 8 * 75 * 32
        + 16 + flags)
    assert tnk.scratch_bytes(1, 1) == 6 * 16 + 32 + 16
    assert tnk.scratch_bytes(3, 0) == 3 * 16 + 16 + 16
    r = tnk.MAX_ROWS
    assert dict(tnk._scratch_parts(1, r))["mask"] == r * (r // 64) * 8


def test_scratch_views_follow_the_layout():
    n, r = 3, 65
    scratch = torch.zeros(tnk.scratch_bytes(n, r), dtype=torch.uint8)
    v = tnk.scratch_views(scratch, n, r)
    base = scratch.data_ptr()
    assert v["mask"].data_ptr() == base
    assert tuple(v["mask"].shape) == (n, r, 2)
    assert v["mask"].stride() == (2 * r, 1, r)       # word c of every row
    boxes_at = -(-n * r * 2 * 8 // 16) * 16
    order_at = boxes_at + n * r * 16
    stats_at = order_at + -(-n * r * 4 // 16) * 16
    assert v["order"].data_ptr() == base + order_at
    assert tuple(v["order"].shape) == (n, r)
    for i, k in enumerate(("live", "walked", "chunks", "picks")):
        assert v[k].data_ptr() == base + stats_at + 4 * i
        assert v[k].stride() == (4,) and v[k].dtype == torch.int32
    done_at = stats_at + n * 16
    assert v["tiles"].data_ptr() == base + done_at
    assert tuple(v["tiles"].shape) == (n, 2)
    flags_at = done_at + -(-n * 2 * 4 // 16) * 16 + n * 2 * 32 + 16
    assert flags_at + (n + 1) * 4 == scratch.numel()


def c_signature(fn: str):
    """The parameter types of `fn` in csrc/nms.cu."""
    src = (ROOT / "ekaid_torch" / "csrc" / "nms.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]


def test_entry_matches_the_c_signature():
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    name, argtypes = kernels.ENTRY["nms"]
    assert name == "ekaid_nms"
    assert [ctype[p] for p in c_signature(name)] == argtypes
    assert len(argtypes) == 11


def test_max_rows_is_the_cluster_sort():
    """8 blocks (a cluster) of at most 1024 threads, 2 keys a thread, as
    the CUDA source has it; the extraction geometry (4,768 rows) fits."""
    src = (ROOT / "ekaid_torch" / "csrc" / "nms.cu").read_text()
    parts = int(re.search(r"kParts = (\d+);", src).group(1))
    per = int(re.search(r"kMaxPart = (\d+);", src).group(1))
    assert "kMaxRows = kParts * kMaxPart;" in src
    assert (parts, per) == (8, 2048) and tnk.MAX_ROWS == parts * per
    assert tnk.MAX_ROWS >= 4768
    # the scratch's bitmaps, as the C source sizes them
    assert "kNzWords = kMaxRows / kTile / 64;" in src
    assert tnk._NZ_WORDS == tnk.MAX_ROWS // 64 // 64 == 4


def test_debug_output_needs_the_kernel():
    before = tnk.nms_kernel.launches
    with pytest.raises(ValueError, match="no kernel"):
        tnk.nms_kernel(torch.zeros(2, 8, 4), torch.zeros(2, 8), 0.5, 4,
                       debug={})
    assert tnk.nms_kernel.launches == before


def test_the_kernel_path_sorts_by_hand():
    """No library sort on K4's path: not in the wrapper's module, not in
    the CUDA source."""
    for f in (ROOT / "ekaid_torch" / "ops" / "nms_kernel.py",
              ROOT / "ekaid_torch" / "csrc" / "nms.cu"):
        src = f.read_text()
        for word in ("torch.sort", "argsort", "topk", "cub::", "thrust"):
            assert word not in src, (f.name, word)
