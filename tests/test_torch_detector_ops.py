"""Parity of the port's detector ops (ekaid_torch/ops/nms.py,
roi_align.py, roi_kernels.py) with the JAX package, on the CPU.

Discrete outputs (kept indices, classes, found flags, valid flags) must
be equal. Pooled features: rtol 1e-4, atol 1e-5, the JAX package's own
tolerance for its ROIAlign kernels. The JAX Pallas kernels run in
interpret mode, as the JAX package's tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_tpu.ops.nms as jnms
import ekaid_tpu.ops.pallas_roi as jroi
import ekaid_tpu.ops.roi_align as jra
from ekaid_torch.ops import nms as tnms
from ekaid_torch.ops import roi_align as tra
from ekaid_torch.ops import roi_kernels as trk

SCALES = [0.25, 0.125, 0.0625, 0.03125]
# the hard ROI set of tests/test_detector_ops.py::test_canvas_roi_matches_xla
HARD_ROIS = np.array([
    [8, 8, 48, 48],
    [4, 4, 120, 90],
    [8, 8, 208, 208],
    [0, 0, 800, 700],
    [0, 0, 1023, 1023],
    [1000, 1000, 1023, 1023],
    [-5, -5, 30, 30],
    [30, 40, 31.5, 41.5],
    [0, 300, 1000, 350],       # elongated -> level bump
    [100, 0, 160, 900],
], np.float32)


def random_boxes(rng, n, size=200):
    x1 = rng.uniform(0, size * 0.7, n)
    y1 = rng.uniform(0, size * 0.7, n)
    w = rng.uniform(5, size * 0.4, n)
    h = rng.uniform(5, size * 0.4, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def tied_scores(rng, shape, levels=5):
    """Scores drawn from a few values, so most of them tie."""
    return (rng.integers(1, levels + 1, shape) / levels).astype(np.float32)


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    """A tensor as numpy, keeping ints and bools; bf16 as f32."""
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ------------------------------------------------------------------ NMS ---

def test_box_iou_matches_jax(rng):
    a, b = random_boxes(rng, 9), random_boxes(rng, 6)
    np.testing.assert_array_equal(
        N(tnms.box_iou(T(a), T(b))),
        np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("case", ["random", "ties", "duplicates"])
@pytest.mark.parametrize("r", [40, 300])
def test_nms_matches_jax(case, r):
    """Blocked NMS (2 blocks of 256 at r=300) against the JAX nms and the
    argmax oracle: kept indices and valid flags exact, tie order too."""
    rng = np.random.default_rng(r)
    boxes = random_boxes(rng, r)
    scores = rng.uniform(0.1, 1.0, r).astype(np.float32)
    if case == "ties":
        scores = tied_scores(rng, r)
    if case == "duplicates":                 # equal boxes, equal scores
        boxes[r // 2:] = boxes[:r - r // 2]
        scores = tied_scores(rng, r, levels=3)
    max_out = min(r, 100)
    want_i, want_v = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                              max_out)
    got_i, got_v = tnms.nms(T(boxes), T(scores), 0.5, max_out)
    np.testing.assert_array_equal(N(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(N(got_i), np.asarray(want_i))
    if r == 40:
        oi, ov = tnms.nms_argmax(T(boxes), T(scores), 0.5, max_out)
        ji, jv = jnms.nms_argmax(jnp.asarray(boxes), jnp.asarray(scores),
                                 0.5, max_out)
        np.testing.assert_array_equal(N(oi), np.asarray(ji))
        np.testing.assert_array_equal(N(ov), np.asarray(jv))
        np.testing.assert_array_equal(N(got_i)[N(got_v)],
                                      N(oi)[N(ov)])


def test_nms_batch_dims_match_per_member():
    """Leading batch dims (the reference's vmap): one call equals a call
    per member, although members converge after different numbers of
    fixed-point iterations."""
    rng = np.random.default_rng(3)
    boxes = np.stack([random_boxes(rng, 300) for _ in range(3)])
    scores = np.stack([tied_scores(rng, 300), rng.uniform(0, 1, 300),
                       tied_scores(rng, 300, levels=2)]).astype(np.float32)
    got_i, got_v = tnms.nms(T(boxes), T(scores), 0.5, 80)
    for b in range(3):
        want_i, want_v = jnms.nms(jnp.asarray(boxes[b]),
                                  jnp.asarray(scores[b]), 0.5, 80)
        np.testing.assert_array_equal(N(got_i[b]), np.asarray(want_i))
        np.testing.assert_array_equal(N(got_v[b]), np.asarray(want_v))


@pytest.mark.parametrize("score_thresh", [float("-inf"), 0.5])
def test_batched_nms_matches_jax(score_thresh):
    rng = np.random.default_rng(5)
    boxes = random_boxes(rng, 120)
    scores = tied_scores(rng, 120)
    classes = rng.integers(0, 4, 120).astype(np.int32)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(classes), 0.5, 60, score_thresh)
    got = tnms.batched_nms(T(boxes), T(scores), T(classes), 0.5, 60,
                           score_thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))


def _score_table(rng, r, k, ties):
    boxes = np.stack([random_boxes(rng, r) for _ in range(k)], axis=1)
    scores = rng.uniform(0, 1, (r, k + 1)).astype(np.float32)
    if ties:
        flat = scores[:, :k].reshape(-1)
        dup = rng.choice(flat.size, 16, replace=False)
        flat[dup[8:]] = flat[dup[:8]]
        scores[:, :k] = flat.reshape(r, k)
    scores /= scores.sum(-1, keepdims=True)
    return boxes, scores


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_out", [8, 30])
def test_fast_rcnn_nms_matches_jax(ties, max_out):
    """Batched over 2 images vs the JAX function per image."""
    rng = np.random.default_rng(7 + max_out)
    tables = [_score_table(rng, 64, 6, ties) for _ in range(2)]
    boxes = np.stack([t[0] for t in tables])
    scores = np.stack([t[1] for t in tables])
    got = tnms.fast_rcnn_nms(T(boxes), T(scores), iou_thresh=0.5,
                             score_thresh=0.05, max_out=max_out)
    for b in range(2):
        want = jnms.fast_rcnn_nms(jnp.asarray(boxes[b]),
                                  jnp.asarray(scores[b]), iou_thresh=0.5,
                                  score_thresh=0.05, max_out=max_out)
        for key in ("proposal_idx", "class_idx", "valid", "boxes",
                    "scores"):
            np.testing.assert_array_equal(N(got[key][b]),
                                          np.asarray(want[key]),
                                          err_msg=key)


@pytest.mark.parametrize("seed", range(4))
def test_select_top1_and_top1_per_class_match_jax(seed):
    rng = np.random.default_rng(seed)
    pre = 8 if seed % 2 == 0 else 30
    boxes, scores = _score_table(rng, 64, 6, ties=True)
    rows, found, sel = tnms.select_top1_per_class(
        T(boxes), T(scores), iou_thresh=0.5, score_thresh=0.05, pre=pre)
    jrows, jfound, jsel = jnms.select_top1_per_class(
        jnp.asarray(boxes), jnp.asarray(scores), iou_thresh=0.5,
        score_thresh=0.05, pre=pre)
    np.testing.assert_array_equal(N(found), np.asarray(jfound))
    np.testing.assert_array_equal(N(rows), np.asarray(jrows))
    np.testing.assert_array_equal(N(sel), np.asarray(jsel))
    det = jnms.fast_rcnn_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             iou_thresh=0.5, score_thresh=0.05, max_out=pre)
    slot, f = tnms.top1_per_class(T(det["class_idx"]), T(det["valid"]), 6)
    jslot, jf = jnms.top1_per_class(det["class_idx"], det["valid"], 6)
    np.testing.assert_array_equal(N(slot), np.asarray(jslot))
    np.testing.assert_array_equal(N(f), np.asarray(jf))


# ------------------------------------------------------------- ROIAlign ---

def _pyramid(rng, b=None, c=8, size=256, dtype=np.float32):
    lead = () if b is None else (b,)
    return [rng.standard_normal(lead + (size >> i, size >> i, c)
                                ).astype(dtype) for i in range(4)]


def test_roi_align_and_levels_match_jax(rng):
    fmap = rng.standard_normal((32, 32, 8)).astype(np.float32)
    rois = random_boxes(rng, 12, size=120)
    rois[0] = [-5, -5, 30, 30]
    np.testing.assert_allclose(
        N(tra.roi_align(T(fmap), T(rois), 0.25, out_size=7)),
        np.asarray(jra.roi_align(jnp.asarray(fmap), jnp.asarray(rois), 0.25,
                                 out_size=7)), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        N(tra.assign_levels(T(HARD_ROIS))),
        np.asarray(jra.assign_levels(jnp.asarray(HARD_ROIS))))


@pytest.mark.parametrize("n", [8, 263])
def test_multilevel_roi_align_matches_jax(n):
    """The hard set, and a prime count above the 256-ROI chunk."""
    rng = np.random.default_rng(n)
    fmaps = _pyramid(rng)
    rois = HARD_ROIS[:8] if n == 8 else random_boxes(rng, n, size=250)
    want = jra.multilevel_roi_align([jnp.asarray(f) for f in fmaps],
                                    jnp.asarray(rois), SCALES, out_size=7)
    got = tra.multilevel_roi_align([T(f) for f in fmaps], T(rois), SCALES,
                                   out_size=7)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_roi_geometry_matches_jax():
    """Level (with the elongated-ROI bump) and patch geometry, exactly."""
    heights = (256, 128, 64, 32)
    lvl, fmeta = trk._roi_geometry(T(HARD_ROIS), SCALES, heights, 7, 2, 2, 4)
    jl, ys, xs, jf = jroi._roi_geometry(jnp.asarray(HARD_ROIS), SCALES,
                                        heights, 7, 2, 2, 4)
    np.testing.assert_array_equal(N(lvl), np.asarray(jl))
    np.testing.assert_array_equal(N(fmeta).reshape(-1), np.asarray(jf))


KERNELS = {"canvas": (trk.multilevel_roi_align_canvas_plain,
                      trk.multilevel_roi_align_canvas,
                      jroi.multilevel_roi_align_canvas),
           "pallas": (trk.multilevel_roi_align_pallas_plain,
                      trk.multilevel_roi_align_pallas,
                      jroi.multilevel_roi_align_pallas)}


@pytest.mark.parametrize("backend", ["canvas", "pallas"])
def test_plain_kernel_matches_jax_interpret_hard_set(backend):
    """K2/K3 plain versions vs the Pallas kernels (interpret mode) on
    the hard ROI set: clamps, edges, huge boxes, elongated bumps. The
    wrapper on a CPU tensor is the plain version."""
    plain, wrapper, jfn = KERNELS[backend]
    fmaps = _pyramid(np.random.default_rng(11))
    want = np.asarray(jfn([jnp.asarray(f) for f in fmaps],
                          jnp.asarray(HARD_ROIS), SCALES, out_size=7,
                          interpret=True))
    got = N(plain([T(f) for f in fmaps], T(HARD_ROIS), SCALES))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        N(wrapper([T(f) for f in fmaps], T(HARD_ROIS), SCALES)), got)
    assert wrapper.launches == 0


@pytest.mark.parametrize("backend", ["canvas", "pallas"])
def test_plain_kernel_batched_matches_jax_interpret(backend):
    """Batched [B, R] pooling with a ROI count that is not a multiple of
    the Pallas group, against the interpret-mode kernel."""
    plain, _, jfn = KERNELS[backend]
    rng = np.random.default_rng(13)
    fmaps = _pyramid(rng, b=2, size=128)
    rois = rng.uniform(0, 200, (2, 5, 4)).astype(np.float32)
    rois = np.concatenate([np.minimum(rois[..., :2], rois[..., 2:]),
                           np.maximum(rois[..., :2], rois[..., 2:]) + 2], -1)
    want = np.asarray(jfn([jnp.asarray(f) for f in fmaps],
                          jnp.asarray(rois), SCALES, out_size=7,
                          interpret=True))
    got = N(plain([T(f) for f in fmaps], T(rois), SCALES))
    assert got.shape == (2, 5, 7, 7, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_canvas_plain_bf16_within_one_ulp_of_jax():
    """bf16 features: the canvas contract rounds a_y to bf16 and
    accumulates in f32; the result, rounded once to bf16, is within one
    bf16 ulp of the interpret-mode kernel (f32 sums in another order may
    flip the last rounding)."""
    rng = np.random.default_rng(17)
    fmaps = [f.astype(jnp.bfloat16) for f in _pyramid(rng, b=2)]
    rois = np.stack([HARD_ROIS, HARD_ROIS[::-1] + 3])
    want = np.asarray(jroi.multilevel_roi_align_canvas(
        [jnp.asarray(f) for f in fmaps], jnp.asarray(rois), SCALES,
        out_size=7, interpret=True)).astype(np.float32)
    got_t = trk.multilevel_roi_align_canvas_plain(
        [torch.as_tensor(np.asarray(f, np.float32)).bfloat16()
         for f in fmaps], T(rois), SCALES)
    assert got_t.dtype == torch.bfloat16
    got = N(got_t)
    gap = np.abs(got - want)
    assert (gap <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all(), \
        gap.max()
    assert (gap == 0).mean() > 0.99


def test_kernel_wrappers_refuse_bad_geometry():
    """Level widths whose W - 56 is not a multiple of 8, or a top level
    larger than the patch, are refused (the reference asserts)."""
    rng = np.random.default_rng(0)
    odd = [T(rng.standard_normal((s, s, 4)).astype(np.float32))
           for s in (100, 50, 25, 13)]
    with pytest.raises(ValueError, match="multiple of 8"):
        trk.multilevel_roi_align_canvas(odd, T(HARD_ROIS), SCALES)
    big = [T(rng.standard_normal((s, s, 4)).astype(np.float32))
           for s in (512, 256, 128, 64)]
    with pytest.raises(ValueError, match="exceeds"):
        trk.multilevel_roi_align_pallas(big, T(HARD_ROIS), SCALES)
