"""The detector's training stages (ekaid_torch/models/detector/rpn.py,
heads.py; ops/roi_align.py and ops/roi_kernels.py under autograd)
against the JAX package on the CPU at f32.

Targets and sampled sets are exact, given the reference's own inputs and
its `jax.random` draws, split along its key chain (`split(rng)` inside
`sample_targets`, `fold_in(rng, 7)` for the ROI tie-break). Stage
losses: 1e-5 relative (sums over up to 10^4 terms in another order).
Gradients of the gather-form ROIAlign: rtol 1e-5 and atol 1e-5 x the
largest magnitude of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_tpu.models.detector.heads as jheads
import ekaid_tpu.models.detector.rpn as jrpn
import ekaid_tpu.ops.roi_align as jra
from ekaid_torch.models.detector import heads as theads
from ekaid_torch.models.detector import rpn as trpn
from ekaid_torch.ops import roi_align as tra
from ekaid_torch.ops import roi_kernels as trk

K = 4
SCALES = [0.25, 0.125, 0.0625, 0.03125]
LOSS_RTOL = 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.detach().numpy()


def boxes(rng, n, size=128.0, lo=4.0, hi=0.5):
    x1 = rng.uniform(0, size * 0.7, n)
    y1 = rng.uniform(0, size * 0.7, n)
    w = rng.uniform(lo, size * hi, n)
    h = rng.uniform(lo, size * hi, n)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def jax_uniforms(rng, n):
    """The two priority draws of the reference's `sample_targets`."""
    r_pos, r_neg = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(r_pos, (n,))),
            np.asarray(jax.random.uniform(r_neg, (n,))))


def gt_set(rng, g=6, n_valid=4):
    gb = np.zeros((g, 4), np.float32)
    gb[:n_valid] = boxes(rng, n_valid, hi=0.4)
    gv = np.arange(g) < n_valid
    gc = rng.integers(0, K, g).astype(np.int32)
    return gb, gc, gv


def anchor_set(rng, gb, n=600):
    """Random anchors plus jittered copies of the gts (positives)."""
    a = boxes(rng, n)
    a[:8] = np.repeat(gb[:4], 2, 0) + rng.uniform(-3, 3, (8, 4))
    return a.astype(np.float32)


rpn_targets_j = jax.jit(jrpn.rpn_targets)
sample_targets_j = jax.jit(jrpn.sample_targets,
                           static_argnames=("batch_size",
                                            "positive_fraction"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpn_targets_and_sampling_exact(seed):
    rng = np.random.default_rng(seed)
    gb, _, gv = gt_set(rng)
    an = anchor_set(rng, gb)
    labels, matched = rpn_targets_j(an, gb, gv)
    got_l, got_m = trpn.rpn_targets(T(an), T(gb), T(gv))
    np.testing.assert_array_equal(N(got_l), np.asarray(labels))
    np.testing.assert_array_equal(N(got_m), np.asarray(matched))
    assert (np.asarray(labels) == 1).any() and (np.asarray(labels) == 0).any()
    # a small sampling batch, so both the positive and negative cuts bind
    for bs, pf in ((256, 0.5), (16, 0.5), (10, 0.25)):
        key = jax.random.PRNGKey(seed + 10)
        w = sample_targets_j(labels, key, batch_size=bs,
                             positive_fraction=pf)
        u_pos, u_neg = jax_uniforms(key, an.shape[0])
        got = trpn.sample_targets(got_l, T(u_pos), T(u_neg), batch_size=bs,
                                  positive_fraction=pf)
        np.testing.assert_array_equal(N(got), np.asarray(w))


def test_rpn_targets_batched_equals_per_image():
    rng = np.random.default_rng(3)
    sets = [gt_set(rng) for _ in range(3)]
    an = anchor_set(rng, sets[0][0])
    gb = np.stack([s[0] for s in sets])
    gv = np.stack([s[2] for s in sets])
    lab, mat = trpn.rpn_targets(T(an), T(gb), T(gv))
    for i in range(3):
        li, mi = rpn_targets_j(an, gb[i], gv[i])
        np.testing.assert_array_equal(N(lab[i]), np.asarray(li))
        np.testing.assert_array_equal(N(mat[i]), np.asarray(mi))


def test_forced_positive_of_anchor_zero_is_lost_to_padded_gts():
    """The reference forces each valid gt's best anchor positive with a
    scatter whose indices repeat; XLA keeps the last write. Padded gts
    (every IoU -1) all name anchor 0, so a valid gt whose best anchor is
    anchor 0 loses its forced positive to the padding after it, while a
    valid gt after the padding keeps its own."""
    an = np.array([[0, 0, 40, 40], [60, 60, 100, 100],
                   [100, 0, 140, 40], [0, 100, 40, 140]], np.float32)
    # gt 0 best matches anchor 0 with IoU under 0.3 (so only the forced
    # positive could make it positive); gt 3 (after two pads) likewise
    # for anchor 2
    gb = np.array([[0, 0, 12, 12], [0, 0, 0, 0], [0, 0, 0, 0],
                   [100, 0, 112, 12]], np.float32)
    gv = np.array([True, False, False, True])
    labels, matched = rpn_targets_j(an, gb, gv)
    got_l, got_m = trpn.rpn_targets(T(an), T(gb), T(gv))
    np.testing.assert_array_equal(N(got_l), np.asarray(labels))
    np.testing.assert_array_equal(N(got_m), np.asarray(matched))
    assert list(np.asarray(labels)) == [0, 0, 1, 0]   # anchor 0 not forced
    # with the padding first, anchor 0 keeps its forced positive
    order = [1, 2, 0, 3]
    labels2, _ = rpn_targets_j(an, gb[order], gv[order])
    got2, _ = trpn.rpn_targets(T(an), T(gb[order]), T(gv[order]))
    np.testing.assert_array_equal(N(got2), np.asarray(labels2))
    assert list(np.asarray(labels2)) == [1, 0, 1, 0]


def test_rpn_targets_without_gt():
    an = anchor_set(np.random.default_rng(4), boxes(
        np.random.default_rng(5), 4))
    gb = np.zeros((3, 4), np.float32)
    gv = np.zeros(3, bool)
    labels, matched = rpn_targets_j(an, gb, gv)
    got_l, got_m = trpn.rpn_targets(T(an), T(gb), T(gv))
    np.testing.assert_array_equal(N(got_l), np.asarray(labels))
    np.testing.assert_array_equal(N(got_m), np.asarray(matched))


def rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_loss_within_1e5(seed):
    rng = np.random.default_rng(seed)
    gb, _, gv = gt_set(rng)
    an = anchor_set(rng, gb, n=2000)
    logits = rng.standard_normal(2000).astype(np.float32) * 2
    deltas = rng.standard_normal((2000, 4)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jrpn.rpn_loss)(logits, deltas, an, gb, gv, key)
    u_pos, u_neg = jax_uniforms(key, 2000)
    got, ch = trpn.rpn_loss(T(logits), T(deltas), T(an), T(gb), T(gv),
                            T(u_pos), T(u_neg))
    for k in ("rpn_obj", "rpn_box"):
        assert rel(got[k], want[k]) <= LOSS_RTOL, k
    assert float(want["rpn_box"]) > 0
    # the returned choices replay to the same losses, bit for bit
    again, _ = trpn.rpn_loss(T(logits), T(deltas), T(an), T(gb), T(gv),
                             choices=ch)
    for k in got:
        assert torch.equal(again[k], got[k])


def test_sigmoid_bce_matches_jax():
    x = np.linspace(-30, 30, 121).astype(np.float32)
    for t in (0.0, 1.0):
        tt = np.full_like(x, t)
        np.testing.assert_allclose(
            N(trpn.optax_sigmoid_bce(T(x), T(tt))),
            np.asarray(jrpn.optax_sigmoid_bce(x, tt)), rtol=1e-6, atol=1e-7)


def proposal_set(rng, gb, r=300):
    p = boxes(rng, r)
    p[:12] = np.repeat(gb[:4], 3, 0) + rng.uniform(-4, 4, (12, 4))
    valid = np.ones(r, bool)
    valid[-20:] = False
    return p.astype(np.float32), valid


@pytest.mark.parametrize("bs,pf", [(512, 0.25), (64, 0.25), (16, 0.5)])
def test_roi_targets_and_sample_proposals_exact(bs, pf):
    rng = np.random.default_rng(bs)
    gb, gc, gv = gt_set(rng)
    props, pvalid = proposal_set(rng, gb)
    cls, best = jax.jit(jheads.roi_targets, static_argnums=4)(
        props, gb, gc, gv, K)
    got_c, got_b = theads.roi_targets(T(props), T(gb), T(gc), T(gv), K)
    np.testing.assert_array_equal(N(got_c), np.asarray(cls))
    np.testing.assert_array_equal(N(got_b), np.asarray(best))
    assert (np.asarray(cls) < K).any()
    key = jax.random.PRNGKey(bs + 1)
    want = jax.jit(jheads.sample_proposals,
                   static_argnames=("num_classes", "batch_size",
                                    "positive_fraction"))(
        props, pvalid, gb, gc, gv, key, num_classes=K, batch_size=bs,
        positive_fraction=pf)
    u_pos, u_neg = jax_uniforms(key, props.shape[0])
    u_tie = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7),
                                          (props.shape[0],)))
    got = theads.sample_proposals(T(props), T(pvalid), T(gb), T(gc), T(gv),
                                  T(u_pos), T(u_neg), T(u_tie), K,
                                  batch_size=bs, positive_fraction=pf)
    for k, w in zip(("idx", "weight", "cls", "matched"), want):
        np.testing.assert_array_equal(N(got[k]), np.asarray(w), err_msg=k)


def test_roi_loss_within_1e5():
    rng = np.random.default_rng(7)
    gb, gc, gv = gt_set(rng)
    s = 200
    props, _ = proposal_set(rng, gb, s)
    scores = rng.standard_normal((s, K + 1)).astype(np.float32) * 3
    deltas = rng.standard_normal((s, 4 * K)).astype(np.float32) * 0.5
    cls = np.where(rng.random(s) < 0.3, rng.integers(0, K, s), K
                   ).astype(np.int32)
    matched = rng.integers(0, 4, s).astype(np.int64)
    weight = (rng.random(s) < 0.8).astype(np.float32)
    want = jax.jit(jheads.roi_loss, static_argnums=7)(
        scores, deltas, props, cls, matched, weight, gb, K)
    got = theads.roi_loss(T(scores), T(deltas), T(props), T(cls),
                          T(matched), T(weight), T(gb), K)
    for k in ("roi_cls", "roi_box"):
        assert rel(got[k], want[k]) <= LOSS_RTOL, k


# ---- ROIAlign under autograd --------------------------------------------

def pyramid(rng, size=128, c=8):
    return [rng.standard_normal((size // s, size // s, c)).astype(np.float32)
            for s in (4, 8, 16, 32)]


def roi_set(rng):
    """Random ROIs, plus zero-area ones (at a corner, inside, on an edge)
    and ROIs clipped at or past the image border."""
    r = boxes(rng, 40, hi=0.8)
    extra = np.array([[0, 0, 0, 0], [37.3, 21.7, 37.3, 21.7],
                      [50.5, 10.25, 50.5, 90.75], [10.5, 60.25, 90.75, 60.25],
                      [0, 0, 128, 128], [-7.5, -3.25, 40.5, 30.75],
                      [100.25, 90.5, 131.75, 140.25], [0, 0, 128, 0]],
                     np.float32)
    return np.concatenate([r, extra])


@pytest.mark.parametrize("roi_chunk", [None, 16])
def test_gather_roi_align_gradients_match_jax(roi_chunk):
    """Gradients of the gather form with respect to the pyramid and the
    ROIs, against `jax.grad` (satellite of the detector's training: the
    level assignment is a choice without a gradient, so a zero-area ROI
    gives a finite gradient, 0 through the level, as in JAX)."""
    rng = np.random.default_rng(11)
    fm = pyramid(rng)
    rois = roi_set(rng)
    cot = rng.standard_normal((rois.shape[0], 7, 7, 8)).astype(np.float32)

    def f(fm, rois):
        return jnp.sum(jra.multilevel_roi_align(fm, rois, SCALES,
                                                roi_chunk=roi_chunk) * cot)

    gf, gr = jax.jit(jax.grad(f, argnums=(0, 1)))(fm, rois)
    tf = [T(x).requires_grad_() for x in fm]
    tr = T(rois).requires_grad_()
    (tra.multilevel_roi_align(tf, tr, SCALES, roi_chunk=roi_chunk)
     * T(cot)).sum().backward()
    assert torch.isfinite(tr.grad).all()
    for got, want in zip([x.grad for x in tf] + [tr.grad],
                         list(gf) + [gr]):
        want = np.asarray(want)
        np.testing.assert_allclose(N(got), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_zero_area_roi_gradient_through_the_level_is_zero():
    """The level heuristic takes floor(log2(sqrt(w h))): without the
    detach, autograd gives 0 x inf = NaN at w h = 0."""
    rois = torch.tensor([[5.0, 5.0, 5.0, 5.0], [1.0, 2.0, 30.0, 40.0]],
                        requires_grad=True)
    tra.assign_levels(rois).float().sum()      # no graph: a choice
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    torch.floor(torch.sqrt(w * h)).sum().backward()
    assert torch.isnan(rois.grad).any()        # what the detach avoids
    assert not tra.assign_levels(rois).requires_grad


def test_roi_kernels_refuse_inputs_that_require_grad():
    """K2/K3 have no backward: with grad mode on, an input that requires
    grad is refused on the card (the CPU runs the differentiable plain
    version); extraction, under no_grad, passes."""
    rng = np.random.default_rng(12)
    fm = [T(x) for x in pyramid(rng, size=256, c=16)]
    rois = T(boxes(rng, 10, size=256))
    trk.refuse_grad(fm, rois)                  # nothing requires grad
    rg = rois.clone().requires_grad_()
    with pytest.raises(trk.NoGradKernelError):
        trk.refuse_grad(fm, rg)
    fg = [f.clone().requires_grad_() for f in fm]
    with pytest.raises(trk.NoGradKernelError):
        trk.refuse_grad(fg, rois)
    with torch.no_grad():
        trk.refuse_grad(fg, rg)
    # on the CPU the wrappers run their plain versions, with gradients
    out = trk.multilevel_roi_align_canvas([f[None] for f in fg], rg[None],
                                         SCALES)
    out.float().sum().backward()
    assert rg.grad is not None and torch.isfinite(rg.grad).all()
