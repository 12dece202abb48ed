"""Parity of the port's detector (ekaid_torch/models/detector/) with the
JAX package's FasterRCNN, on the CPU at f32 and a small size: 256^2
images (the smallest where the canvas ROIAlign contract holds: levels
64/32/16/8), batch 2, fpn_channels 32, roi_feat_dim 64, K=5, pre/post
NMS 100/50.

Tolerances. Float outputs of a stage fed the reference's own inputs:
allclose at rtol 1e-4 and atol 1e-4 x the largest |value| of the
reference, because 50 layers of f32 sums run in another order (XLA's
and oneDNN's convolutions, flax's E[x^2]-E[x]^2 group-norm variance
against torch's). Images in, the whole detector: 1e-3 in both, because
the box head's two FC layers carry the pyramid's gap into the features
(each output sums 1568 pooled inputs). Discrete outputs (proposal and
class indices, found and valid flags) are exact.

The JAX canvas ROIAlign (a Pallas kernel) runs in interpret mode: the
JAX BoxHead imports it at call time, so the tests patch the module
attribute with `interpret=True`; nothing in the JAX package changes.
"""

import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_tpu.models.detector.anchors as janc
import ekaid_tpu.models.detector.rpn as jrpn
import ekaid_tpu.ops.pallas_roi as jroi
from ekaid_tpu.config import default_config
from ekaid_tpu.models.detector import FasterRCNN as JaxRCNN
from ekaid_tpu.models.detector.backbone import ResNetFPN as JaxFPN
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import load_config
from ekaid_torch.convert import load_flax_params
from ekaid_torch.models.detector import anchors as tanc
from ekaid_torch.models.detector import rpn as trpn
from ekaid_torch.models.detector.backbone import ResNetFPN
from ekaid_torch.models.detector.faster_rcnn import FPN_SCALES, FasterRCNN
from tests._torch_port import init_flax

IMG, B, K = 256, 2, 5


def close(got, want, what="", tol=1e-4):
    """allclose at rtol `tol`, atol `tol` x max|want| (see the module
    docstring)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def exact(got, want, what=""):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what)


def T(x):
    return torch.as_tensor(np.array(x))


def port_det_cfg(jcfg):
    return load_config(overrides={"detector": dataclasses.asdict(jcfg)}
                       ).detector


@pytest.fixture(scope="module")
def setup():
    jcfg = default_config().detector.replace(
        image_size=IMG, pre_nms_topk=100, post_nms_topk=50, roi_feat_dim=64,
        fpn_channels=32, roi_backend="canvas")
    images = np.random.default_rng(0).standard_normal(
        (B, IMG, IMG, 3)).astype(np.float32)
    jm = JaxRCNN(jcfg, num_classes=K, policy=JF32)
    params = init_flax(jm, jnp.asarray(images[:1]))
    tm = load_flax_params(FasterRCNN(port_det_cfg(jcfg), num_classes=K),
                          params).eval()
    return jcfg, jm, params, tm, images


@pytest.fixture(scope="module")
def jax_stages(setup):
    """The reference's pyramid, RPN outputs, proposals and forward."""
    jcfg, jm, params, _, images = setup
    canvas = jroi.multilevel_roi_align_canvas
    jroi.multilevel_roi_align_canvas = functools.partial(canvas,
                                                         interpret=True)
    try:
        def stages(p, x):
            def f(m, x):
                pyr = m._features(x)
                (lg, dl, _), props = m._proposals(pyr)
                return pyr, lg, dl, props, m(x)
            return jm.apply(p, x, method=f)
        pyr, lg, dl, props, fwd = jax.jit(stages)(params,
                                                  jnp.asarray(images))
    finally:
        jroi.multilevel_roi_align_canvas = canvas
    return jax.tree.map(np.asarray, (pyr, lg, dl, props, fwd))


def test_anchors_and_box_transforms_match_jax():
    for a, b in zip(tanc.pyramid_anchors(IMG), janc.pyramid_anchors(IMG)):
        exact(a, b)
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 200, (64, 4)).astype(np.float32)
    src[:, 2:] += src[:, :2] + 1
    deltas = rng.standard_normal((64, 4)).astype(np.float32)
    deltas[:4, 2:] = 9.0                       # past the scale clamp
    for w in [(1, 1, 1, 1), (10, 10, 5, 5)]:
        np.testing.assert_allclose(
            tanc.decode_boxes(T(deltas), T(src), w).numpy(),
            np.asarray(janc.decode_boxes(jnp.asarray(deltas),
                                         jnp.asarray(src), w)),
            rtol=1e-6, atol=1e-4)
        tgt = tanc.decode_boxes(T(deltas) * 0.1, T(src), w)
        np.testing.assert_allclose(
            tanc.encode_boxes(T(src), tgt, w).numpy(),
            np.asarray(janc.encode_boxes(jnp.asarray(src),
                                         jnp.asarray(tgt.numpy()), w)),
            rtol=1e-5, atol=1e-5)


def test_backbone_pyramid_matches_jax(setup, jax_stages):
    _, _, _, tm, images = setup
    with torch.no_grad():
        got = tm.features(T(images))
    for lvl, (g, w) in enumerate(zip(got, jax_stages[0])):
        # p2..p5 feed the ROIAlign kernels, which take contiguous NHWC
        assert lvl == 4 or g.is_contiguous(), f"p{lvl + 2} not NHWC"
        close(g, w, f"p{lvl + 2}")


@pytest.mark.parametrize("norm,stride_in_1x1", [("frozen_bn", True),
                                                ("gn", True)])
def test_backbone_variants_match_jax(norm, stride_in_1x1):
    """The converted-Detectron2 settings (FrozenAffine norms, stride on
    the 1x1 conv) load and compute as in the reference."""
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    jm = JaxFPN(16, norm=norm, stride_in_1x1=stride_in_1x1, s2d_stem=True,
                policy=JF32)
    params = init_flax(jm, jnp.asarray(x))
    if norm == "frozen_bn":                     # non-trivial affines
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 * rng.standard_normal(v.shape).astype(
                v.dtype) if p[-1].key in ("scale", "bias") else v, params)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = load_flax_params(ResNetFPN(16, norm=norm,
                                    stride_in_1x1=stride_in_1x1), params)
    with torch.no_grad():
        got = tm(T(x))
    for k in want:
        close(got[k], want[k], k)


def test_rpn_head_matches_jax(setup, jax_stages):
    _, _, _, tm, _ = setup
    pyr, lg, dl = jax_stages[:3]
    with torch.no_grad():
        tl, td = tm.rpn([T(p) for p in pyr])
    for i in range(5):
        close(tl[i], lg[i], f"logits {i}")
        close(td[i], dl[i], f"deltas {i}")


def test_box_head_matches_jax(setup, jax_stages):
    """The canvas box head on the reference's pyramid and proposals."""
    *_, tm, _ = setup
    pyr, fwd = jax_stages[0], jax_stages[4]
    with torch.no_grad():
        feat, scores, deltas = tm.box_head([T(p) for p in pyr[:4]],
                                           T(fwd["proposals"]), FPN_SCALES)
    close(feat, fwd["roi_features"], "features")
    close(scores, fwd["cls_scores"], "scores")
    close(deltas, fwd["box_deltas"], "deltas")


@pytest.mark.parametrize("case", ["model", "ties"])
def test_generate_proposals_same_inputs_exact(setup, jax_stages, case):
    """Fed identical logits and deltas, the proposals are the same rows
    in the same order: scores (gathered logits) and valid flags exact,
    boxes equal to float rounding. 'ties' quantises the logits so that
    most of them tie, which exercises the lower-index-first order of
    the top-k and of the NMS sort."""
    _, lg, dl = jax_stages[:3]
    if case == "ties":
        lg = [np.round(x * 2.0) / 2.0 for x in lg]
    anchors = janc.pyramid_anchors(IMG)
    want = jrpn.generate_proposals(
        [jnp.asarray(x) for x in lg], [jnp.asarray(x) for x in dl],
        [jnp.asarray(a) for a in anchors], IMG, 100, 50)
    got = trpn.generate_proposals([T(x) for x in lg], [T(x) for x in dl],
                                  [T(a) for a in anchors], IMG, 100, 50)
    exact(got[2], want[2], "valid")
    exact(got[1], want[1], "scores")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-4)


def _fixed_rcnn(out):
    """A reference FasterRCNN whose forward returns `out`, so that its
    extract/detect selection runs on given inputs."""
    class Fixed(JaxRCNN):
        def __call__(self, images, train=False):
            return jax.tree.map(jnp.asarray, out)
    return Fixed


@pytest.mark.parametrize("select_impl", ["topk", "fused"])
def test_extract_selection_same_inputs_exact(setup, jax_stages,
                                             select_impl):
    """extract's class-wise NMS and top-1 selection from identical
    class scores, deltas and proposals: found, classes and the gathered
    features exact."""
    jcfg, _, _, tm, images = setup
    fwd = dict(jax_stages[4])
    rng = np.random.default_rng(4)                 # sharper class scores
    fwd["cls_scores"] = (fwd["cls_scores"] * 20.0 + rng.standard_normal(
        fwd["cls_scores"].shape)).astype(np.float32)
    fwd["proposal_valid"] = fwd["proposal_valid"].copy()
    fwd["proposal_valid"][:, -5:] = False
    cfg = jcfg.replace(select_impl=select_impl)
    want = _fixed_rcnn(fwd)(cfg, num_classes=K, policy=JF32).apply(
        {"params": {}}, jnp.asarray(images), method="extract")
    tm.cfg = port_det_cfg(cfg)
    try:
        got = tm.select_extract({k: T(v) for k, v in fwd.items()})
    finally:
        tm.cfg = port_det_cfg(jcfg)
    assert np.asarray(want["found"]).any()
    for k in ("found", "classes", "features"):
        exact(got[k], want[k], k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-6)


def test_detect_selection_same_inputs_exact(setup, jax_stages):
    jcfg, _, _, tm, images = setup
    fwd = dict(jax_stages[4])
    fwd["cls_scores"] = (fwd["cls_scores"] * 20.0).astype(np.float32)
    want = _fixed_rcnn(fwd)(jcfg, num_classes=K, policy=JF32).apply(
        {"params": {}}, jnp.asarray(images), method="detect", max_out=7)
    got = tm.select_detect({k: T(v) for k, v in fwd.items()}, max_out=7)
    assert np.asarray(want["valid"]).any()
    for k in ("valid", "classes", "features"):
        exact(got[k], want[k], k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_extract_detect(setup):
    jcfg, jm, params, _, images = setup
    canvas = jroi.multilevel_roi_align_canvas
    jroi.multilevel_roi_align_canvas = functools.partial(canvas,
                                                         interpret=True)
    try:
        ext = jax.jit(lambda p, x: jm.apply(p, x, method="extract"))(
            params, jnp.asarray(images))
        det = jax.jit(lambda p, x: jm.apply(p, x, method="detect",
                                            max_out=K))(
            params, jnp.asarray(images))
    finally:
        jroi.multilevel_roi_align_canvas = canvas
    return jax.tree.map(np.asarray, (ext, det))


def test_extract_matches_jax(setup, jax_extract_detect):
    """The whole detector, images in: found and classes exact, features,
    boxes and scores close."""
    *_, tm, images = setup
    want = jax_extract_detect[0]
    with torch.no_grad():
        got = tm.extract(T(images))
    assert want["found"].any()
    for k in ("found", "classes"):
        exact(got[k], want[k], k)
    for k in ("features", "boxes", "scores"):
        close(got[k], want[k], k, tol=1e-3)


def test_detect_matches_jax(setup, jax_extract_detect):
    *_, tm, images = setup
    want = jax_extract_detect[1]
    with torch.no_grad():
        got = tm.detect(T(images), max_out=K)
    for k in ("valid", "classes"):
        exact(got[k], want[k], k)
    for k in ("features", "boxes", "scores"):
        close(got[k], want[k], k, tol=1e-3)


def test_extract_topk_budget_equals_smaller_post_nms(setup):
    """extract_topk=N pools only the N best proposals: the result is
    the one of post_nms_topk=N (proposals arrive score-sorted)."""
    jcfg, _, params, _, images = setup
    outs = []
    for over in ({"extract_topk": 10}, {"post_nms_topk": 10}):
        m = load_flax_params(FasterRCNN(port_det_cfg(jcfg.replace(**over)),
                                        num_classes=K), params).eval()
        with torch.no_grad():
            outs.append(m.extract(T(images[:1])))
    for k in outs[0]:
        exact(outs[0][k], outs[1][k].numpy(), k)


def test_roi_backends_select_the_kernels(setup, monkeypatch):
    """'auto' resolves to the canvas kernel (K2), 'pallas' to K3, 'xla'
    to the gather form; a batch pools in one wrapper call."""
    import ekaid_torch.models.detector.heads as heads
    jcfg, _, params, _, images = setup
    calls = []
    for name in ("multilevel_roi_align_canvas", "multilevel_roi_align_pallas",
                 "multilevel_roi_align"):
        fn = getattr(heads, name)
        monkeypatch.setattr(heads, name, functools.partial(
            lambda f, n, *a, **kw: calls.append(n) or f(*a, **kw), fn, name))
    for backend in ("auto", "pallas", "xla"):
        m = FasterRCNN(port_det_cfg(jcfg.replace(roi_backend=backend)),
                       num_classes=K)
        assert m.box_head.roi_backend == {"auto": "canvas"}.get(backend,
                                                                backend)
        load_flax_params(m, params)
        with torch.no_grad():
            m(T(images))
    assert calls == ["multilevel_roi_align_canvas",
                     "multilevel_roi_align_pallas",
                     "multilevel_roi_align", "multilevel_roi_align"]
