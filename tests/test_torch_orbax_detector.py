"""ekaid_torch.utils.orbax_import on a detector checkpoint: the params
that the reference's train_detector.py saves with orbax, converted to a
state dict and run through the extraction runner's loader, against the
JAX detector on the same images."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import torch

import ekaid_tpu.ops.pallas_roi as jroi
from _torch_port import init_flax
from ekaid_tpu.config import default_config
from ekaid_tpu.models.detector import FasterRCNN as JaxRCNN
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import load_config
from ekaid_torch.convert import flatten
from ekaid_torch.extract import runner
from ekaid_torch.utils import orbax_import as oi


def test_detector_checkpoint_extracts_as_jax(tmp_path):
    """The 256^2 narrow detector of test_torch_detector.py, saved as
    train_detector.py saves its params, converted, and run through the
    extraction runner's loader: extract outputs equal to JAX's to the
    1e-3 x max bar of test_extract_matches_jax."""
    img, k = 256, 5
    jcfg = default_config().detector.replace(
        image_size=img, pre_nms_topk=100, post_nms_topk=50, roi_feat_dim=64,
        fpn_channels=32, roi_backend="canvas", num_anatomy_classes=k,
        num_disease_classes=k)
    images = np.random.default_rng(0).standard_normal(
        (2, img, img, 3)).astype(np.float32)
    jm = JaxRCNN(jcfg, num_classes=k, policy=JF32)
    params = jax.tree.map(jnp.asarray,
                          init_flax(jm, jnp.asarray(images[:1])))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "det"), params)
    ckptr.wait_until_finished()
    canvas = jroi.multilevel_roi_align_canvas
    jroi.multilevel_roi_align_canvas = functools.partial(canvas,
                                                         interpret=True)
    try:
        want = jax.tree.map(np.asarray, jax.jit(
            lambda p, x: jm.apply(p, x, method="extract"))(
                params, jnp.asarray(images)))
    finally:
        jroi.multilevel_roi_align_canvas = canvas
    oi.main(["detector", str(tmp_path / "det"), str(tmp_path / "det.pt")])
    sd = oi.load_detector(str(tmp_path / "det.pt"))
    leaves = flatten(jax.tree.map(np.asarray, params)["params"])
    assert sorted(sd) == sorted(leaves)
    for name, v in leaves.items():                     # HWIO -> OIHW
        np.testing.assert_array_equal(
            sd[name].numpy(), v.transpose(3, 2, 0, 1) if v.ndim == 4 else v,
            name)
    pcfg = load_config(overrides={"detector": dataclasses.asdict(jcfg),
                                  "dtypes": {"compute_dtype": "float32"}})
    ana, _ = runner.build_detectors(pcfg, ana_params=sd, dis_params=sd,
                                    device="cpu")
    with torch.no_grad():
        got = ana.extract(torch.as_tensor(images))
    for key in ("found", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for key in ("features", "boxes", "scores"):
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key].float().numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=key)
