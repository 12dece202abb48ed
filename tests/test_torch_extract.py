"""Parity of the port's extraction path (ekaid_torch/extract/,
ekaid_torch/data/knowledge.py) with the JAX package, on the CPU.

Host functions get the same numpy inputs and must give equal outputs.
`Extractor.process_batch` runs both packages' detectors (f32, 256^2,
batch 2, the canvas ROIAlign; the JAX one in interpret mode) with the
same weights: the graph records must agree exactly on labels and both
adjacencies, and on features and boxes to allclose at rtol 1e-3 and
atol 1e-3 x max|ref| (the detector's own images-in tolerance, see
tests/test_torch_detector.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_tpu.data.knowledge as jk
import ekaid_tpu.extract.pipeline as jpipe
import ekaid_tpu.extract.runner as jrunner
import ekaid_tpu.ops.pallas_roi as jroi
from ekaid_tpu.config import default_config
from ekaid_tpu.models.detector import FasterRCNN as JaxRCNN
from ekaid_tpu.utils.dtypes import F32 as JF32
import ekaid_torch.data.knowledge as tk
import ekaid_torch.extract.pipeline as tpipe
import ekaid_torch.extract.runner as trunner
from ekaid_torch.config import load_config
from tests._torch_port import init_flax

IMG, B, K_ANA, K_DIS = 256, 2, 5, 4


def boxes(rng, n, size=600.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(5, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_knowledge_tables_match_jax():
    counts = np.random.default_rng(0).uniform(1, 9, (14, 14))
    counts = counts + counts.T
    for kw in ({}, {"counting_adj": counts}):
        for a, b in zip(tk.semantic_tables(**kw), jk.semantic_tables(**kw)):
            np.testing.assert_array_equal(a, b)
    assert tk.COMBINED_CLASSES == jk.COMBINED_CLASSES


@pytest.mark.parametrize("seed", range(3))
def test_iou_and_disease_matching_match_jax(seed):
    rng = np.random.default_rng(seed)
    ana, dis = boxes(rng, 26), boxes(rng, 26)
    dis[:3] = ana[:3]                            # exact overlaps
    np.testing.assert_array_equal(tpipe.iou_plus_one_matrix(dis, ana),
                                  jpipe.iou_plus_one_matrix(dis, ana))
    assert tpipe.iou_plus_one(dis[0], ana[1]) == \
        jpipe.iou_plus_one(dis[0], ana[1])
    feats = rng.standard_normal((26, 8)).astype(np.float32)
    classes = rng.integers(0, 22, 26)
    valid = rng.uniform(size=26) > 0.3
    got = tpipe.match_disease_to_anatomy(dis, feats, classes, valid, ana, 22)
    want = jpipe.match_disease_to_anatomy(dis, feats, classes, valid, ana,
                                          22)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_combine_pair_matches_jax(seed):
    rng = np.random.default_rng(seed)
    found = rng.uniform(size=26) > 0.2
    ana = {"features": rng.standard_normal((26, 8)).astype(np.float32),
           "boxes": np.where(found[:, None], boxes(rng, 26, 1024.0), 0),
           "classes": np.where(found, np.arange(26), 26), "found": found}
    dis = {"features": rng.standard_normal((26, 8)).astype(np.float32),
           "classes": np.where(rng.uniform(size=26) > 0.5,
                               rng.integers(0, 22, 26), 22)}
    counts = rng.uniform(1, 9, (14, 14))
    tables = jk.semantic_tables(counting_adj=counts + counts.T)
    got = tpipe.combine_pair(ana, dis, *tables)
    want = jpipe.combine_pair(ana, dis, *tables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _records(rng, n, nodes=10, feat=16):
    return [{"image_features": rng.standard_normal(
                (nodes, feat)).astype(np.float32),
             "image_bb": boxes(rng, nodes),
             "image_adj_matrix": rng.integers(0, 12, (100, 100)),
             "semantic_adj_matrix": rng.integers(0, 3, (100, 100)),
             "bbox_label": rng.integers(0, 50, nodes)} for _ in range(n)]


def test_h5_writer_round_trip_and_resume(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    path = str(tmp_path / "graph.h5")
    recs = _records(rng, 5)
    w = tpipe.H5Writer(path, num_nodes=10, feat_dim=16, run_meta={"a": 1})
    w.append(recs[:3])
    w.close()
    w = tpipe.H5Writer(path, num_nodes=10, feat_dim=16, mode="a",
                       run_meta={"a": 1})
    assert w.n == 3
    w.append(recs[3:])
    w.close()
    with h5py.File(path, "r") as f:
        assert f.attrs["committed_rows"] == 5
        for k in recs[0]:
            np.testing.assert_array_equal(f[k][:], np.stack(
                [r[k] for r in recs]), err_msg=k)
    with pytest.raises(ValueError, match="run mismatch"):
        tpipe.H5Writer(path, num_nodes=10, feat_dim=16, mode="a",
                       run_meta={"a": 2})


class _ListWriter:
    def __init__(self):
        self.records, self.closed = [], False

    def append(self, records):
        self.records.extend(records)

    def close(self):
        self.closed = True


def test_extractor_pipelined_run_matches_serial():
    """run()'s one-deep pipeline writes the records of the serial
    process_batch loop, in order; detector outputs may be tensors."""
    from tests.test_extract import _fake_applies
    fa, fd = _fake_applies()

    def tensors(fn):
        return lambda x: {k: torch.as_tensor(v) for k, v in fn(x).items()}

    ex = tpipe.Extractor(tensors(fa), tensors(fd), num_disease_classes=22)
    batches = [np.full((2, 4, 4, 3), i, np.float32) for i in range(3)]
    w = _ListWriter()
    assert ex.run(iter(batches), w, log_every=2) == 6 and w.closed
    serial = [r for b in batches for r in ex.process_batch(b)]
    want = [r for b in batches for r in jpipe.Extractor(
        fa, fd, num_disease_classes=22).process_batch(b)]
    for got, ser, ref in zip(w.records, serial, want):
        for k in ref:
            np.testing.assert_array_equal(got[k], ser[k], err_msg=k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_synthetic_batches_and_preprocess():
    got = list(trunner.synthetic_batches(4, 32, 2))
    want = list(jrunner.synthetic_batches(4, 32, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    u8 = list(trunner.synthetic_batches(4, 32, 2, dtype="uint8"))
    assert len(u8) == 2 and u8[0].dtype == np.uint8 and u8[0].max() > 200
    det = load_config().detector
    x = trunner.preprocess(u8[0], det, "cpu")
    np.testing.assert_allclose(x.numpy(), u8[0] / np.float32(255.0),
                               rtol=1e-6)
    d2 = det.replace(preprocess="detectron2")
    want = (u8[0][..., ::-1].astype(np.float32) / 255.0 * 255.0
            - np.asarray(d2.pixel_mean, np.float32)) / np.asarray(
                d2.pixel_std, np.float32)
    np.testing.assert_allclose(trunner.preprocess(u8[0], d2, "cpu").numpy(),
                               want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("workers", [1, 3])
def test_png_batches_match_jax(tmp_path, workers):
    """PNG input: resized, in file order, the tail batch zero-padded;
    the same arrays as the reference's loader."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(tmp_path / f"img{i}.png")
    got = list(trunner.png_batches(str(tmp_path), 32, 2, workers=workers,
                                   skip=2))
    want = list(jrunner.png_batches(str(tmp_path), 32, 2, workers=workers,
                                    skip=2))
    assert len(got) == 2 and got[0].shape == (2, 32, 32, 3)
    assert (got[1][1] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _small_detector():
    return default_config().detector.replace(
        image_size=IMG, pre_nms_topk=100, post_nms_topk=50, roi_feat_dim=64,
        fpn_channels=32, roi_backend="canvas", num_anatomy_classes=K_ANA,
        num_disease_classes=K_DIS, extract_batch_size=B)


def test_extractor_process_batch_matches_jax(monkeypatch):
    """The slice as a whole: images -> both detectors -> 52-node records
    (here 2 x 5 nodes), against the JAX Extractor with the same weights."""
    jdet = _small_detector()
    images = next(jrunner.synthetic_batches(B, IMG, B))
    jana = JaxRCNN(jdet, num_classes=K_ANA, policy=JF32)
    jdis = JaxRCNN(jdet, num_classes=K_DIS, policy=JF32)
    pa = init_flax(jana, jnp.asarray(images[:1]), seed=0)
    pd = init_flax(jdis, jnp.asarray(images[:1]), seed=2)
    monkeypatch.setattr(jroi, "multilevel_roi_align_canvas",
                        functools.partial(jroi.multilevel_roi_align_canvas,
                                          interpret=True))
    jex = jpipe.Extractor(
        jax.jit(lambda x: jana.apply(pa, x, method="extract")),
        jax.jit(lambda x: jdis.apply(pd, x, method="detect",
                                     max_out=K_ANA)), K_DIS)
    want = jex.process_batch(jnp.asarray(images))

    cfg = load_config(overrides={"detector": dataclasses.asdict(jdet),
                                 "dtypes": {"compute_dtype": "float32"}})
    ana_apply, dis_apply = trunner.build_detector_fns(cfg, pa, pd,
                                                      device="cpu")
    got = tpipe.Extractor(ana_apply, dis_apply, K_DIS).process_batch(images)
    assert len(got) == len(want) == B
    for g, w in zip(got, want):
        assert (w["bbox_label"][:K_ANA] < jk.NUM_CLASSES).any()
        for k in ("bbox_label", "image_adj_matrix", "semantic_adj_matrix"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("image_features", "image_bb"):
            np.testing.assert_allclose(
                g[k], w[k], rtol=1e-3, atol=1e-3 * np.abs(w[k]).max(),
                err_msg=k)


def test_runner_cli_synthetic_cpu(tmp_path):
    """`--synthetic --device cpu` writes one record per image."""
    h5py = pytest.importorskip("h5py")
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(
        "dtypes:\n  compute_dtype: float32\n"
        "detector:\n  fpn_channels: 32\n  roi_feat_dim: 64\n"
        "  pre_nms_topk: 100\n  post_nms_topk: 50\n")
    out = tmp_path / "graph.h5"
    trunner.main(["--cfg", str(cfg_path), "--synthetic", "2",
                  "--batch_size", "2", "--image_size", str(IMG),
                  "--allow_random", "--device", "cpu", "--out", str(out)])
    with h5py.File(out, "r") as f:
        assert f["image_features"].shape == (2, 52, 64)
        assert f["image_adj_matrix"].shape == (2, 100, 100)
        assert f["bbox_label"].shape == (2, 52)
        assert np.isfinite(f["image_features"][:]).all()


@pytest.mark.parametrize("argv,msg", [
    # more replicas than visible devices (the CPU is one)
    (["--synthetic", "2", "--allow_random", "--dp", "2", "--device", "cpu"],
     "--dp 2: only 1 device"),
    (["--synthetic", "2", "--ana_ckpt", "x"], "orbax"),
    (["--synthetic", "2"], "--allow_random"),
])
def test_runner_refuses_unported_options(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        trunner.main(argv)


def test_runner_defaults_to_cuda():
    """Without a card the default device raises instead of falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.build_detector_fns(load_config())
