"""The detector's data and evaluation in the port (ekaid_torch/data/
detection.py, metrics/detection.py, the dataset, augmentation and
batches of train/train_detector.py) against the JAX package's: numpy on
both sides, so everything is bit-equal, given the same seeds and files.
"""

import json
import pickle

import numpy as np
import pandas as pd
import pytest

import ekaid_tpu.data.detection as jdata
import ekaid_tpu.metrics.detection as jmet
import ekaid_tpu.train.train_detector as jtd
import ekaid_torch.data.detection as tdata
import ekaid_torch.metrics.detection as tmet
import ekaid_torch.train.train_detector as ttd


def same(a, b):
    """Nested tuples/lists/dicts of arrays and scalars, equal and of the
    same dtype."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("n,size,k,seed", [(6, 64, 3, 0), (3, 96, 22, 5)])
def test_synthetic_blob_dataset_bit_equal(n, size, k, seed):
    same(ttd.synthetic_blob_dataset(n, size, k, seed=seed),
         jtd.synthetic_blob_dataset(n, size, k, seed=seed))


def test_affine_warp_bit_equal():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((48, 48, 3)).astype(np.float32)
    boxes = np.array([[4, 5, 20, 30], [0, 0, 48, 48]], np.float32)
    for args in ((7.5, 1.1, 2.0, -3.0), (-10.0, 0.85, -1.5, 0.5),
                 (0.0, 1.0, 0.0, 0.0)):
        same(ttd.affine_warp(img, boxes, *args, image_size=48),
             jtd.affine_warp(img, boxes, *args, image_size=48))


@pytest.mark.parametrize("shuffle", [False, True])
def test_augmented_batches_bit_equal(shuffle):
    arrays = jtd.synthetic_blob_dataset(10, 64, 4, seed=2)

    def run(mod):
        aug = (lambda im, bx, r: mod.augment(im, bx, r, 64))
        return list(mod.batches(arrays, 4, shuffle=shuffle, seed=3,
                                augment_fn=aug))

    got, want = run(ttd), run(jtd)
    assert len(got) == 2
    same(got, want)
    plain = list(ttd.batches(arrays, 4, shuffle=shuffle, seed=3))
    same(plain, list(jtd.batches(arrays, 4, shuffle=shuffle, seed=3)))


def test_augment_draws_every_transform():
    """Over a batch of 16 the flips, warps and brightness draws all
    happen, and the output stays bit-equal."""
    images, boxes, _, _ = jtd.synthetic_blob_dataset(16, 32, 3, seed=4)
    got = ttd.augment(images, boxes, np.random.default_rng(9), 32)
    want = jtd.augment(images, boxes, np.random.default_rng(9), 32)
    same(got, want)
    changed = [not np.array_equal(got[0][i], images[i]) for i in range(16)]
    assert sum(changed) >= 8


# ---- annotation loaders, on the files tests/test_detection_data.py
# writes --------------------------------------------------------------------

def test_anatomy_detector_classes():
    assert tdata.ANATOMY_DETECTOR_CLASSES == jdata.ANATOMY_DETECTOR_CLASSES
    assert len(tdata.ANATOMY_DETECTOR_CLASSES) == 26


def test_load_imagenome_gold(tmp_path):
    df = pd.DataFrame({
        "image_id": ["a.dcm", "a.dcm", "b.dcm", "b.dcm", "c.dcm"],
        "bbox_name": ["right lung", "left lung", "trachea", "bogus",
                      "trachea"],
        "original_x1": [10, 20, 30, 1, np.nan],
        "original_y1": [10, 20, 30, 1, 4],
        "original_x2": [100, 200, 300, 2, 5],
        "original_y2": [100, 200, 300, 2, 6],
    })
    p = tmp_path / "gold.csv"
    df.to_csv(p, index=False)
    kw = dict(shapes={"a": (2048, 2048)}, image_size=1024, max_gt=4)
    same(tdata.load_imagenome_gold(str(p), **kw),
         jdata.load_imagenome_gold(str(p), **kw))


def test_load_vindr(tmp_path):
    df = pd.DataFrame({
        "image_id": ["x", "x", "y", "z"],
        "class_name": ["Cardiomegaly", "No finding", "Pleural effusion",
                       "Cardiomegaly"],
        "x_min": [100.0, np.nan, 50.0, 300.0],
        "y_min": [100.0, np.nan, 50.0, 10.0],
        "x_max": [400.0, np.nan, 300.0, 200.0],     # inverted: dropped
        "y_max": [400.0, np.nan, 300.0, 20.0],
    })
    p = tmp_path / "vindr.csv"
    df.to_csv(p, index=False)
    same(tdata.load_vindr(str(p), max_gt=4),
         jdata.load_vindr(str(p), max_gt=4))


def test_load_imagenome_silver_and_shapes(tmp_path):
    sg = {"image_id": "img1",
          "objects": [
              {"name": "right lung", "x1": 50, "y1": 30, "x2": 120,
               "y2": 100},
              {"name": "not a class", "x1": 1, "y1": 1, "x2": 2, "y2": 2},
          ]}
    (tmp_path / "img1_SceneGraph.json").write_text(json.dumps(sg))
    (tmp_path / "mystery_SceneGraph.json").write_text(
        json.dumps({"image_id": "mystery", "objects": []}))
    kw = dict(shapes={"img1": (2000, 1500)}, image_size=1024, max_gt=4)
    same(tdata.load_imagenome_silver(str(tmp_path), **kw),
         jdata.load_imagenome_silver(str(tmp_path), **kw))
    ours = [{"image": "a", "shape": (100, 200)}]
    ref = [{"image": "b", "height": 300, "width": 400}]
    for items in (ours, ref):
        p = tmp_path / "shapes.pkl"
        p.write_bytes(pickle.dumps(items))
        assert tdata.load_shapes(str(p)) == jdata.load_shapes(str(p))


def test_image_box_dataset_reads_pngs(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    for name, size in (("a", 32), ("b", 40)):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)
                        ).save(tmp_path / f"{name}.png")
    boxes = np.zeros((2, 1, 4), np.float32)
    args = (["a", "b"], boxes, np.zeros((2, 1), np.int32),
            np.ones((2, 1), bool), str(tmp_path), 32)
    same(tdata.ImageBoxDataset(*args).materialize(),
         jdata.ImageBoxDataset(*args).materialize())


# ---- evaluation --------------------------------------------------------

def random_dets(rng, n_images, k, m=12, g=5):
    out = []
    for _ in range(n_images):
        gb = rng.uniform(0, 80, (g, 2))
        gb = np.concatenate([gb, gb + rng.uniform(5, 40, (g, 2))], 1)
        pb = gb[rng.integers(0, g, m)] + rng.normal(0, 4, (m, 4))
        out.append(dict(
            pred_boxes=pb.astype(np.float32),
            pred_classes=rng.integers(0, k + 1, m).astype(np.int32),
            pred_scores=np.round(rng.random(m), 2).astype(np.float32),
            pred_valid=rng.random(m) < 0.85,
            gt_boxes=gb.astype(np.float32),
            gt_classes=rng.integers(0, k, g).astype(np.int32),
            gt_valid=rng.random(g) < 0.8))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_evaluator_equals_reference(seed):
    rng = np.random.default_rng(seed)
    dets = random_dets(rng, 6, 4)
    evs = [tmet.DetectionEvaluator(4), jmet.DetectionEvaluator(4)]
    for d in dets:
        for ev in evs:
            ev.add_image(**d)
    got, want = (ev.summarize() for ev in evs)
    same(got, want)
    assert got["AP50"] > 0
    args = ([d["pred_boxes"] for d in dets], [d["pred_scores"] for d in dets],
            [d["pred_valid"] for d in dets], [d["gt_boxes"] for d in dets],
            [d["gt_valid"] for d in dets])
    same(tmet.proposal_recall(*args), jmet.proposal_recall(*args))
    same(tmet.proposal_recall(*args, limits=(3,)),
         jmet.proposal_recall(*args, limits=(3,)))


def test_average_precision_and_iou_equal_reference():
    rng = np.random.default_rng(3)
    scores = np.round(rng.random(30), 1)
    matched = rng.random(30) < 0.5
    for num_gt in (0, 5, 40):
        same(tmet.average_precision(scores, matched, num_gt),
             jmet.average_precision(scores, matched, num_gt))
    same(tmet.average_precision([], [], 3), jmet.average_precision([], [], 3))
    a, b = random_dets(rng, 1, 2)[0]["pred_boxes"], \
        random_dets(rng, 1, 2)[0]["gt_boxes"]
    same(tmet._iou_matrix(a, b), jmet._iou_matrix(a, b))
    same(tmet._iou_matrix(a[:0], b), jmet._iou_matrix(a[:0], b))
