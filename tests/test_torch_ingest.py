"""ekaid_torch's ingest (`data/images.py`, `data/preprocess.py`) against
the JAX package's on the same files: PNGs pixel-equal, index pickles,
npz arrays and JSON files equal."""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from ekaid_tpu.data import images as jax_images
from ekaid_tpu.data import preprocess as jax_pre
from ekaid_torch.data import images, preprocess
from ekaid_torch.extract.runner import list_images

SIZE = 24
TYPES = ("abnormality", "presence", "view", "location", "level", "type",
         "difference")


def _write(path, rng, shape, mode, ext):
    h, w = shape
    px = rng.integers(0, 256, (h, w, 3) if mode == "RGB" else (h, w),
                      dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(px, mode).save(str(path) + ext)


def make_tree(root, nested: bool):
    """Small grayscale and RGB JPG/PNG files of odd sizes, flat or in
    subdirectories, with names whose sorted order is not os.walk's."""
    rng = np.random.default_rng(0 if nested else 1)
    files = [("s10", (37, 23), "L", ".jpg"), ("s02", (19, 41), "RGB", ".png"),
             ("s07", (29, 29), "RGB", ".jpg"), ("s11", (45, 17), "L", ".png"),
             ("s03", (21, 33), "L", ".jpeg")]
    for i, (stem, shape, mode, ext) in enumerate(files):
        sub = ("z" if i % 2 else "a") if nested and i else ""
        _write(root / sub / stem, rng, shape, mode, ext)
    (root / "notes.txt").write_text("not an image")
    return len(files)


def _convert(mod, src, dst):
    return mod.convert_tree(str(src), str(dst), size=SIZE, workers=3)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("nested", [False, True])
def test_convert_tree_matches_jax(tmp_path, nested):
    """PNGs pixel-equal and both pickles equal; the dicom2id order
    against the extraction runner's row order (the sorted PNG names) is
    pinned: equal for a flat directory, and for nested ones os.walk's
    order, which can differ."""
    n = make_tree(tmp_path / "in", nested)
    assert _convert(images, tmp_path / "in", tmp_path / "port") == n
    assert _convert(jax_images, tmp_path / "in", tmp_path / "jax") == n
    pngs = list_images(str(tmp_path / "port"))
    assert pngs == list_images(str(tmp_path / "jax")) and len(pngs) == n
    for name in pngs:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == (SIZE, SIZE) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for pkl in ("mimic_shape_full.pkl", "dicom2id.pkl"):
        assert _load(tmp_path / "port" / pkl) == _load(tmp_path / "jax" / pkl)
    shapes = _load(tmp_path / "port" / "mimic_shape_full.pkl")
    assert {s["image"]: s["shape"] for s in shapes}["s10"] == (37, 23)
    dicom2id = _load(tmp_path / "port" / "dicom2id.pkl")
    rows = {os.path.splitext(f)[0]: i for i, f in enumerate(pngs)}
    walk = [s["image"] for s in shapes]
    assert [dicom2id[s] for s in walk] == list(range(n))
    if nested:
        # the root's files first, then each subdirectory's, in the
        # order the file system lists the subdirectories
        assert walk[0] == "s10" and sorted(walk[1:3]) in (
            ["s02", "s11"], ["s03", "s07"])
        assert walk == [os.path.splitext(f)[0]
                        for r, _, fs in os.walk(tmp_path / "in")
                        for f in sorted(fs) if not f.endswith(".txt")]
        assert dicom2id["s10"] == 0 and rows["s10"] == 3
    else:
        assert dicom2id == rows


def test_convert_cli_and_limit(tmp_path, capsys):
    make_tree(tmp_path / "in", nested=False)
    images.main(["-p", str(tmp_path / "in"), "-o", str(tmp_path / "out"),
                 "--size", "16", "--workers", "2", "--limit", "3"])
    assert "converted 3 images" in capsys.readouterr().out
    assert len(list_images(str(tmp_path / "out"))) == 3
    img = Image.open(tmp_path / "out" / "s02.png")
    assert img.size == (16, 16) and img.mode == "L"


def test_dicom_needs_pydicom(tmp_path):
    """The reference's refusal without pydicom, for read_xray and for a
    .dcm in the tree."""
    try:
        import pydicom  # noqa: F401
        pytest.skip("pydicom is installed")
    except ImportError:
        pass
    path = tmp_path / "in" / "x.dcm"
    path.parent.mkdir()
    path.write_bytes(b"\0" * 16)
    for mod in (images, jax_images):
        with pytest.raises(ImportError, match="pydicom is not installed"):
            mod.read_xray(str(path))
    with pytest.raises(ImportError, match="pydicom is not installed"):
        _convert(images, tmp_path / "in", tmp_path / "out")


def make_csv(path, n=23, seed=0):
    """A question CSV over the seven question types."""
    rng = np.random.default_rng(seed)
    words = ["left", "right", "lung", "effusion", "edema", "pleural",
             "opacity", "no", "mild", "severe", "heart", "size"]
    rows = []
    for i in range(n):
        t = TYPES[i % len(TYPES)]
        picks = rng.choice(words, size=int(rng.integers(1, 6)))
        if t == "difference":
            q = "what has changed compared to the reference image?"
            a = "the main image has additional findings of " + \
                ", ".join(picks) + "."
        else:
            q = f"is there {picks[0]} in the {t}?"
            a = "yes" if i % 3 else " ".join(picks)
        rows.append({"question": q, "answer": a, "question_type": t,
                     "study_id": 100 + i, "ref_id": 200 + i})
    pd.DataFrame(rows).to_csv(path, index=False)
    return rows


def _same_outputs(got: dict, want: dict):
    assert got.keys() == want.keys()
    a, b = np.load(got["npz"]), np.load(want["npz"])
    assert sorted(a.files) == sorted(b.files) == [
        "answers", "feature_idx", "pos", "questions"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in got:
        if k != "npz":
            with open(got[k]) as f, open(want[k]) as g:
                assert json.load(f) == json.load(g), k
            with open(got[k], "rb") as f, open(want[k], "rb") as g:
                assert f.read() == g.read(), k
    return a


@pytest.mark.parametrize("case", ["fresh", "mapped", "vocab",
                                  "difference_only"])
def test_transform_questions_matches_jax(tmp_path, case):
    """Every npz array and every JSON equal to the reference's: with a
    fresh vocab, with dicom2id/study2dicom, with an existing vocab that
    lacks words, and difference questions only."""
    csv = tmp_path / "q.csv"
    rows = make_csv(csv)
    kw = {}
    if case == "mapped":
        d2i = {f"d{k}": 40 - k for k in range(40)}
        s2d = {r[c]: f"d{(r[c] * 7) % 40}" for r in rows
               for c in ("study_id", "ref_id")}
        for name, obj in (("dicom2id", d2i), ("study2dicom", s2d)):
            with open(tmp_path / f"{name}.pkl", "wb") as f:
                pickle.dump(obj, f)
            kw[f"{name}_pkl"] = str(tmp_path / f"{name}.pkl")
    elif case == "vocab":
        with open(tmp_path / "vocab.json", "w") as f:
            json.dump({"<start>": 1, "yes": 2, "lung": 3, "?": 4}, f)
        kw["vocab_path"] = str(tmp_path / "vocab.json")
    elif case == "difference_only":
        kw["difference_only"] = True
    got = preprocess.transform_questions(str(csv), str(tmp_path / "port"),
                                         **kw)
    want = jax_pre.transform_questions(str(csv), str(tmp_path / "jax"),
                                       **kw)
    data = _same_outputs(got, want)
    n = len(rows) if case != "difference_only" else sum(
        r["question_type"] == "difference" for r in rows)
    assert data["questions"].shape == (n, 20)
    assert (data["answers"][:, 0] == 1).all()
    if case == "mapped":
        assert data["feature_idx"][0].tolist() == [40 - 700 % 40, 40 - 1400 % 40]
    else:
        np.testing.assert_array_equal(
            data["feature_idx"], np.arange(2 * n).reshape(n, 2))
    with open(got["vocab"]) as f:
        vocab = json.load(f)
    if case == "vocab":
        assert list(vocab.items())[:4] == [("<start>", 1), ("yes", 2),
                                           ("lung", 3), ("?", 4)]
    assert sorted(vocab.values()) == list(range(1, len(vocab) + 1))
    with open(got["gt_test"]) as f:
        gt = json.load(f)
    assert {a["question_type"] for a in gt["annotations"]} <= set(TYPES)
    with open(got["splits"]) as f:
        splits = json.load(f)
    assert [len(splits[s]) for s in ("train", "val", "test")] == [
        int(np.ceil(0.8 * n)), int(np.ceil(0.9 * n)) - int(np.ceil(0.8 * n)),
        n - int(np.ceil(0.9 * n))]
