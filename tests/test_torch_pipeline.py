"""ekaid_torch's stage pipeline (`tools/pipeline.py`) against the JAX
package's: the stage entry points of both packages are replaced by
recorders, and the arguments `run_pipeline` hands each stage must be
equal, up to the detector checkpoints' `.pt` names and the port's
`--device`. Then one real CPU run of the convert and preprocess
stages."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import ekaid_tpu.data.images as j_images
import ekaid_tpu.data.preprocess as j_pre
import ekaid_tpu.extract.runner as j_runner
import ekaid_tpu.train.test as j_test
import ekaid_tpu.train.train as j_train
import ekaid_tpu.train.train_detector as j_det
from ekaid_tpu.tools import pipeline as jax_pipeline
import ekaid_torch.data.images as t_images
import ekaid_torch.data.preprocess as t_pre
import ekaid_torch.extract.runner as t_runner
import ekaid_torch.train.test as t_test
import ekaid_torch.train.train as t_train
import ekaid_torch.train.train_detector as t_det
from ekaid_torch.tools import pipeline

from test_torch_ingest import make_csv


class Recorder:
    """Stand-ins for the six stage entry points: each records its call
    and creates the artifact the next run's skip rule looks for."""

    def __init__(self, root):
        self.root = str(root)
        self.calls = []

    def _norm(self, args):
        out = [str(a).replace(self.root, "<root>").replace(".pt", "")
               for a in args]
        if out[-2:] == ["--device", "cpu"]:
            out = out[:-2]
        return out

    def _touch(self, path, directory=False):
        if directory:
            os.makedirs(path, exist_ok=True)
        else:
            open(path, "w").close()

    def convert_tree(self, in_dir, out_dir, *a, **k):
        self.calls.append(("convert", self._norm([in_dir, out_dir])))
        self._touch(out_dir, directory=True)
        return 0

    def detector(self, argv):
        self.calls.append(("detector", self._norm(argv)))
        out = argv[argv.index("--ckpt_out") + 1]
        self._touch(out, directory=not out.endswith(".pt"))

    def runner(self, argv):
        self.calls.append(("extract", self._norm(argv)))
        self._touch(argv[argv.index("--out") + 1])

    def transform_questions(self, csv, root, *a, **k):
        self.calls.append(("preprocess", self._norm([csv, root])))
        self._touch(os.path.join(root, "vqa_dataset.npz"))
        return {}

    def train(self, argv):
        self.calls.append(("train", self._norm(argv)))

    def test(self, argv):
        self.calls.append(("test", self._norm(argv)))


def _patch(monkeypatch, rec, mods):
    images, det, runner, pre, train, test = mods
    monkeypatch.setattr(images, "convert_tree", rec.convert_tree)
    monkeypatch.setattr(det, "main", rec.detector)
    monkeypatch.setattr(runner, "main", rec.runner)
    monkeypatch.setattr(pre, "transform_questions", rec.transform_questions)
    monkeypatch.setattr(train, "main", rec.train)
    monkeypatch.setattr(test, "main", rec.test)


def run_both(tmp_path, monkeypatch, argv, runs=1):
    """The stages' calls of each package's pipeline, normalised."""
    out = []
    for name, mod, mods, extra in (
            ("jax", jax_pipeline,
             (j_images, j_det, j_runner, j_pre, j_train, j_test), []),
            ("port", pipeline,
             (t_images, t_det, t_runner, t_pre, t_train, t_test),
             ["--device", "cpu"])):
        root = tmp_path / name
        rec = Recorder(root)
        with monkeypatch.context() as m:
            _patch(m, rec, mods)
            for r in range(runs):
                mod.main(["--data_root", str(root)] + argv[r] + extra)
        out.append(rec.calls)
    return out


FLAGS = {
    "synthetic": ["--stage", "all", "--synthetic", "16", "--image_size",
                  "1024", "--detector_steps", "4", "--train_iters", "8"],
    "gold": ["--stage", "all", "--image_dir", "/data/jpgs",
             "--question_csv", "/data/q.csv", "--gold_csv", "/data/gold.csv",
             "--cfg", "/data/c.yaml", "--image_size", "512",
             "--train_iters", "3"],
    "scene_graph_vindr_init": [
        "--stage", "detector", "--scene_graph_dir", "/data/sg",
        "--shapes_pkl", "/data/shapes.pkl", "--vindr_csv", "/data/v.csv",
        "--detector_init", "/data/d2.pt", "--detector_steps", "7"],
    "scene_graph_default_shapes": [
        "--stage", "detector", "--scene_graph_dir", "/data/sg"],
    "extract_only": ["--stage", "extract", "--image_dir", "/data/jpgs"],
    "preprocess_only": ["--stage", "preprocess", "--question_csv", "q.csv"],
    "test_only": ["--stage", "test", "--cfg", "c.yaml"],
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_stage_arguments_match_jax(tmp_path, monkeypatch, case):
    jax_calls, port_calls = run_both(tmp_path, monkeypatch, [FLAGS[case]])
    assert port_calls == jax_calls
    assert port_calls


def test_skips_and_force_match_jax(tmp_path, monkeypatch, capsys):
    """A second run skips every stage whose artifact exists (train and
    test always run); --force runs them all again."""
    argv = ["--stage", "all", "--image_dir", "/d", "--question_csv", "q",
            "--synthetic", "8", "--train_iters", "2"]
    jax_calls, port_calls = run_both(
        tmp_path, monkeypatch, [argv, argv, argv + ["--force"]], runs=3)
    assert port_calls == jax_calls
    stages = [s for s, _ in port_calls]
    assert stages == (["convert", "detector", "detector", "extract",
                       "preprocess", "train", "test", "train", "test"]
                      + ["convert", "detector", "detector", "extract",
                         "preprocess", "train", "test"])
    out = capsys.readouterr().out
    for s in ("convert", "detector", "extract", "preprocess"):
        assert out.count(f"[{s}] skipped (exists)") == 2     # both packages


def test_port_passes_the_device_and_pt_paths(tmp_path, monkeypatch):
    rec = Recorder(tmp_path)
    _patch(monkeypatch, rec, (t_images, t_det, t_runner, t_pre, t_train,
                              t_test))
    seen = []
    monkeypatch.setattr(t_runner, "main", lambda argv: seen.append(argv))
    monkeypatch.setattr(t_det, "main", lambda argv: (
        seen.append(argv), open(argv[argv.index("--ckpt_out") + 1],
                                "w").close()))
    pipeline.main(["--data_root", str(tmp_path), "--synthetic", "4",
                   "--stage", "all", "--device", "cpu"])
    for argv in seen:
        assert argv[-2:] == ["--device", "cpu"]
    assert seen[0][seen[0].index("--ckpt_out") + 1].endswith(
        "ckpt_anatomy.pt")
    assert seen[2][seen[2].index("--ana_ckpt") + 1].endswith(
        "ckpt_anatomy.pt")
    assert "--dis_ckpt" in seen[2]


def test_real_data_needs_labels_and_cuda_default(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="gold_csv"):
        pipeline.main(["--data_root", str(tmp_path), "--stage", "detector",
                       "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.main(["--data_root", str(tmp_path), "--stage",
                           "convert"])


def test_convert_and_preprocess_run_on_the_cpu(tmp_path):
    """The real host stages: PNGs + index pickles, then the packed QA
    dataset with self-indexed rows, equal to the reference pipeline's."""
    rng = np.random.default_rng(0)
    src = tmp_path / "xrays"
    src.mkdir()
    for i in range(6):
        px = rng.integers(0, 256, (30 + i, 41 - i), dtype=np.uint8)
        Image.fromarray(px).save(src / f"img{i:02d}.jpg")
    make_csv(tmp_path / "q.csv", n=3)
    for name, mod, extra in (("port", pipeline, ["--device", "cpu"]),
                             ("jax", jax_pipeline, [])):
        root = tmp_path / name
        for stage in ("convert", "preprocess"):
            mod.main(["--data_root", str(root), "--stage", stage,
                      "--image_dir", str(src), "--question_csv",
                      str(tmp_path / "q.csv")] + extra)
    port, ref = tmp_path / "port", tmp_path / "jax"
    pngs = sorted(os.listdir(port / "pngs"))
    assert pngs == sorted(os.listdir(ref / "pngs"))
    assert len([p for p in pngs if p.endswith(".png")]) == 6
    for p in pngs:
        if p.endswith(".png"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(port / "pngs" / p)),
                np.asarray(Image.open(ref / "pngs" / p)))
    a, b = np.load(port / "vqa_dataset.npz"), np.load(ref / "vqa_dataset.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["feature_idx"],
                                  [[0, 1], [2, 3], [4, 5]])
    for f in ("vocab_mimic_VQA.json", "splits_mimic_VQA.json",
              "mimic_gt_captions_test.json"):
        assert json.loads((port / f).read_text()) == \
            json.loads((ref / f).read_text())


def test_extract_after_detector_init_gets_no_norm(tmp_path, monkeypatch):
    """Pinned behaviour of the reference's pipeline: --detector_init
    trains the anatomy detector with frozen_bn and stride_in_1x1, but
    the extract stage passes neither, so the runner builds GroupNorm
    detectors (whose parameters have the same names and shapes) for
    those weights."""
    jax_calls, port_calls = run_both(tmp_path, monkeypatch, [[
        "--stage", "all", "--synthetic", "4", "--detector_init", "d2.pt"]])
    assert port_calls == jax_calls
    args = dict(port_calls[:3:2])
    assert args["detector"][-3:] == ["--norm", "frozen_bn", "--stride_in_1x1"]
    assert "--norm" not in args["extract"]
    assert "--stride_in_1x1" not in args["extract"]
