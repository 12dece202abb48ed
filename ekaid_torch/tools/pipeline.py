"""One-command pipeline: raw images -> trained VQA model -> test answers
(counterpart of `ekaid_tpu/tools/pipeline.py`).

The stages, in order, under one data root:

  convert     images -> PNGs + mimic_shape_full.pkl + dicom2id.pkl
              (`data/images.py::convert_tree`; host)
  detector    train the anatomy and disease detectors
              (`train/train_detector.py`; card)
  extract     both detectors -> cmb_bbox_di_feats.hdf5
              (`extract/runner.py`; card, K2)
  preprocess  question CSV -> vqa_dataset.npz, vocab, splits, GT JSONs
              (`data/preprocess.py::transform_questions`; host)
  train       VQA training with snapshots and evals
              (`train/train.py`; card, K1 in the evals)
  test        the best snapshot over the test split -> test_results.json
              (`train/test.py`; card, K1)

A stage is skipped when its artifact exists, unless --force; convert
runs only with --image_dir and preprocess only with --question_csv.
`--stage all --synthetic N` runs every stage on generated data. The
stages that run on the card get `--device` (default cuda; without a
card they raise unless `--device cpu`).

The detector checkpoints are the port's `.pt` state dicts,
`ckpt_anatomy.pt` and `ckpt_disease.pt` (the reference writes orbax
directories `ckpt_anatomy/` and `ckpt_disease/` there). The preprocess
stage passes no dicom2id, so QA row i reads feature rows 2i and 2i + 1
(`data/preprocess.py`): the images must come in (main, reference)
pairs in the extraction's row order.
"""

from __future__ import annotations

import argparse
import os

from ekaid_torch.utils.device import resolve_device

STAGES = ("convert", "detector", "extract", "preprocess", "train",
          "test")


def _exists(*paths) -> bool:
    return all(os.path.exists(p) for p in paths)


def run_pipeline(a) -> None:
    resolve_device(a.device)          # no card, no CPU fallback
    root = a.data_root
    os.makedirs(root, exist_ok=True)
    png_dir = os.path.join(root, "pngs")
    # .pt state dicts (the reference writes orbax directories there)
    ana_ckpt = os.path.join(root, "ckpt_anatomy.pt")
    dis_ckpt = os.path.join(root, "ckpt_disease.pt")
    feats = os.path.join(root, "cmb_bbox_di_feats.hdf5")
    npz = os.path.join(root, "vqa_dataset.npz")
    workdir = os.path.join(root, "run")
    device = ["--device", a.device]

    stages = STAGES if a.stage == "all" else (a.stage,)

    if "convert" in stages and a.image_dir:
        if a.force or not _exists(png_dir):
            from ekaid_torch.data.images import convert_tree
            n = convert_tree(a.image_dir, png_dir)
            print(f"[convert] {n} images -> {png_dir}")
        else:
            print("[convert] skipped (exists)")

    if "detector" in stages:
        if a.force or not _exists(ana_ckpt):
            from ekaid_torch.train import train_detector as td
            args = ["--steps", str(a.detector_steps),
                    "--image_size", str(a.image_size),
                    "--ckpt_out", ana_ckpt, "--which", "anatomy"]
            if a.synthetic:
                args += ["--synthetic", str(max(64, a.synthetic))]
            elif a.scene_graph_dir:
                # the silver ImaGenome scene graphs (the reference's
                # primary anatomy data)
                args += ["--scene_graph_dir", a.scene_graph_dir,
                         "--shapes_pkl",
                         a.shapes_pkl or f"{png_dir}/mimic_shape_full.pkl",
                         "--image_dir", png_dir]
            else:
                if not a.gold_csv:
                    raise SystemExit("--gold_csv or --scene_graph_dir "
                                     "required for real data")
                args += ["--gold_csv", a.gold_csv, "--image_dir", png_dir]
            if a.detector_init:
                args += ["--init_ckpt", a.detector_init,
                         "--norm", "frozen_bn", "--stride_in_1x1"]
            td.main(args + device)
            if a.vindr_csv or a.synthetic:
                args_d = ["--steps", str(a.detector_steps),
                          "--image_size", str(a.image_size),
                          "--ckpt_out", dis_ckpt, "--which", "disease"]
                if a.synthetic:
                    args_d += ["--synthetic", str(max(64, a.synthetic))]
                else:
                    args_d += ["--vindr_csv", a.vindr_csv,
                               "--image_dir", png_dir]
                td.main(args_d + device)
        else:
            print("[detector] skipped (exists)")

    if "extract" in stages:
        if a.force or not _exists(feats):
            from ekaid_torch.extract import runner
            args = ["--out", feats, "--image_size", str(a.image_size)]
            if _exists(ana_ckpt):
                args += ["--ana_ckpt", ana_ckpt]
            if _exists(dis_ckpt):
                args += ["--dis_ckpt", dis_ckpt]
            if not (_exists(ana_ckpt) or _exists(dis_ckpt)):
                args += ["--allow_random"]
            if a.synthetic:
                args += ["--synthetic", str(a.synthetic)]
            else:
                args += ["--image_dir", png_dir]
            runner.main(args + device)
        else:
            print("[extract] skipped (exists)")

    if "preprocess" in stages and a.question_csv:
        if a.force or not _exists(npz):
            from ekaid_torch.data.preprocess import transform_questions
            paths = transform_questions(a.question_csv, root)
            print(f"[preprocess] {paths}")
        else:
            print("[preprocess] skipped (exists)")

    if "train" in stages:
        from ekaid_torch.train import train as trn
        args = ["--workdir", workdir,
                "--max_iter", str(a.train_iters),
                "--snapshot_interval",
                str(max(1, a.train_iters // 2))]
        if a.synthetic:
            args += ["--synthetic"]
        elif a.cfg:
            args += ["--cfg", a.cfg]
        trn.main(args + device)

    if "test" in stages:
        from ekaid_torch.train import test as tst
        args = ["-p", os.path.join(workdir, "snapshots"),
                "--checkpoint", "best",
                "--out", os.path.join(workdir, "test_results.json")]
        if a.synthetic:
            args += ["--synthetic"]
        elif a.cfg:
            args += ["--cfg", a.cfg]
        tst.main(args + device)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ekaid_torch end-to-end pipeline")
    p.add_argument("--stage", default="all",
                   choices=("all",) + STAGES)
    p.add_argument("--data_root", default="./pipeline_data")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run with N synthetic images (no real data)")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--question_csv", default=None)
    p.add_argument("--gold_csv", default=None)
    p.add_argument("--scene_graph_dir", default=None,
                   help="silver ImaGenome scene-graph dir (anatomy)")
    p.add_argument("--shapes_pkl", default=None)
    p.add_argument("--detector_init", default=None,
                   help="a converted reference detector .pt to fine-tune "
                        "from (tools/torch_convert.py --kind detector)")
    p.add_argument("--vindr_csv", default=None)
    p.add_argument("--cfg", default=None)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--detector_steps", type=int, default=2000)
    p.add_argument("--train_iters", type=int, default=40000)
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the card stages raise without "
                        "one) or 'cpu'")
    a = p.parse_args(argv)
    run_pipeline(a)


if __name__ == "__main__":
    main()
