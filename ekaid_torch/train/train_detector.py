"""Detector training (counterpart of `ekaid_tpu/train/train_detector.py`).

    python -m ekaid_torch.train.train_detector --synthetic 64 --steps 100
    python -m ekaid_torch.train.train_detector --synthetic 8 --steps 2 \
        --image_size 64 --batch_size 4 --device cpu --cfg <small.yaml>

Fine-tunes a Faster R-CNN R50-FPN (`FasterRCNN.losses`: the RPN and ROI
losses, f32 parameters, the config's compute dtype) with AdamW (weight
decay 1e-4, eps 1e-8), clipping by global norm at 10 and optax's
warmup-cosine learning rate from 0: the schedule's count starts at 0,
so the first update moves nothing, as in the reference. The data are
(images [N, S, S, 3] f32, boxes [N, G, 4], classes [N, G], valid
[N, G]); the host-side augmentation (flip, shift-scale-rotate,
brightness-contrast) and the batching are numpy, bit-equal to the
reference's for the same seed. Each step's random draws come from
`train/step.py::generator(seed, step, 0, stream)` on the training
device. `evaluate` runs `detect(max_out=100)`, whose box head pools
through the ROIAlign kernel K2 on the card, and the AP@0.5 evaluator.

It runs on the CUDA device and raises without one, unless the caller
asks for the CPU (`device='cpu'`, `--device cpu`). `--init_ckpt` reads
a `.pt` state dict or a reference orbax directory
(`utils/orbax_import.load_detector`); `--ckpt_out` writes a `.pt` state
dict, which the extraction runner's `--ana_ckpt`/`--dis_ckpt` read.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ekaid_torch.config import Config, OptimConfig, default_config, \
    load_config
from ekaid_torch.metrics.detection import DetectionEvaluator, \
    proposal_recall
from ekaid_torch.models.detector import FasterRCNN
from ekaid_torch.models.detector.faster_rcnn import loss_draws
from ekaid_torch.models.layers import init_params
from ekaid_torch.train.step import Optimizer, generator, global_norm, \
    warmup_cosine
from ekaid_torch.utils.device import host_to_device, resolve_device
from ekaid_torch.utils.dtypes import Policy, canonical

#: the random streams of the detector trainer (`step.generator`)
TRAIN_DRAWS, VAL_DRAWS = 0, 1
WEIGHT_DECAY = 1e-4
GRAD_CLIP = 10.0


# ------------------------------------------------------------- datasets ---

def synthetic_blob_dataset(n_images: int, image_size: int,
                           num_classes: int, max_gt: int = 8, seed: int = 0):
    """Class-k blobs at random locations; returns arrays
    (images [N,S,S,3], boxes [N,G,4], classes [N,G], valid [N,G])."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 0.05, (n_images, image_size, image_size, 3)
                        ).astype(np.float32)
    boxes = np.zeros((n_images, max_gt, 4), np.float32)
    classes = np.zeros((n_images, max_gt), np.int32)
    valid = np.zeros((n_images, max_gt), bool)
    for i in range(n_images):
        g = rng.integers(1, max_gt)
        for j in range(g):
            w = rng.uniform(image_size * 0.15, image_size * 0.45)
            h = rng.uniform(image_size * 0.15, image_size * 0.45)
            x1 = rng.uniform(0, image_size - w)
            y1 = rng.uniform(0, image_size - h)
            c = rng.integers(0, num_classes)
            boxes[i, j] = (x1, y1, x1 + w, y1 + h)
            classes[i, j] = c
            valid[i, j] = True
            images[i, int(y1):int(y1 + h), int(x1):int(x1 + w),
                   c % 3] += 0.5 + 0.2 * (c // 3)
    return images, boxes, classes, valid


def affine_warp(img: np.ndarray, boxes: np.ndarray, angle_deg: float,
                scale: float, dx: float, dy: float, image_size: int):
    """One shift-scale-rotate about the image center with bilinear
    resampling (zero fill) + box corner transform (the rotated box's
    axis-aligned hull, albumentations bbox_shift_scale_rotate
    semantics). img [S, S, C]; boxes [G, 4] xyxy."""
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    c = (image_size - 1) / 2.0

    # inverse map for sampling: src = R^-1((dst - c - t)) / s + c
    ys, xs = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    u = xs - c - dx
    v = ys - c - dy
    xsrc = (cos * u + sin * v) / scale + c
    ysrc = (-sin * u + cos * v) / scale + c
    x0 = np.floor(xsrc).astype(np.int64)
    y0 = np.floor(ysrc).astype(np.int64)
    fx = (xsrc - x0)[..., None]
    fy = (ysrc - y0)[..., None]

    def tap(yy, xx):
        inb = (yy >= 0) & (yy < image_size) & (xx >= 0) & (xx < image_size)
        val = img[np.clip(yy, 0, image_size - 1),
                  np.clip(xx, 0, image_size - 1)]
        return val * inb[..., None]

    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))

    # forward-map the 4 corners, take the axis-aligned hull
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    cx = np.stack([x1, x2, x1, x2], axis=1) - c       # [G, 4]
    cy = np.stack([y1, y1, y2, y2], axis=1) - c
    nx = scale * (cos * cx - sin * cy) + c + dx
    ny = scale * (sin * cx + cos * cy) + c + dy
    new_boxes = np.stack([nx.min(1), ny.min(1), nx.max(1), ny.max(1)],
                         axis=1)
    return out.astype(img.dtype), np.clip(new_boxes, 0, image_size)


def augment(images, boxes, rng, image_size: int,
            flip_p: float = 0.5, shift_limit: float = 0.0625,
            scale_limit: float = 0.15, rotate_limit: float = 10.0,
            ssr_p: float = 0.5, brightness: float = 0.2):
    """Host-side box-aware augmentation (train-vindr-online.py:268-283
    transform set + parameters: HorizontalFlip p=0.5,
    ShiftScaleRotate(scale_limit=0.15, rotate_limit=10, p=0.5),
    RandomBrightnessContrast p=0.5)."""
    out_i = images.copy()
    out_b = boxes.copy()
    b = images.shape[0]
    for i in range(b):
        if rng.random() < flip_p:
            out_i[i] = out_i[i, :, ::-1]
            x1 = image_size - out_b[i, :, 2]
            x2 = image_size - out_b[i, :, 0]
            out_b[i, :, 0], out_b[i, :, 2] = x1, x2
        if rng.random() < ssr_p:
            out_i[i], out_b[i] = affine_warp(
                out_i[i], out_b[i],
                angle_deg=rng.uniform(-rotate_limit, rotate_limit),
                scale=1.0 + rng.uniform(-scale_limit, scale_limit),
                dx=rng.uniform(-shift_limit, shift_limit) * image_size,
                dy=rng.uniform(-shift_limit, shift_limit) * image_size,
                image_size=image_size)
        if rng.random() < 0.5:
            out_i[i] = (out_i[i]
                        * rng.uniform(1 - brightness, 1 + brightness)
                        + rng.uniform(-brightness, brightness) * 0.1)
    return out_i, out_b


def batches(arrays, batch_size: int, shuffle: bool, seed: int,
            augment_fn=None) -> Iterator[Tuple]:
    images, boxes, classes, valid = arrays
    n = len(images)
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    for i in range(n // batch_size):
        idx = order[i * batch_size:(i + 1) * batch_size]
        im, bx = images[idx], boxes[idx]
        if augment_fn is not None:
            im, bx = augment_fn(im, bx, rng)
        yield im, bx, classes[idx], valid[idx]


# ---------------------------------------------------------------- train ---

class DetectorTrainer:
    """A FasterRCNN with its optimizer on one device. `norm` and
    `stride_in_1x1`: ('frozen_bn', True) fine-tunes converted Detectron2
    weights (the reference always starts from prior weights). The
    initial weights are drawn from a generator seeded with `seed`."""

    def __init__(self, cfg: Config, num_classes: int,
                 total_steps: int = 1000, lr: float = 1e-3,
                 warmup: int = 100, augment_data: bool = True,
                 norm: str = "gn", stride_in_1x1: bool = False,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        det = cfg.detector
        policy = Policy(compute_dtype=canonical(cfg.dtypes.compute_dtype))
        self.model = FasterRCNN(det, num_classes=num_classes, norm=norm,
                                stride_in_1x1=stride_in_1x1, policy=policy)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.num_classes = num_classes
        self.augment_data = augment_data
        self.warmup = min(warmup, max(1, total_steps // 10))
        self.schedule = warmup_cosine(lr, self.warmup, total_steps)
        self.optim_cfg = OptimConfig(type="adam", lr=lr,
                                     weight_decay=WEIGHT_DECAY,
                                     grad_clip=GRAD_CLIP)
        self.reset_optimizer()
        # host seconds of each step (synchronised) and of each batch's
        # augmentation, for measurement
        self.step_seconds: list = []
        self.augment_seconds: list = []

    def reset_optimizer(self) -> None:
        """A fresh optimizer state (count 0) over the current weights."""
        self.opt = Optimizer(self.optim_cfg, self.model,
                             schedule=self.schedule)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Weights from a FasterRCNN state dict; the optimizer starts
        anew."""
        self.model.load_state_dict(sd)
        self.reset_optimizer()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights as CPU tensors (the runner's `--ana_ckpt`)."""
        return {k: v.detach().cpu() for k, v in
                self.model.state_dict().items()}

    def _tensors(self, im, bx, cl, vl):
        dev = self.device
        return (host_to_device(im, dev), host_to_device(bx, dev),
                host_to_device(cl, dev), host_to_device(vl, dev))

    def draws(self, batch: int, seed: int, step: int, stream: int):
        """The uniforms of one loss step on the training device."""
        m = self.model
        return loss_draws(batch, m.num_anchors(), self.cfg.detector.
                          post_nms_topk, generator(seed, step, 0, stream,
                                                   self.device))

    def train_step(self, images, gt_boxes, gt_classes, gt_valid,
                   draws: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One update from one batch of device tensors; returns the
        losses and the gradient's global norm (before clipping) as 0-d
        tensors."""
        m = self.model
        m.zero_grad(set_to_none=True)
        losses, _ = m.losses(images, gt_boxes, gt_classes, gt_valid, draws)
        losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.opt.params]
        gn = global_norm(grads)
        self.opt.step(grads, gn)
        return {**{k: v.detach() for k, v in losses.items()},
                "grad_norm": gn}

    def _timed_augment(self):
        size = self.cfg.detector.image_size

        def aug(im, bx, rng):
            t0 = time.perf_counter()
            out = augment(im, bx, rng, size)
            self.augment_seconds.append(time.perf_counter() - t0)
            return out
        return aug

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, arrays, steps: int, log_every: int = 50,
            seed: int = 0) -> Dict[str, float]:
        det = self.cfg.detector
        if len(arrays[0]) < det.batch_size:
            raise ValueError(f"{len(arrays[0])} images make no batch of "
                             f"{det.batch_size}")
        aug = self._timed_augment() if self.augment_data else None
        t = 0
        epoch = 0
        last: Dict[str, float] = {}
        t0 = time.time()
        while t < steps:
            for im, bx, cl, vl in batches(arrays, det.batch_size,
                                          shuffle=True, seed=seed + epoch,
                                          augment_fn=aug):
                t_step = time.perf_counter()
                aux = self.train_step(*self._tensors(im, bx, cl, vl),
                                      self.draws(len(im), seed, t,
                                                 TRAIN_DRAWS))
                self._sync()
                self.step_seconds.append(time.perf_counter() - t_step)
                t += 1
                if t % log_every == 0:
                    last = {k: float(v) for k, v in aux.items()}
                    rate = t * det.batch_size / (time.time() - t0)
                    print(f"step {t} "
                          + " ".join(f"{k}={v:.4f}"
                                     for k, v in last.items())
                          + f" img/s={rate:.1f}")
                if t >= steps:
                    break
            epoch += 1
        return last

    @torch.no_grad()
    def validation_loss(self, arrays, rng_seed: int = 0
                        ) -> Dict[str, float]:
        """Mean loss over a validation set without updating (the
        reference's LossEvalHook)."""
        det = self.cfg.detector
        sums: Dict[str, float] = {}
        n = 0
        for i, (im, bx, cl, vl) in enumerate(batches(
                arrays, det.batch_size, shuffle=False, seed=0)):
            losses, _ = self.model.losses(
                *self._tensors(im, bx, cl, vl),
                self.draws(len(im), rng_seed, i, VAL_DRAWS))
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {f"val_{k}": v / max(n, 1) for k, v in sums.items()}

    @torch.no_grad()
    def detect(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """`FasterRCNN.detect(max_out=100)` of one batch, on the host."""
        out = self.model.detect(host_to_device(images, self.device),
                                max_out=100)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def evaluate(self, arrays, proposals: bool = False
                 ) -> Dict[str, float]:
        """AP@0.5 over a dataset (the reference's VinbigdataEvaluator
        surface); `proposals=True` adds class-agnostic AR@100 over the
        detections."""
        det = self.cfg.detector
        ev = DetectionEvaluator(self.num_classes)
        acc: Dict[str, list] = {"p": [], "s": [], "v": [], "gb": [],
                                "gv": []}
        for im, bx, cl, vl in batches(arrays, det.batch_size,
                                      shuffle=False, seed=0):
            out = self.detect(im)
            for b in range(im.shape[0]):
                ev.add_image(out["boxes"][b], out["classes"][b],
                             out["scores"][b], out["valid"][b],
                             bx[b], cl[b], vl[b])
                if proposals:
                    acc["p"].append(out["boxes"][b])
                    acc["s"].append(out["scores"][b])
                    acc["v"].append(out["valid"][b])
                    acc["gb"].append(bx[b])
                    acc["gv"].append(vl[b])
        scores = ev.summarize()
        if proposals and acc["p"]:
            scores.update(proposal_recall(acc["p"], acc["s"], acc["v"],
                                          acc["gb"], acc["gv"],
                                          limits=(100,)))
        return scores


def load_arrays(a, det, k: int):
    """The training arrays of the CLI's data flags."""
    if a.synthetic:
        return synthetic_blob_dataset(a.synthetic, det.image_size, k)
    if not (a.gold_csv or a.vindr_csv or a.scene_graph_dir):
        raise SystemExit("pass --synthetic N or an annotation source")
    from ekaid_torch.data.detection import (ImageBoxDataset,
                                            load_imagenome_gold,
                                            load_imagenome_silver,
                                            load_shapes, load_vindr)
    if not a.image_dir:
        raise SystemExit("--image_dir required with annotations")
    if a.scene_graph_dir:
        if not a.shapes_pkl:
            raise SystemExit("--shapes_pkl required with silver scene "
                             "graphs (boxes live in the 224-pad frame)")
        names, boxes, classes, valid = load_imagenome_silver(
            a.scene_graph_dir, load_shapes(a.shapes_pkl),
            image_size=det.image_size)
    else:
        loader = load_imagenome_gold if a.gold_csv else load_vindr
        names, boxes, classes, valid = loader(
            a.gold_csv or a.vindr_csv, image_size=det.image_size)
    ds = ImageBoxDataset(names, boxes, classes, valid, a.image_dir,
                         det.image_size)
    print(f"loaded {len(names)} annotated images")
    return ds.materialize()


def main(argv=None) -> Optional[Dict[str, float]]:
    p = argparse.ArgumentParser(description="ekaid_torch detector training")
    p.add_argument("--cfg", default=None)
    p.add_argument("--which", default="anatomy",
                   choices=["anatomy", "disease"])
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--init_ckpt", default=None,
                   help="detector weights to fine-tune from: a .pt state "
                        "dict (a prior --ckpt_out) or a reference orbax "
                        "directory (cfg.MODEL.WEIGHTS parity)")
    p.add_argument("--norm", default="gn", choices=["gn", "frozen_bn"])
    p.add_argument("--stride_in_1x1", action="store_true",
                   help="caffe stride placement (converted Detectron2 "
                        "checkpoints)")
    p.add_argument("--ckpt_out", default=None,
                   help="write the trained weights as a .pt state dict")
    p.add_argument("--gold_csv", default=None,
                   help="Chest ImaGenome gold bbox CSV (anatomy)")
    p.add_argument("--scene_graph_dir", default=None,
                   help="Chest ImaGenome silver scene-graph JSON dir "
                        "(anatomy, the reference's primary data path)")
    p.add_argument("--shapes_pkl", default=None,
                   help="mimic_shape_full.pkl-style original-shape map "
                        "(required with --scene_graph_dir)")
    p.add_argument("--vindr_csv", default=None,
                   help="VinDr-CXR annotations CSV (disease)")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    cfg = load_config(a.cfg) if a.cfg else default_config()
    det = cfg.detector
    if a.image_size:
        det = det.replace(image_size=a.image_size)
    if a.batch_size:
        det = det.replace(batch_size=a.batch_size)
    cfg = cfg.replace(detector=det)
    k = (det.num_anatomy_classes if a.which == "anatomy"
         else det.num_disease_classes)
    arrays = load_arrays(a, det, k)
    trainer = DetectorTrainer(cfg, k, total_steps=a.steps, lr=a.lr,
                              augment_data=not a.no_augment, norm=a.norm,
                              stride_in_1x1=a.stride_in_1x1, device=a.device)
    if a.init_ckpt:
        from ekaid_torch.utils.orbax_import import load_detector
        trainer.load_state_dict(load_detector(a.init_ckpt))
        print(f"initialized from {a.init_ckpt}")
    trainer.fit(arrays, a.steps)
    scores = trainer.evaluate(arrays)
    print({m: round(v, 4) for m, v in scores.items()
           if not m.startswith("AP50-")})
    print("AP50:", scores["AP50"])
    if a.ckpt_out:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(a.ckpt_out)),
                    exist_ok=True)
        torch.save(trainer.state_dict(), a.ckpt_out)
        print("saved", a.ckpt_out)
    return scores


if __name__ == "__main__":
    main()
