"""Extraction CLI: images -> combined 52-node graph HDF5.

Counterpart of `ekaid_tpu/extract/runner.py`: both detectors (anatomy
`extract`, disease `detect`) run batched on the CUDA device, the host
decodes images and assembles and writes the graph records. Without
trained detector weights it runs with random ones (--allow_random) for
pipeline validation and measurement.

    python -m ekaid_torch.extract.runner --synthetic 16 --allow_random
    python -m ekaid_torch.extract.runner --synthetic 4 --batch_size 2 \
        --image_size 256 --allow_random --device cpu

The default device is CUDA, and without a card the runner raises; the
CPU runs only when asked for. Writing the HDF5 file needs h5py and
reading PNG/JPG files needs PIL. Trained detector weights come from
`--ana_ckpt`/`--dis_ckpt`: a detector `.pt` that
`python -m ekaid_torch.utils.orbax_import detector` wrote, or the
reference's orbax checkpoint directory where tensorstore is installed.

`--dp N` replicates both detectors on the first N local devices; each
batch is split into N contiguous chunks, one a device, and their
outputs are joined in order on the first, so the records are those of
one device (the batch is rounded to a multiple of N). More than the
visible devices raises.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ekaid_torch.config import Config, default_config, load_config
from ekaid_torch.convert import load_flax_params
from ekaid_torch.extract.pipeline import Extractor, H5Writer
from ekaid_torch.models.detector import FasterRCNN
from ekaid_torch.models.layers import init_params
from ekaid_torch.utils.device import resolve_device, visible_devices
from ekaid_torch.utils.dtypes import (Policy, canonical,
                                      cast_params_for_inference)
from ekaid_torch.utils.orbax_import import is_orbax_dir, load_detector


def build_detectors(cfg: Config, ana_params=None, dis_params=None,
                    gen: Optional[torch.Generator] = None, device="cuda"):
    """The anatomy and disease FasterRCNNs on `device`, in eval mode.
    Weights are the given flax param trees (nested dicts of numpy
    arrays), `FasterRCNN` state dicts (flat dicts of tensors, as
    `utils/orbax_import.py` writes them) or random, drawn from `gen`
    (seed 0 when None), anatomy first. They are cast to the compute
    dtype once: extraction is inference only."""
    dev = resolve_device(device)
    det = cfg.detector
    policy = Policy(compute_dtype=canonical(cfg.dtypes.compute_dtype))
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    models = []
    for k, params in ((det.num_anatomy_classes, ana_params),
                      (det.num_disease_classes, dis_params)):
        m = FasterRCNN(det, num_classes=k, norm=det.norm,
                       stride_in_1x1=det.stride_in_1x1, policy=policy)
        if params is None:
            init_params(m, gen)
        elif all(isinstance(v, torch.Tensor) for v in params.values()):
            m.load_state_dict(params)
        else:
            load_flax_params(m, params)
        models.append(cast_params_for_inference(m, policy).to(dev).eval())
    return tuple(models)


def preprocess(images, det, device) -> torch.Tensor:
    """NHWC images (numpy or tensor) -> f32 on `device`. uint8 batches
    are normalised on the device (a quarter of the host-to-device bytes
    of f32); float batches pass through. The 'detectron2' preprocess is
    the caffe-BGR mean subtraction that converted Detectron2 checkpoints
    need."""
    x = torch.as_tensor(images).to(device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    if det.preprocess == "detectron2":
        mean = torch.tensor(det.pixel_mean, device=x.device)
        std = torch.tensor(det.pixel_std, device=x.device)
        x = (x.flip(-1) * 255.0 - mean) / std
    return x


def build_detector_fns(cfg: Config, ana_params=None, dis_params=None,
                       gen: Optional[torch.Generator] = None,
                       device="cuda", devices: Optional[list] = None):
    """(ana_apply, dis_apply): the anatomy detector's `extract` and the
    disease detector's `detect(max_out=26)` on NHWC image batches, with
    the detectors of `build_detectors`.

    devices: data-parallel replicas, a list of devices (the first is
    `device`'s place). The detectors are built once and copied to each;
    a batch, whose size must divide by their number, is split into
    contiguous chunks, one a replica, and the outputs are concatenated
    in order on the first device."""
    devices = [torch.device(d) for d in (devices or [device])]
    ana, dis = build_detectors(cfg, ana_params, dis_params, gen, devices[0])
    det = cfg.detector
    replicas = [(devices[0], ana, dis)] + [
        (d, copy.deepcopy(ana).to(d), copy.deepcopy(dis).to(d))
        for d in devices[1:]]

    def run(images, call):
        n = len(replicas)
        if len(images) % n:
            raise ValueError(f"batch {len(images)} must divide over {n} "
                             "replicas")
        size = len(images) // n
        outs = [call(a, d, preprocess(images[i * size:(i + 1) * size],
                                      det, dev))
                for i, (dev, a, d) in enumerate(replicas)]
        if n == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(devices[0]) for o in outs])
                for k in outs[0]}

    @torch.no_grad()
    def ana_apply(images):
        return run(images, lambda a, d, x: a.extract(x))

    @torch.no_grad()
    def dis_apply(images):
        return run(images, lambda a, d, x: d.detect(
            x, max_out=det.num_anatomy_classes))

    return ana_apply, dis_apply


def list_images(image_dir: str, shard: Optional[tuple] = None) -> list:
    """Sorted image files, optionally strided to shard k of n."""
    files = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if shard is not None:
        k, n = shard
        files = files[k::n]
    return files


def png_batches(image_dir: str, image_size: int, batch_size: int,
                workers: Optional[int] = None, prefetch: int = 4,
                skip: int = 0,
                shard: Optional[tuple] = None) -> Iterator[np.ndarray]:
    """PNG/JPG files -> [B, S, S, 3] uint8 batches, decoded on a thread
    pool in file order; the tail batch is zero-padded to B."""
    from PIL import Image
    files = list_images(image_dir, shard)[skip:]
    if workers is None:
        workers = min(8, os.cpu_count() or 1)

    def load(f):
        img = Image.open(os.path.join(image_dir, f)).convert("RGB")
        if img.size != (image_size, image_size):
            img = img.resize((image_size, image_size))
        return np.asarray(img, np.uint8)

    def results():
        if workers <= 1:
            for f in files:
                yield load(f)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(workers) as ex:
            pending: deque = deque()
            fit = iter(files)

            def fill():
                while len(pending) < workers * prefetch:
                    f = next(fit, None)
                    if f is None:
                        return
                    pending.append(ex.submit(load, f))

            fill()
            while pending:                   # in submit (sorted) order
                arr = pending.popleft().result()
                fill()
                yield arr

    batch = []
    for arr in results():
        batch.append(arr)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        while len(batch) < batch_size:
            batch.append(np.zeros_like(batch[0]))
        yield np.stack(batch)


def synthetic_batches(n: int, image_size: int, batch_size: int,
                      skip: int = 0, dtype: str = "float32"
                      ) -> Iterator[np.ndarray]:
    """n // batch_size batches from seed 0: standard-normal float32
    images (the reference's stream), or uniform uint8 pixels."""
    rng = np.random.default_rng(0)
    shape = (batch_size, image_size, image_size, 3)
    for i in range(n // batch_size):
        if dtype == "uint8":
            batch = rng.integers(0, 256, shape, dtype=np.uint8)
        elif dtype == "float32":
            batch = rng.standard_normal(shape).astype(np.float32)
        else:
            raise ValueError(f"unknown synthetic dtype {dtype!r}")
        if i * batch_size >= skip:    # resume: same stream, same images
            yield batch


def main(argv=None):
    p = argparse.ArgumentParser(description="CXR feature extraction")
    p.add_argument("--cfg", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="run N synthetic images instead of reading files")
    p.add_argument("--out", default="data/cmb_bbox_di_feats.hdf5")
    p.add_argument("--ana_ckpt", default=None)
    p.add_argument("--dis_ckpt", default=None)
    p.add_argument("--allow_random", action="store_true")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--norm", default=None, choices=["gn", "frozen_bn"],
                   help="backbone norm; frozen_bn (with --stride_in_1x1) "
                        "for converted Detectron2 checkpoints")
    p.add_argument("--stride_in_1x1", action="store_true")
    p.add_argument("--preprocess", default=None,
                   choices=["unit", "detectron2"],
                   help="input normalization on the device; detectron2 is "
                        "the caffe-BGR mean subtraction of converted "
                        "checkpoints")
    p.add_argument("--store_dtype", default="float32",
                   choices=["float32", "float16"])
    p.add_argument("--io_workers", type=int, default=None,
                   help="PNG decode threads (default min(8, cpus))")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel extraction over N local devices "
                        "(0: one device)")
    p.add_argument("--shard", default=None, metavar="K/N",
                   help="process every N-th image starting at K")
    p.add_argument("--resume", action="store_true",
                   help="append to an existing --out and skip the images "
                        "it already holds")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)

    devices = None
    if a.dp:
        visible = visible_devices(resolve_device(a.device))
        if a.dp > len(visible):
            raise SystemExit(f"--dp {a.dp}: only {len(visible)} device(s) "
                             f"are visible on {a.device}")
        devices = visible[:a.dp]
    if not (a.ana_ckpt or a.dis_ckpt or a.allow_random):
        raise SystemExit("no checkpoints given; pass --allow_random to run "
                         "with random detector weights")
    for flag, path in (("--ana_ckpt", a.ana_ckpt), ("--dis_ckpt", a.dis_ckpt)):
        if path and not (os.path.isfile(path) or is_orbax_dir(path)):
            raise SystemExit(f"{flag} {path}: neither a detector .pt file "
                             "nor an orbax checkpoint directory")
    shard = None
    if a.shard:
        try:
            k, n = (int(x) for x in a.shard.split("/"))
        except ValueError:
            raise SystemExit(f"--shard {a.shard!r}: expected K/N")
        if not 0 <= k < n:
            raise SystemExit(f"--shard {a.shard}: need 0 <= K < N")
        shard = (k, n)
        if a.synthetic:
            raise SystemExit("--shard applies to --image_dir runs")
    if not a.synthetic and not a.image_dir:
        raise SystemExit("--image_dir or --synthetic required")

    cfg = load_config(a.cfg) if a.cfg else default_config()
    det = cfg.detector
    if a.image_size:
        det = det.replace(image_size=a.image_size)
    if a.batch_size:
        det = det.replace(extract_batch_size=a.batch_size)
    if a.norm:
        det = det.replace(norm=a.norm)
    if a.stride_in_1x1:
        det = det.replace(stride_in_1x1=True)
    if a.preprocess:
        det = det.replace(preprocess=a.preprocess)
    if a.dp and det.extract_batch_size % a.dp:
        nb = max(a.dp, det.extract_batch_size // a.dp * a.dp)
        print(f"note: batch_size {det.extract_batch_size} -> {nb} "
              f"to divide --dp {a.dp}")
        det = det.replace(extract_batch_size=nb)
    cfg = cfg.replace(detector=det)

    ana_params = load_detector(a.ana_ckpt) if a.ana_ckpt else None
    dis_params = load_detector(a.dis_ckpt) if a.dis_ckpt else None
    ana_apply, dis_apply = build_detector_fns(cfg, ana_params, dis_params,
                                              device=a.device,
                                              devices=devices)
    ex = Extractor(ana_apply, dis_apply, det.num_disease_classes)
    run_meta = {"shard": a.shard or "",
                "image_dir": os.path.abspath(a.image_dir)
                if a.image_dir else "",
                "synthetic": int(a.synthetic),
                "ana_ckpt": a.ana_ckpt or "", "dis_ckpt": a.dis_ckpt or "",
                "norm": det.norm,
                "preprocess": det.preprocess, "image_size": det.image_size}
    writer = H5Writer(a.out, num_nodes=2 * det.num_anatomy_classes,
                      feat_dim=det.roi_feat_dim, feat_dtype=a.store_dtype,
                      mode="a" if a.resume else "w", run_meta=run_meta)
    done = writer.n
    if a.synthetic:
        if done % det.extract_batch_size:
            raise SystemExit(
                f"synthetic resume needs committed rows ({done}) to be a "
                f"multiple of the batch size ({det.extract_batch_size})")
        batches = synthetic_batches(a.synthetic, det.image_size,
                                    det.extract_batch_size, skip=done)
    else:
        total = len(list_images(a.image_dir, shard))
        if done > total:
            writer.truncate(total)
            done = total
        writer.expected_rows = total
        batches = png_batches(a.image_dir, det.image_size,
                              det.extract_batch_size, workers=a.io_workers,
                              skip=done, shard=shard)
    if done:
        print(f"resuming: {done} images already in {a.out}")
    ex.run(batches, writer)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
