"""Serving artifacts (counterpart of `ekaid_tpu/serving/artifact.py`).

The reference pins its compiled XLA executables so that a serving host
starts without compiling. The port compiles nothing of the model; its
startup cost is the nvcc build of the kernels on first use
(`ekaid_torch/kernels.py`) and the weights' load. An artifact carries
the built kernel libraries and the inference-cast weights, so a host of
the same kind starts without running nvcc:

    python -m ekaid_torch.serving.server --export_artifact art/ \
        [--checkpoint_dir ...]                      # once
    python -m ekaid_torch.serving.server --artifact art/   # no nvcc

Layout (a directory):
    meta.json            platform ('cuda' or 'cpu'), torch and CUDA
                         versions, the device's name and compute
                         capability, the batch sizes, the per-sample
                         shapes and dtypes, and per kernel carried its
                         source hash and file name
    weights.pt           the inference-cast parameters (a state dict)
    lib<name>-<key>.so   on 'cuda', the built library of each kernel
                         the greedy decode launches (K1; in mode0 at
                         bf16 also the trunk's GroupNorm, K5)

`load_artifact` raises, before any decode, when the platform, the torch
version or the device's compute capability differs from the export's,
or when a carried kernel's source hash differs from the tree's
`csrc/` (`kernels.source_hash`); it then loads each carried library
with `kernels.load_prebuilt`, which never runs nvcc and fails loudly.
`Artifact.load_into` raises when the model's decode launches a kernel
the artifact does not carry (an export older than the kernel). The
engines raise for a batch size that was not exported
(`Artifact.fn_for_batch`) and for a live sample whose shapes differ
from the exported ones (`Artifact.check_sample`). As in the reference,
an artifact's engine feeds the full-width inputs the export recorded:
it skips the compact wire.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from ekaid_torch import kernels
from ekaid_torch.utils.device import resolve_device

_META = "meta.json"
_WEIGHTS = "weights.pt"


def greedy(model, batch):
    """The decode an engine serves: `EkaidModel.decode`, greedy (K1 on
    the card)."""
    return model.decode(batch)


def save_artifact(path: str, model, sample: Dict[str, np.ndarray],
                  batch_sizes=(1, 16)) -> None:
    """Write the artifact of `model`, already cast for inference
    (`utils/dtypes.py::cast_params_for_inference`), serving the batch
    sizes given. `sample`: one dataset item without `pair_index`; its
    shapes and dtypes are the serving batch layout. On a CUDA model the
    kernels its decode launches are built (if they are not) and
    copied in."""
    sizes = sorted({int(b) for b in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch sizes {batch_sizes}: want sizes >= 1")
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    dev = model.device
    carried = {}
    for name in model.decode_kernels():
        lib = kernels.build(name)
        shutil.copy2(lib, out / lib.name)
        carried[name] = {"source_hash": kernels.source_hash(name),
                         "file": lib.name}
    torch.save(model.state_dict(), out / _WEIGHTS)
    cuda = dev.type == "cuda"
    meta = {
        "platform": dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "capability": (list(torch.cuda.get_device_capability(dev))
                       if cuda else None),
        "batch_sizes": sizes,
        "sample_shapes": {k: [list(np.shape(v)), str(np.asarray(v).dtype)]
                          for k, v in sample.items()},
        "kernels": carried,
    }
    with open(out / _META, "w") as f:
        json.dump(meta, f, indent=1)


class Artifact:
    """A loaded artifact: `meta`, the inference-cast `weights` on the
    device, and the greedy decode of each exported batch size."""

    def __init__(self, meta: Dict[str, Any],
                 weights: Dict[str, torch.Tensor]):
        self.meta = meta
        self.weights = weights
        self.decode_fns: Dict[int, Callable] = {
            int(b): greedy for b in meta["batch_sizes"]}

    def fn_for_batch(self, b: int) -> Callable:
        """`fn(model, batch)`: the batch-b decode."""
        if b not in self.decode_fns:
            raise ValueError(
                f"artifact has no batch-{b} decode; exported sizes: "
                f"{sorted(self.decode_fns)} — re-export with "
                f"batch_sizes including {b}")
        return self.decode_fns[b]

    def check_sample(self, sample: Dict[str, Any]) -> None:
        """Raise when the live dataset's per-sample shapes differ from
        the exported ones."""
        for k, (shape, _dtype) in self.meta["sample_shapes"].items():
            if k not in sample or list(np.shape(sample[k])) != shape:
                got = list(np.shape(sample[k])) if k in sample else "absent"
                raise RuntimeError(
                    f"artifact shape mismatch for {k!r}: exported {shape}, "
                    f"live dataset {got} — the serving config must match "
                    "the export config; re-export")

    def load_into(self, model) -> None:
        """Copy the weights into `model` (cast for inference first, so
        each copy keeps its dtype). Raises, before any decode, when the
        model's decode launches a kernel the artifact does not carry."""
        missing = [name for name in model.decode_kernels()
                   if name not in self.meta["kernels"]]
        if missing:
            raise RuntimeError(
                f"artifact carries the kernels {sorted(self.meta['kernels'])}"
                f" but this model's decode launches {missing} too — "
                "re-export from this tree")
        model.load_state_dict(self.weights)


def load_artifact(path: str, device="cuda") -> Artifact:
    """Read the artifact at `path` for `device` (CUDA unless 'cpu' is
    asked for); see the module docstring for what raises."""
    dev = resolve_device(device)
    root = Path(path)
    with open(root / _META) as f:
        meta = json.load(f)
    live = dev.type
    if meta["platform"] != live:
        raise RuntimeError(
            f"artifact was exported for platform {meta['platform']!r} but "
            f"this process serves on {live!r}; its kernels and weights "
            "are platform-pinned — re-export on this platform")
    if meta["torch_version"] != torch.__version__:
        raise RuntimeError(
            f"artifact was exported under torch {meta['torch_version']} "
            f"but this process runs torch {torch.__version__} — re-export")
    if live == "cuda":
        cap = list(torch.cuda.get_device_capability(dev))
        if meta["capability"] != cap:
            raise RuntimeError(
                f"artifact was built for compute capability "
                f"{meta['capability']} ({meta['device_name']}) but this "
                f"device is {cap} — re-export on this kind of device")
    for name, k in meta["kernels"].items():
        if name not in kernels.SOURCES:
            raise RuntimeError(f"artifact carries unknown kernel {name!r}")
        tree = kernels.source_hash(name)
        if k["source_hash"] != tree:
            raise RuntimeError(
                f"artifact kernel {name!r} was built from sources "
                f"{k['source_hash']}, but this tree's csrc/ hashes to "
                f"{tree} — re-export from this tree")
    weights = torch.load(root / _WEIGHTS, map_location=dev,
                         weights_only=True)
    if live == "cuda":
        for name, k in meta["kernels"].items():
            kernels.load_prebuilt(name, os.path.abspath(root / k["file"]))
    return Artifact(meta, weights)
