"""Import hygiene of the port: ekaid_torch and chip_smoke.py load neither
JAX nor the reference package. Runs in a fresh interpreter, because this
test process has JAX loaded already."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import ekaid_torch
names = [m.name for m in pkgutil.walk_packages(ekaid_torch.__path__,
                                               "ekaid_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch, statistics, subprocess, threading, argparse
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "ekaid_tpu"))
host = sorted(m for m in sys.modules
              if m.split(".")[0] in ("h5py", "PIL", "pandas", "tensorstore",
                                     "matplotlib"))
print(json.dumps({"modules": names, "loaded": loaded, "host": host}))
"""


@pytest.fixture(scope="module")
def probe():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_package(probe):
    for name in ("models.greedy_decode", "serving.engine",
                 "data.knowledge", "models.detector.anchors",
                 "models.detector.backbone", "models.detector.rpn",
                 "models.detector.heads", "models.detector.faster_rcnn",
                 "ops.nms", "ops.roi_align", "ops.roi_kernels",
                 "utils.platform", "extract.pipeline", "extract.runner",
                 "ops.nms_kernel", "scripts.bench_nms", "train.step",
                 "train.train", "train.score", "data.pipeline",
                 "data.device_cache", "data.vocab", "metrics.caption",
                 "metrics.coco", "metrics.meteor_resources",
                 "utils.logging", "utils.checkpoint", "utils.orbax_import",
                 "train.test", "serving.server", "serving.webui",
                 "serving.client", "train.train_detector",
                 "data.detection", "metrics.detection", "data.images",
                 "data.preprocess", "tools.torch_convert", "tools.pipeline",
                 "utils.observability", "viz.draw", "viz.ask",
                 "viz.examples", "models.quant", "native.bindings",
                 "native", "models.change_detector", "models.ekaid",
                 "serving.artifact", "parallel", "parallel.mesh",
                 "kernels"):
        assert f"ekaid_torch.{name}" in probe["modules"], name
    assert probe["loaded"] == []


def test_port_imports_no_optional_host_packages(probe):
    """h5py (the graph file), PIL (image files), pandas (the CheXpert and
    question CSVs), tensorstore (orbax checkpoints) and matplotlib (the
    figures) load only when used: the card's machine lacks some of
    them."""
    assert probe["host"] == []


def test_port_sources_name_no_reference_import():
    for path in (ROOT / "ekaid_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(
                    ("jax", "flax", "optax", "orbax", "ekaid_tpu")), \
                    f"{path}: {line}"
