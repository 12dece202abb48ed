"""Metric logging (counterpart of `ekaid_tpu/utils/logging.py`): one
logger writes <workdir>/metrics.jsonl (append-only, one JSON record a
call), and wandb when it is installed and asked for (gated import).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, workdir: str, use_wandb: bool = False,
                 project: str = "ekaid_torch", run_name: str = ""):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, name=run_name or None)
            except ImportError:
                print("wandb requested but not installed; logging to "
                      "jsonl only")

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[f"{prefix}{k}"] = float(v)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items()
                             if k not in ("time",)}, step=step)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def read_metrics(workdir: str):
    path = os.path.join(workdir, "metrics.jsonl")
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                out.append(json.loads(line))
    return out
