"""Checkpoints of a training run as torch files (counterpart of
`ekaid_tpu/utils/checkpoint.py`).

A checkpoint is `<directory>/<name>.pt`, where name is the step or
'best': the step, the parameters, and the optimizer's state with its
update count, which is the schedule's position. The resolved config
goes beside it as `cfg.json`, and the best checkpoint's metric as
`best_metric.json`. Only the newest `keep` step checkpoints are kept.

The reference package's snapshots are orbax directories in the same
places (`<directory>/<step>/`, `<directory>/best/`). `restore` and
`latest_step` see them where no `<name>.pt` is there (the port's own
files come first) and read them through `utils/orbax_import.py`, which
needs tensorstore.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ekaid_torch.utils import orbax_import

_STEP = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, name) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, state, name: Optional[str] = None,
             config_dict: Optional[dict] = None) -> str:
        """Write `state` (a TrainState, or what its `state_dict()` gave)
        as <name>.pt, name defaulting to its step, through a
        temporary file so a reader never sees half a checkpoint."""
        sd = state if isinstance(state, dict) else state.state_dict()
        name = name if name is not None else int(sd["step"])
        path = self._path(name)
        torch.save(sd, path + ".tmp")
        os.replace(path + ".tmp", path)
        if config_dict is not None:
            with open(os.path.join(self.directory, "cfg.json"), "w") as f:
                json.dump(config_dict, f, indent=2)
        self._gc()
        return path

    def save_best(self, state, metric: float,
                  config_dict: Optional[dict] = None) -> str:
        """The best checkpoint, keyed on Bleu_1."""
        sd = state if isinstance(state, dict) else state.state_dict()
        path = self.save(sd, name="best", config_dict=config_dict)
        with open(os.path.join(self.directory, "best_metric.json"),
                  "w") as f:
            json.dump({"Bleu_1": metric, "step": int(sd["step"])}, f)
        return path

    def best_metric(self) -> float:
        p = os.path.join(self.directory, "best_metric.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)["Bleu_1"]
        return 0.0

    def restore(self, state, name: Optional[str] = None):
        """Load checkpoint `name` (default: the latest step) into
        `state` in place, onto its model's device; returns it. `<name>.pt`
        first, else the reference's orbax directory `<name>/`."""
        if name is None:
            name = self.latest_step()
            if name is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        if os.path.exists(self._path(name)):
            sd = torch.load(self._path(name),
                            map_location=state.model.device,
                            weights_only=True)
            state.load_state_dict(sd)
            return state
        orbax_dir = os.path.join(self.directory, str(name))
        if orbax_import.is_orbax_dir(orbax_dir):
            return orbax_import.restore_vqa(state, orbax_dir)
        raise FileNotFoundError(f"no checkpoint {name!r} in "
                                f"{self.directory}")

    def steps(self):
        """The steps of the port's own checkpoints."""
        return sorted(int(m.group(1)) for m in map(
            _STEP.match, os.listdir(self.directory)) if m)

    def orbax_steps(self):
        """The steps of the reference's orbax snapshots."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and orbax_import.is_orbax_dir(
                          os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = set(self.steps()) | set(self.orbax_steps())
        return max(steps) if steps else None

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            os.remove(self._path(s))
