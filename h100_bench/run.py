"""Run one cell of the benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in BENCHMARK.json; its files are
`workloads/<cell>.json` (configuration, traffic, driver, limits),
`configs/<config>.json`, `traffic/<traffic>.json` and
`drivers/<driver>.py`, and each per-layer metric it reports is read by
`metrics/<metric>.py`. The run builds its inputs and weights from the
seed, sets up and warms the program (`setup_s`, from process start),
measures for the given seconds, reads the peak device memory, frees the
program and holds what the window produced against the plain reference
(`reference/`). With --trace 0 the result's metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
profiler trace of part of the window.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key. The run needs as many CUDA devices as
the cell asks for, and exits with 2, printing no result, without them,
or when a module of JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

from benchlib import env  # noqa: E402

START = env.process_start_wall()
#: the logit bias of EOS in the seeded weights (the others' logits stay
#: within a few units of 0)
EOS_BIAS = -30.0


@dataclass
class Ctx:
    """What a driver gets: the cell, the seed, the device, a scratch
    directory, the configuration (overlay and widths), the traffic's
    parameters, and the faults a test plants (none in a run)."""
    cell: object
    seed: int
    seconds: float
    device: object
    workdir: str
    overlay: dict
    dims: dict
    traffic: dict
    faults: frozenset = frozenset()
    #: calibration only: 'fp8' puts the reference in float8 e4m3 in the
    #: program's place in the check
    control: str = ""
    _weights: Optional[dict] = field(default=None, repr=False)

    def weights(self) -> dict:
        """The seeded state dict, made once on the device."""
        if self._weights is None:
            from benchlib import program
            from benchlib.weights import make_weights
            import torch
            with torch.device("meta"):
                shape_model = program.reference(self.dims, "meta")
            w = make_weights(shape_model, self.seed, self.device)
            # EOS (token 0) never wins, so that every answer runs to the
            # cap on every seed: random weights end the answers of some
            # seeds early, and the work would follow the seed
            w["speaker.logit.bias"][0] = EOS_BIAS
            self._weights = w
        return self._weights

    @contextlib.contextmanager
    def f32(self):
        """Float32 without TF32, for the reference."""
        import torch
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def make_ctx(cell, seed: int, seconds: float, device, workdir: str,
             patch: Optional[dict] = None, faults=(), control="") -> Ctx:
    """patch: {"overlay": {...}, "traffic": {...}, "config": {...}} merged
    over the cell's files (the CPU tests shrink the sizes this way)."""
    from benchlib import program
    patch = patch or {}
    config = program.merge(cell.config, patch.get("config"))
    overlay = program.merge(config["overlay"], patch.get("overlay"))
    traffic = program.merge(cell.traffic, patch.get("traffic"))
    return Ctx(cell, int(seed), float(seconds), device, workdir, overlay,
               program.model_dims(config, overlay), traffic,
               frozenset(faults), control)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             patch: Optional[dict] = None, faults=(), bench=None,
             control: str = "") -> dict:
    """Set up, measure and check one cell; returns the result object."""
    import torch
    from benchlib import spec
    from benchlib.checks import verdict
    from benchlib.spec import import_file
    driver = import_file(cell.driver_path)
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as workdir:
        ctx = make_ctx(cell, seed, seconds, device, workdir, patch, faults,
                       control)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        st = driver.setup(ctx)
        setup_s = time.time() - START
        log(f"[{cell.name}] seed {seed}: set-up {setup_s:.3f} s")
        res = driver.window(ctx, st, seconds, trace)
        log(f"[{cell.name}] window: {json.dumps(res['log'])}")
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        values = driver.check(ctx, st)
        del st
    bad = env.forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    bench = bench or spec.benchmark()
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not trace:
        for m in spec.end_to_end(bench, cell.name):
            v = setup_s if m["name"] == "setup_s" else \
                res["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    summary = res["layer"].get("summary")
    if trace:
        layer_ctx = dict(res["layer"], dims=ctx.dims, cell=cell.name)
        for m in spec.per_layer(bench, cell.name):
            v = spec.metric_reader(m["name"]).read(layer_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu"),
           "count": int(cell.entry["chips"]), "memory_peak_bytes": peak}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    log(f"[{cell.name}] compared: {json.dumps(values)}")
    v = verdict(values, ctx.cell.limits)
    out = {"correct": v["correct"] and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        out["breakdown"] = summary.breakdown()
    out["checks"] = v["checks"]
    out["compared"] = values
    out["window_log"] = res["log"]
    return out


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    env.set_cache_dirs()
    from benchlib import spec
    bench = spec.benchmark()
    cell = spec.cell(a.workload, bench)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"{a.workload} needs {need} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    try:
        out = run_cell(cell, a.seed, a.seconds, bool(a.trace), bench=bench)
    except ForbiddenImport as e:
        log(f"modules of JAX or the JAX package were loaded: {e.args[0]}")
        return 2
    out.pop("compared")
    out.pop("window_log")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
