"""Readings for the limits of `correct`, in one process on the chip.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control_seeds 7,8,9 --seconds 5 [--out file.json]

For each seed of --seeds the cell runs as the benchmark runs it (set-up,
a short window, the check) and its compared numbers are recorded: the
sound readings, whose largest is a limit's lower reading. For each seed
of --control_seeds the control runs: the reference in float8 e4m3 in
the program's place, read at the positions the program served
(`checks.control_gaps`) and checked as the cell is. The smallest control
reading of a number is its upper reading. Nothing here runs in the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import run  # noqa: E402
from benchlib import env, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    env.set_cache_dirs()
    bench = spec.benchmark()
    cell = spec.cell(a.workload, bench)
    rec = {"workload": a.workload, "sound": {}, "control": {}}

    def save():
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "w") as f:
                json.dump(rec, f, indent=1)

    for kind, seeds in (("sound", a.seeds), ("control", a.control_seeds)):
        for s in (int(x) for x in seeds.split(",") if x):
            t0 = time.time()
            out = run.run_cell(cell, s, a.seconds, False, bench=bench,
                               control="fp8" if kind == "control" else "")
            rec[kind][s] = out["compared"]
            run.log(f"{kind} {s}: {json.dumps(out['compared'])} "
                    f"({time.time() - t0:.1f} s) metrics "
                    f"{json.dumps(out['metrics'])}")
            save()
    for kind, pick in (("sound", max), ("control", min)):
        vals = list(rec[kind].values())
        if vals:
            rec[f"{kind}_{pick.__name__}"] = {
                n: pick(v[n] for v in vals) for n in vals[0]
                if isinstance(vals[0][n], float)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
