"""A whole run of a cell on the CPU at tiny widths, past the harness's
look for a chip, with the timed path broken underneath: `correct` must
come out false for each fault an eval cell can have: a token altered
where it is produced; half of each batch left undecoded, its outputs at
zero. The same run unbroken reads true. And the control:
the lower-precision path in the program's place fails a number. The program runs in f32 here, so the sound runs
read round-off alone against limits set for bf16 on the chip."""

import pytest

import run
from _tiny import patch
from benchlib import spec

SEED = 2 ** 32 + 5
BENCH = spec.benchmark()


def run_cpu(name, faults=(), control=""):
    cell = spec.cell(name, BENCH)
    return run.run_cell(cell, SEED, 1.5, False, device="cpu",
                        patch=patch(cell), faults=faults, bench=BENCH,
                        control=control)


def failed_numbers(out):
    return sorted(k for k, c in out["checks"].items()
                  if not (c["value"] is not None and c["value"] <= c["limit"]))


@pytest.mark.parametrize("name", ["mode2-eval-b64", "mode0-eval-b64"])
def test_sound_run_is_correct(name):
    out = run_cpu(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["alter_token", "half_batch"])
@pytest.mark.parametrize("name", ["mode2-eval-b64", "mode0-eval-b64"])
def test_fault_is_caught(name, fault):
    broken = run_cpu(name, faults=(fault,))
    assert not broken["correct"]
    assert failed_numbers(broken), broken["checks"]


@pytest.mark.parametrize("name", ["mode2-eval-b64", "mode0-eval-b64"])
def test_control_fails(name):
    """The reference in float8 in the program's place."""
    out = run_cpu(name, control="fp8")
    assert not out["correct"], out["checks"]
