"""Parity of the port's greedy NMS kernel pair (ekaid_torch/ops/
nms_kernel.py) with the JAX package, on the CPU.

K4's plain version against the Pallas kernel `ops/pallas_nms.py::
nms_pallas` (interpret mode, vmapped over a batch, as the JAX package's
own tests run it) and against the NMS family of both packages. The
tolerance is exact: equal valid flags, and equal indices under them, in
order. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_tpu.ops.nms as jnms
from ekaid_torch.ops import nms as tnms
from ekaid_torch.ops import nms_kernel as tnk

ROOT = Path(__file__).resolve().parent.parent
CASES = ["random", "ties", "duplicates", "degenerate", "padding",
         "all_dead", "max_out_over_rows"]


def random_boxes(rng, shape, size=300):
    x1 = rng.uniform(0, size * 0.7, shape)
    y1 = rng.uniform(0, size * 0.7, shape)
    w = rng.uniform(5, size * 0.4, shape)
    h = rng.uniform(5, size * 0.4, shape)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def tied_scores(rng, shape, levels=5):
    """Scores drawn from a few values, so most of them tie."""
    return (rng.integers(1, levels + 1, shape) / levels).astype(np.float32)


def case_inputs(case):
    """(boxes [3, R, 4], scores [3, R], max_out): 80 rows and 30 slots
    (the JAX package's own Pallas NMS test) unless the case says
    otherwise."""
    rng = np.random.default_rng(CASES.index(case))
    b, r, max_out = 3, 80, 30
    if case == "max_out_over_rows":
        r, max_out = 20, 50
    boxes = random_boxes(rng, (b, r))
    scores = rng.uniform(0.01, 1.0, (b, r)).astype(np.float32)
    if case == "ties":
        scores = tied_scores(rng, (b, r))
    elif case == "duplicates":               # equal boxes, equal scores
        boxes[:, r // 2:] = boxes[:, :r - r // 2]
        scores = tied_scores(rng, (b, r), levels=3)
    elif case == "degenerate":               # zero-area and inverted boxes
        boxes[:, ::4, 2] = boxes[:, ::4, 0]
        boxes[:, 1::4, 3] = boxes[:, 1::4, 1]
        boxes[:, 2::4] = boxes[:, 2::4][..., [2, 3, 0, 1]]
        boxes[:, 5] = boxes[:, 4]
        scores = tied_scores(rng, (b, r))
    elif case == "padding":                  # the last quarter is padding
        scores[:, -r // 4:] = tnk.NEG
        scores[:, 0] = -5e8                  # dead: not above NEG / 2
        scores[:, 1] = -4.9e8                # live
    elif case == "all_dead":
        scores[1] = tnk.NEG
    return boxes, scores, max_out


def T(x):
    return torch.as_tensor(np.array(x))


def assert_same(got, want):
    """Equal valid flags, equal indices under them."""
    (gi, gv), (wi, wv) = [(np.asarray(i), np.asarray(v, bool))
                          for i, v in (got, want)]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.where(gv, gi, -1), np.where(wv, wi, -1))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """`nms_pallas` with its pallas_call in interpret mode."""
    import jax.experimental.pallas as pl
    from ekaid_tpu.ops import pallas_nms as pn

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pn.pl, "pallas_call", interp)
    return pn.nms_pallas


@pytest.mark.parametrize("iou", [0.5, 0.7])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case, iou, pallas_interpret):
    boxes, scores, max_out = case_inputs(case)
    want = jax.vmap(lambda b, s: pallas_interpret(b, s, iou, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got_i, got_v = tnk.nms_kernel_plain(T(boxes), T(scores), iou, max_out)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.bool
    assert tuple(got_i.shape) == (3, max_out)
    assert_same((got_i, got_v), want)
    # slots past the last pick are (0, False), as the kernel writes them
    assert (got_i.numpy()[~got_v.numpy()] == 0).all()


@pytest.mark.parametrize("iou", [0.5, 0.7])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_nms_family(case, iou):
    """The same inputs through the JAX blocked `nms` and the port's
    `nms` (batched) and `nms_argmax` (per image)."""
    boxes, scores, max_out = case_inputs(case)
    got = tnk.nms_kernel_plain(T(boxes), T(scores), iou, max_out)
    jax_nms = jax.vmap(lambda b, s: jnms.nms(b, s, iou, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    assert_same(got, jax_nms)
    assert_same(got, tnms.nms(T(boxes), T(scores), iou, max_out))
    for b in range(boxes.shape[0]):
        # the oracle takes live rows by score_thresh, not by NEG / 2
        oracle = tnms.nms_argmax(T(boxes[b]), T(scores[b]), iou, max_out,
                                 score_thresh=tnk.NEG / 2)
        assert_same((got[0][b], got[1][b]), oracle)


def numpy_live_rows(boxes, scores, iou, max_out):
    """Per image, the rows live at the start of each of `max_out` greedy
    steps, summed, from a loop in numpy f32."""
    out = []
    for bx, sc in zip(boxes, scores):
        live = sc > tnk.NEG / 2
        x1, y1, x2, y2 = bx.T
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        total = 0
        for _ in range(max_out):
            total += int(live.sum())
            if not live.any():
                continue
            best = int(np.argmax(np.where(live, sc, -np.inf)))
            iw = np.maximum(np.minimum(x2, x2[best])
                            - np.maximum(x1, x1[best]), 0)
            ih = np.maximum(np.minimum(y2, y2[best])
                            - np.maximum(y1, y1[best]), 0)
            inter = iw * ih
            union = area + area[best] - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(union > 0, inter / union, 0)
            live &= ~(ratio > np.float32(iou))
            live[best] = False
        out.append(total)
    return out


@pytest.mark.parametrize("iou", [0.5, 0.7])
@pytest.mark.parametrize("case", CASES)
def test_plain_counts_live_rows(case, iou):
    """The plain version's count of the rows each step's IoU pass needs,
    which chip_smoke.py's bound for K4 takes, against a numpy loop; the
    selections do not change when it counts."""
    boxes, scores, max_out = case_inputs(case)
    live = torch.zeros(3, dtype=torch.int64)
    got = tnk.nms_kernel_plain(T(boxes), T(scores), iou, max_out,
                               live_rows=live)
    assert live.tolist() == numpy_live_rows(boxes, scores, iou, max_out)
    assert_same(got, tnk.nms_kernel_plain(T(boxes), T(scores), iou, max_out))


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(lead):
    """One image or any leading dims; a CPU tensor takes the plain
    version and launches nothing."""
    rng = np.random.default_rng(7)
    boxes = random_boxes(rng, (*lead, 50))
    scores = tied_scores(rng, (*lead, 50))
    before = tnk.nms_kernel.launches
    got_i, got_v = tnk.nms_kernel(T(boxes), T(scores), 0.5, 12)
    want_i, want_v = tnk.nms_kernel_plain(T(boxes), T(scores), 0.5, 12)
    assert tuple(got_i.shape) == (*lead, 12)
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    assert tnk.nms_kernel.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    before = tnk.nms_kernel.launches
    r = tnk.MAX_ROWS + 1
    with pytest.raises(ValueError, match="shared memory"):
        tnk.nms_kernel(torch.zeros(2, r, 4), torch.zeros(2, r), 0.5, 10)
    with pytest.raises(ValueError, match=r"\[\.\.\., R, 4\]"):
        tnk.nms_kernel(torch.zeros(2, 8, 4), torch.zeros(2, 9), 0.5, 10)
    with pytest.raises(ValueError, match="max_out"):
        tnk.nms_kernel(torch.zeros(8, 4), torch.zeros(8), 0.5, -1)
    assert tnk.nms_kernel.launches == before
    # the extraction geometry (4,768 rows an image) fits
    assert tnk.MAX_ROWS >= 4768


def test_plain_takes_no_rows_and_no_slots():
    i, v = tnk.nms_kernel_plain(torch.zeros(2, 0, 4), torch.zeros(2, 0),
                                0.5, 4)
    assert tuple(i.shape) == (2, 4) and not v.any() and not i.any()
    i, v = tnk.nms_kernel_plain(torch.zeros(5, 4), torch.ones(5), 0.5, 0)
    assert tuple(i.shape) == (0,) and tuple(v.shape) == (0,)


def test_blocked_nms_counts_its_host_reads():
    """One host read per fixed-point iteration, at least one a block."""
    rng = np.random.default_rng(1)
    boxes, scores = random_boxes(rng, (2, 300)), tied_scores(rng, (2, 300))
    before = tnms._survivor_mask.host_reads
    tnms.nms(T(boxes), T(scores), 0.5, 40)
    assert tnms._survivor_mask.host_reads - before >= 2     # 2 blocks


def test_bench_nms_cli_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "ekaid_torch.scripts.bench_nms", "--device",
         "cpu", "--rois", "64", "--batch", "2", "--max_out", "10",
         "--iters", "2"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [x.get("impl") for x in lines[:2]] == ["blocked", "k4_plain"]
    for x in lines[:2]:
        assert x["device"] == "cpu" and (x["batch"], x["rois"]) == (2, 64)
        assert x["ms_per_batch"] > 0 and x["images_per_sec"] > 0
    assert lines[0]["host_reads_per_call"] >= 1
    assert lines[2] == {"kept_set_agreement": 1.0}


def test_bench_nms_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device runs")
    proc = subprocess.run(
        [sys.executable, "-m", "ekaid_torch.scripts.bench_nms", "--rois",
         "8", "--batch", "1", "--iters", "1"], capture_output=True,
        text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "device" in proc.stderr and proc.stdout == ""
