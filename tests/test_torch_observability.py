"""ekaid_torch's `utils/observability.py` and `utils/logging.py`: the
metrics log, `profile` writing a trace on the CPU, and the NaN
sanitizer (the spans: tests/test_torch_spans.py)."""

import json

import pytest
import torch

from ekaid_torch.utils.logging import MetricsLogger, read_metrics
from ekaid_torch.utils.observability import enable_nan_debugging, profile


def test_metrics_logger_roundtrip(tmp_path):
    lg = MetricsLogger(str(tmp_path))
    lg.log(1, {"loss": 1.5}, prefix="train/")
    lg.log(2, {"Bleu_1": 0.4}, prefix="eval/")
    lg.close()
    rows = read_metrics(str(tmp_path))
    assert len(rows) == 2
    assert rows[0]["train/loss"] == 1.5
    assert rows[1]["eval/Bleu_1"] == 0.4
    assert rows[0]["step"] == 1
    with open(tmp_path / "metrics.jsonl") as f:
        for line in f:
            json.loads(line)


def test_profile_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    with profile(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = logdir / "trace.json"
    assert trace.stat().st_size > 0
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_nan_debugging_names_the_op():
    enable_nan_debugging(True)
    try:
        x = torch.tensor([0.0], requires_grad=True)
        y = torch.sqrt(x) * 0.0 + torch.log(x)
        with pytest.raises(RuntimeError, match="nan|NaN"), \
                pytest.warns(UserWarning, match="forward call"):
            (y * 0.0).sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
