"""The arithmetic of the readers of the program's own spans and
counters. While a profiler records, the program
(`ekaid_torch/utils/observability.py`) adds up each span's host time
and its count by name, and each counter: in a traced run, over the traced calls alone,
as the trace's window is the run's only profiler. `recorded` gives
None where the run was not traced or the program records no spans (a
program without them), and each reading None where its span or counter
is not there."""

from __future__ import annotations

from typing import Optional


def recorded(ctx) -> Optional[dict]:
    """{"spans": {name: {"count", "host_s"}}, "counts": {...}} of a
    traced run, or None."""
    if ctx.get("summary") is None:
        return None
    try:
        from ekaid_torch.utils import observability
    except ImportError:
        return None
    read = getattr(observability, "recorded", None)
    return read() if read is not None else None


def span_ms(rec: Optional[dict], name: str,
            per: Optional[str] = None) -> Optional[float]:
    """Milliseconds of the span `name`'s host time, its children's
    included, over its own count, or over the count of the span `per`."""
    s = rec["spans"].get(name) if rec else None
    n = rec["spans"].get(per or name, {}).get("count") if s else None
    if not n:
        return None
    return 1e3 * s["host_s"] / n


def share(rec: Optional[dict], part: str, other: str) -> Optional[float]:
    """part / (part + other) of two counters, in percent."""
    c = rec["counts"] if rec else {}
    if part not in c or other not in c or not c[part] + c[other]:
        return None
    return 100.0 * c[part] / (c[part] + c[other])
