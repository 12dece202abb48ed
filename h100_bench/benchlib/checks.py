"""The numbers that decide `correct`, each held against its limit.

Decoded tokens (`decode_gaps`): the reference, run once over each
sampled row's inputs with the program's tokens fed back as a greedy
decode feeds them, gives at each position its log-probabilities.
`token_gap` is the widest gap by which a program token's log-prob lies
below the reference's best there, `token_gap_mean` its mean;
`logprob_err` the widest distance between the log-prob the program
reported and the reference's for the same token, `logprob_rms` its root
mean square; `mw_err` the widest distance between the module weights
(the largest of a position's three), `mw_mean` its mean.
The gap covers each row's positions up to and including its first 0
(its EOS), the other two the positions before it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def live_positions(seq: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: positions up to and including each row's first 0."""
    ended = (seq == 0).int().cumsum(dim=1)
    return (ended == 0) | ((ended == 1) & (seq == 0))


def decode_gaps(ref_logp: torch.Tensor, ref_mw: torch.Tensor,
                seq: torch.Tensor, prog_lp: Optional[torch.Tensor] = None,
                prog_mw: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """live: the positions to read (default: seq's, up to its EOS)."""
    seq = seq.long()
    live = live_positions(seq) if live is None else live
    picked = torch.gather(ref_logp, -1, seq[..., None])[..., 0]
    gap = (ref_logp.max(dim=-1).values - picked)
    out = {"token_gap": float(torch.where(live, gap, 0.0).max()),
           "token_gap_mean": float(gap[live].mean())}
    tok = live & (seq > 0)
    if prog_lp is not None:
        err = (prog_lp.float() - picked).abs()
        out["logprob_err"] = float(torch.where(tok, err, 0.0).max())
        out["logprob_rms"] = float(err[tok].pow(2).mean().sqrt())
    if prog_mw is not None:
        err = (prog_mw.float() - ref_mw.float()).abs().amax(dim=-1)
        out["mw_err"] = float(torch.where(tok, err, 0.0).max())
        out["mw_mean"] = float(err[tok].mean())
    return out


def control_gaps(ref_logp, ref_mw, low_logp, low_mw, seq):
    """The control's numbers: at each position the program served (seq,
    teacher-forced into both), the token that the lower precision puts
    first, read as `decode_gaps` reads the program's."""
    tok = low_logp.argmax(dim=-1)
    lp = torch.gather(low_logp, -1, tok[..., None])[..., 0]
    return decode_gaps(ref_logp, ref_mw, tok, lp, low_mw,
                       live=live_positions(seq.long()))


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every value is within its
    limit (a missing or NaN value is not)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = (v is not None and limit is not None and v == v
                and v <= limit)
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return {"checks": out, "correct": ok}
