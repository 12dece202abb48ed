"""The frozen reference against the program's plain path on the CPU, at
tiny widths and f32, on the same seeded weights and inputs: mode2 and
mode0 encoders, teacher-forced log-probs and module weights, and the
greedy decode."""

import pytest
import torch

from _tiny import dims
from benchlib import data, program
from benchlib.weights import make_weights

SEED = 2 ** 31 + 77


def build(config):
    from ekaid_torch.models.ekaid import EkaidModel
    from ekaid_torch.utils.dtypes import F32
    _, overlay, m = dims(config)
    cfg = program.program_config(overlay)
    ref = program.reference(m, "cpu")
    w = make_weights(ref, SEED, "cpu")
    ref.load_state_dict(w)
    prog = EkaidModel(cfg, ntoken=program.ntoken(m), policy=F32,
                      device="cpu", seed=None)
    prog.load_state_dict(w)
    c = {"qa_rows": 6, "images": 12, "pairing": "disjoint",
         "questions_per_pair": 1, "question_types": [[5, 6, 7, 9]]}
    corpus = data.make_corpus(c, m, SEED, "cpu")
    b = data.batch(corpus, list(range(6)), m, "cpu")
    # the answer rows after BOS, and one trailing 0
    b["labels"] = torch.nn.functional.pad(
        torch.as_tensor(corpus["answers"][:6]), (0, 1))
    return m, cfg, prog, ref, b


def close(a, b, tol):
    scale = max(float(b.abs().max()), 1e-6)
    return float((a.float() - b.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("config", ["ekaid-mode2", "ekaid-mode0"])
def test_encoder_and_teacher_forcing(config):
    m, _, prog, ref, b = build(config)
    with torch.no_grad():
        pe = prog.encode(b)
        re = ref.encode(b)
        for k in ("feat_bef", "feat_aft", "att_bef", "att_aft"):
            assert close(pe[k], re[k], 1e-5), k
        # a difference of near-equal vectors: held to its operands' scale
        err = (pe["feat_diff"] - re["feat_diff"]).abs().max()
        assert float(err) <= 1e-5 * float(re["feat_aft"].abs().max())
        pt = prog.speaker.teacher_forcing(pe["feat_bef"], pe["feat_aft"],
                                          pe["feat_diff"], b["labels"])
        lp, mw = ref.speaker.run(re, b["labels"][:, :-1])
    assert close(pt["logprobs"], lp, 1e-5)
    assert close(pt["module_weights"], mw, 1e-5)


def test_greedy_decode_and_forced_gaps():
    from benchlib.checks import decode_gaps
    m, _, prog, ref, b = build("ekaid-mode2")
    with torch.no_grad():
        out = prog.decode(b)
        seq = ref.speaker.greedy(ref.encode(b))
        logp, mw = ref.forced(b, out["seq"])
    assert torch.equal(out["seq"], seq)
    g = decode_gaps(logp, mw, out["seq"], out["logprobs"],
                    out["module_weights"])
    assert g["token_gap"] == 0.0
    assert g["logprob_err"] < 1e-4 and g["mw_err"] < 1e-5
