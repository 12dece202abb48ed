"""ekaid_torch serving artifacts (`serving/artifact.py`) on the CPU:
export and load, answers bit-equal to the live engine's on the same
inputs, the refusals, and the server's --export_artifact / --artifact.

The live engine is given the artifact engine's wire (full width, no
`compact_wire`), so both decode the same bytes."""

import json
import signal

import numpy as np
import pytest
import torch

from ekaid_torch.config import load_config
from ekaid_torch.serving import artifact as art_mod
from ekaid_torch.serving import server
from ekaid_torch.serving.artifact import load_artifact, save_artifact
from ekaid_torch.serving.engine import InferenceEngine
from ekaid_torch.serving.server import CoalescingEngine
from ekaid_torch.train.train import build_synthetic_trainer

torch.set_num_threads(2)

BUCKET = 4
QUESTIONS = ("w5 w9 what", "what has changed w12", None)


def _cfg():
    cfg = load_config("configs/smoke.yaml")
    return cfg.replace(data=cfg.data.replace(num_workers=1))


def _trainer(tmp_path, name, cfg=None):
    return build_synthetic_trainer(cfg or _cfg(), str(tmp_path / name),
                                   n_pairs=40, device="cpu")


def _sample(tr):
    return {k: v for k, v in tr.eval_ds.sample(
        int(tr.eval_ds.split_idxs[0])).items() if k != "pair_index"}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(artifact dir, the live coalescing engine it was exported from,
    with the full-width wire)."""
    tmp = tmp_path_factory.mktemp("art")
    live = CoalescingEngine(_trainer(tmp, "live"), coalesce_batch=BUCKET)
    live._wire = dict
    live._dev_cache.clear()
    save_artifact(str(tmp / "a"), live.model, _sample(live.trainer),
                  batch_sizes=(1, BUCKET))
    return tmp / "a", live


def _edit_meta(src, dst, **changes):
    import shutil
    shutil.copytree(src, dst)
    meta = json.loads((dst / "meta.json").read_text())
    meta.update(changes)
    (dst / "meta.json").write_text(json.dumps(meta))
    return dst


def test_artifact_layout(exported):
    path, _ = exported
    meta = json.loads((path / "meta.json").read_text())
    assert meta["platform"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert meta["batch_sizes"] == [1, BUCKET]
    assert meta["kernels"] == {}          # K1's plain twin on the CPU
    assert meta["sample_shapes"]["d_feats"][0] == [8, 48]
    assert (path / "weights.pt").is_file()


def test_answers_bit_equal_to_the_live_engine(exported, tmp_path):
    path, live = exported
    art = load_artifact(str(path), device="cpu")
    tr = _trainer(tmp_path, "served")
    eng = InferenceEngine(tr, artifact=art)
    for p, q in zip(eng.model.state_dict().values(),
                    live.model.state_dict().values()):
        assert p.dtype == q.dtype and torch.equal(p, q)
    for idx in tr.eval_ds.split_idxs[:3]:
        for q in QUESTIONS:
            got = eng.answer(q, int(idx), detail=True)
            want = InferenceEngine.answer(live, q, int(idx), detail=True)
            for k in ("answer", "tokens", "module_weights"):
                assert got[k] == want[k], k


def test_coalesced_answers_bit_equal_to_the_live_engine(exported, tmp_path):
    path, live = exported
    eng = CoalescingEngine(_trainer(tmp_path, "served"),
                           coalesce_batch=BUCKET,
                           artifact=load_artifact(str(path), device="cpu"))
    idxs = [int(i) for i in eng.ds.split_idxs[:3]]
    items = [(i, eng.question_to_ids(q) if q else None)
             for i, q in zip(idxs, QUESTIONS)]
    got = eng._decode_on(eng.devices[0], *eng._gather_rows(items))
    want = live._decode_on(live.devices[0], *live._gather_rows(items))
    for k in ("seq", "logprobs", "module_weights"):
        assert torch.equal(got[k], want[k]), k
    res = eng.answer("w5 w9 what", idxs[0])
    assert res["answer"] == InferenceEngine.answer(live, "w5 w9 what",
                                                   idxs[0])["answer"]
    assert eng.drain(timeout_s=30)


@pytest.mark.parametrize("change,msg", [
    ({"platform": "cuda"}, "exported for platform 'cuda'"),
    ({"torch_version": "0.0.1"}, "exported under torch 0.0.1"),
    ({"kernels": {"greedy_decode": {"source_hash": "0" * 16,
                                    "file": "libgreedy_decode-0.so"}}},
     "hashes to"),
])
def test_load_refuses(exported, tmp_path, change, msg):
    path, _ = exported
    bad = _edit_meta(path, tmp_path / "bad", **change)
    with pytest.raises(RuntimeError, match=msg):
        load_artifact(str(bad), device="cpu")


def test_engine_refuses_a_batch_size_not_exported(exported, tmp_path):
    path, _ = exported
    with pytest.raises(ValueError, match="no batch-8 decode"):
        CoalescingEngine(_trainer(tmp_path, "b8"), coalesce_batch=8,
                         artifact=load_artifact(str(path), device="cpu"))


def test_engine_refuses_replicas_with_an_artifact(exported, tmp_path):
    path, _ = exported
    with pytest.raises(ValueError, match="replicas>1 with an artifact"):
        CoalescingEngine(_trainer(tmp_path, "r2"), coalesce_batch=BUCKET,
                         replicas=2,
                         artifact=load_artifact(str(path), device="cpu"))


def test_engine_refuses_a_sample_of_another_shape(exported, tmp_path):
    path, _ = exported
    cfg = _cfg()
    cfg = cfg.replace(data=cfg.data.replace(feature_dim=32))
    with pytest.raises(RuntimeError, match="shape mismatch for 'd_feats'"):
        InferenceEngine(_trainer(tmp_path, "f32", cfg),
                        artifact=load_artifact(str(path), device="cpu"))


def test_server_exports_then_serves(tmp_path, monkeypatch):
    """--export_artifact writes the artifact and exits; --artifact then
    serves its answers (HTTP serving skipped: `serve_forever` returns at
    once)."""
    out = tmp_path / "srv"
    base = ["--synthetic", "--device", "cpu", "--cfg", "configs/smoke.yaml",
            "--coalesce_batch", str(BUCKET), "--workdir", str(tmp_path / "w")]
    server.main(base + ["--export_artifact", str(out)])
    assert json.loads((out / "meta.json").read_text())["batch_sizes"] == [
        1, BUCKET]
    engines = []
    make = server.make_handler
    monkeypatch.setattr(server, "make_handler",
                        lambda e: (engines.append(e), make(e))[1])
    monkeypatch.setattr(server.Server, "serve_forever",
                        lambda self, *a, **k: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    server.main(base + ["--artifact", str(out), "--port", "0"])
    eng, = engines
    assert eng.artifact is not None and eng.coalesce_batch == BUCKET
    weights = torch.load(out / "weights.pt", weights_only=True)
    for name, p in eng.model.state_dict().items():
        assert torch.equal(p, weights[name]), name
    tr = _trainer(tmp_path, "ref")
    ref = InferenceEngine(tr)
    ref._wire = dict
    ref._dev_cache.clear()
    idx = int(tr.eval_ds.split_idxs[1])
    assert eng.answer("w5 w9 what", idx)["answer"] == ref.answer(
        "w5 w9 what", idx)["answer"]


def test_greedy_is_the_decode():
    """An artifact's decode of every exported size is the model's greedy
    decode."""
    meta = {"batch_sizes": [1, 4], "sample_shapes": {}, "kernels": {}}
    art = art_mod.Artifact(meta, {})
    assert art.fn_for_batch(1) is art_mod.greedy is art.fn_for_batch(4)
    assert np.array_equal(sorted(art.decode_fns), [1, 4])
