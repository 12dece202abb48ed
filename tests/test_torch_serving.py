"""ekaid_torch serving on the CPU: the batch-1 engine, the coalescing
engine and the HTTP server, mirroring tests/test_serving.py; the
engine's answers against the JAX package's engine on one reference
checkpoint; the terminal client."""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_port import port_cfg
from ekaid_tpu.config import default_config
from ekaid_torch.serving import client, server
from ekaid_torch.serving.engine import InferenceEngine
from ekaid_torch.serving.server import (CoalescingEngine, Server,
                                        make_handler)
from ekaid_torch.train.train import build_synthetic_trainer


def _cfg():
    """The dims of tests/test_serving.py, at f32."""
    cfg = default_config()
    return cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=8),
        data=cfg.data.replace(num_nodes=6, feature_dim=24, adj_pad=10,
                              train=cfg.data.train.replace(batch_size=4),
                              test=cfg.data.test.replace(batch_size=4)),
        question=cfg.question.replace(hidden_dim=32),
        dtypes=cfg.dtypes.replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    trainer = build_synthetic_trainer(
        port_cfg(_cfg()), str(tmp_path_factory.mktemp("serve")),
        n_pairs=32, device="cpu")
    return InferenceEngine(trainer)


@pytest.fixture(scope="module")
def coalescing_engine(engine):
    return CoalescingEngine(engine.trainer, coalesce_batch=8,
                            linger_ms=30.0)


def test_engine_answer(engine):
    out = engine.answer("w5 w9 what")
    assert isinstance(out["answer"], str)
    assert out["latency_ms"] > 0
    assert out["question_tokens"] == [5, 9]


def test_engine_answer_detail(engine):
    """Per-token words re-join to the answer and each module-weight row
    is a softmax."""
    out = engine.answer("w5 w9 what", detail=True)
    assert " ".join(out["tokens"]) == out["answer"]
    mw = np.asarray(out["module_weights"])
    assert mw.shape == (len(out["tokens"]), 3)
    assert np.allclose(mw.sum(-1), 1.0, atol=2e-3)


def test_engine_unknown_words_drop(engine):
    assert engine.answer("zzzzz qqqqq")["question_tokens"] == []


def test_engine_refresh_changes_index(engine):
    seen = {engine.refresh() for _ in range(10)}
    assert len(seen) > 1 and seen <= set(int(i) for i in
                                          engine.ds.split_idxs)


def test_engine_sample_info_and_question_width(engine):
    idx = int(engine.ds.split_idxs[1])
    info = engine.sample_info(idx)
    s = engine.ds.sample(idx)
    assert info == {"index": idx,
                    "question": engine.vocab.decode(s["question"]),
                    "gt_answer": engine.vocab.decode(s["labels"][1:])}
    q = engine.question_to_ids("w5 " * 100)
    assert q.shape == (engine.ds.questions.shape[1],) and (q == 5).all()
    row = engine._dev_sample(idx)
    assert engine._dev_sample(idx) is row
    assert str(row["d_feats"].dtype) == "torch.float16"
    assert str(row["d_adj"].dtype) == "torch.int8"
    assert "labels" not in row


def _serve(engine):
    srv = Server(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _call(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(base + path, data),
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_round_trip(engine):
    srv, base = _serve(engine)
    try:
        status, health = _call(base, "/health")
        assert status == 200 and health["status"] == "ok"
        assert health["vocab_size"] == engine.vocab.size
        status, ans = _call(base, "/question", {"question": "what changed"})
        assert status == 200 and "answer" in ans
        status, s = _call(base, "/sample?index=%d" % engine.ds.split_idxs[0])
        assert status == 200 and "gt_answer" in s
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert "text/html" in r.headers["Content-Type"]
            page = r.read().decode()
        assert "EKAID" in page and "/question" in page
        status, ans = _call(base, "/question", {"question": "what changed",
                                                "detail": True})
        assert "tokens" in ans and "module_weights" in ans
        status, ref = _call(base, "/refresh", {})
        assert ref["index"] == engine.index
        for path, payload, code in (("/question", {"nope": 1}, 400),
                                    ("/bogus", None, 404),
                                    ("/image", None, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _call(base, path, payload)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()


def test_image_endpoint_serves_the_pair(engine, tmp_path):
    idx = int(engine.ds.split_idxs[0])
    rows = engine.ds.feature_idx[idx]
    for which, row in zip(("main", "ref"), rows):
        (tmp_path / f"{int(row)}.png").write_bytes(f"png {which}".encode())
    engine.image_dir = str(tmp_path)
    srv, base = _serve(engine)
    try:
        for which in ("main", "ref"):
            url = f"{base}/image?index={idx}&which={which}"
            with urllib.request.urlopen(url, timeout=60) as r:
                assert r.headers["Content-Type"] == "image/png"
                assert r.read() == f"png {which}".encode()
    finally:
        engine.image_dir = None
        srv.shutdown()
        srv.server_close()


def test_client_asks_one_question(engine, capsys):
    srv, base = _serve(engine)
    try:
        client.main(["--server", base, "--question", "w5 what"])
    finally:
        srv.shutdown()
        srv.server_close()
    out = capsys.readouterr().out
    assert out.startswith("connected: ") and '"answer"' in out


def test_coalescing_single_request(coalescing_engine):
    out = coalescing_engine.answer("w5 w9 what")
    assert isinstance(out["answer"], str) and out["question_tokens"]
    out = coalescing_engine.answer("w5 w9 what", detail=True)
    assert " ".join(out["tokens"]) == out["answer"]
    assert np.asarray(out["module_weights"]).shape[-1] == 3


def test_coalescing_matches_batch1(coalescing_engine, engine):
    """At f32 a coalesced, padded batch answers each request as the
    batch-1 engine does, details included."""
    eng = coalescing_engine
    items = [(int(i), q) for i in eng.ds.split_idxs[:4]
             for q in ("w5 what", "what has changed w7", None)]
    want = [engine.answer(q, index=i, detail=True) for i, q in items]
    before = eng.stats["coalesced"]
    with ThreadPoolExecutor(max_workers=len(items)) as ex:
        got = list(ex.map(lambda a: eng.answer(a[1], index=a[0],
                                               detail=True), items))
    assert eng.stats["coalesced"] > before
    for g, w in zip(got, want):
        assert (g["answer"], g["index"], g["tokens"]) == \
            (w["answer"], w["index"], w["tokens"])
        np.testing.assert_allclose(g["module_weights"], w["module_weights"],
                                   atol=1e-4)


def test_replicas_bounds_checked(engine):
    with pytest.raises(ValueError, match="devices are visible"):
        CoalescingEngine(engine.trainer, coalesce_batch=4, replicas=99)


def test_drain_waits_for_inflight(coalescing_engine):
    eng = coalescing_engine
    with ThreadPoolExecutor(max_workers=4) as ex:
        outs = list(ex.map(lambda _: eng.answer("what has changed"),
                           range(4)))
    assert all(isinstance(o["answer"], str) for o in outs)
    assert eng.drain(timeout_s=30)


def test_coalescing_concurrent_clients(coalescing_engine):
    """16 concurrent requests all succeed, each index's answer is the
    same whatever batch it rode in, and at least one batch folded
    several requests."""
    eng = coalescing_engine
    avail = [int(i) for i in list(eng.ds.split_idxs)[:4]]
    idxs = [avail[k % len(avail)] for k in range(16)]
    before = dict(eng.stats)
    with ThreadPoolExecutor(max_workers=16) as ex:
        outs = list(ex.map(
            lambda i: eng.answer("what has changed", index=i), idxs))
    assert len(outs) == 16
    by_idx = {}
    for i, o in zip(idxs, outs):
        assert by_idx.setdefault(i, o["answer"]) == o["answer"]
    assert eng.stats["requests"] - before["requests"] == 16
    assert eng.stats["coalesced"] > before["coalesced"]
    assert eng.stats["max_batch"] > 1


def test_failure_reaches_every_future_and_serving_goes_on(engine):
    eng = CoalescingEngine(engine.trainer, coalesce_batch=4, linger_ms=50)
    real = eng._decode_on
    eng._decode_on = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(eng.answer, "w5", None) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=60)
    eng._decode_on = real
    idx = int(engine.ds.split_idxs[2])
    assert eng.answer("w5", idx)["answer"] == \
        engine.answer("w5", idx)["answer"]
    assert eng.drain(timeout_s=30)


@pytest.mark.parametrize("bucket", ["16", "0"])
def test_server_refuses_the_artifact_flags(bucket, tmp_path):
    """--artifact of an artifact exported for another platform raises
    before any engine is built (coalescing and batch-1)."""
    import json
    art = tmp_path / "art"
    base = ["--synthetic", "--device", "cpu", "--cfg", "configs/smoke.yaml",
            "--coalesce_batch", bucket, "--workdir", str(tmp_path / "w")]
    server.main(base + ["--export_artifact", str(art)])
    meta = json.loads((art / "meta.json").read_text())
    meta["platform"] = "cuda"
    (art / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="exported for platform 'cuda'"):
        server.main(base + ["--artifact", str(art)])


def test_server_refuses_replicas_without_coalescing():
    with pytest.raises(SystemExit, match="--replicas requires"):
        server.main(["--synthetic", "--device", "cpu", "--coalesce_batch",
                     "0", "--replicas", "2"])


def test_engine_matches_jax_engine(tmp_path):
    """The port's engine and the JAX package's on one reference
    checkpoint at f32: the same answers, tokens and module weights."""
    from _torch_trainers import paired_trainers
    from ekaid_tpu.serving.server import InferenceEngine as JaxEngine
    jtr, ptr, _ = paired_trainers(tmp_path)
    want_eng, got_eng = JaxEngine(jtr), InferenceEngine(ptr)
    for idx in ptr.eval_ds.split_idxs[:4]:
        for q in ("w5 w9 what", "what has changed w12", None):
            w = want_eng.answer(q, index=int(idx), detail=True)
            g = got_eng.answer(q, index=int(idx), detail=True)
            for k in ("answer", "index", "question_tokens", "tokens"):
                assert g[k] == w[k], (idx, q, k)
            np.testing.assert_allclose(g["module_weights"],
                                       w["module_weights"], atol=1e-4)
    assert got_eng.sample_info(int(idx)) == want_eng.sample_info(int(idx))
