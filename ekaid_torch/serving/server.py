"""Inference server (counterpart of `ekaid_tpu/serving/server.py`): HTTP
and JSON over the engines of `serving/engine.py` and the coalescing
engine below.

  GET  /         -> the browser demo client (serving/webui.py)
  POST /question {"question": str, "index": optional int,
                  "detail": optional bool} ->
       {"answer": str, "index": int, "latency_ms": float,
        "question_tokens": [...]}
       (+ per-token "tokens" and "module_weights" with detail)
  POST /refresh  -> {"index": int}   (a new random test pair)
  GET  /health   -> {"status": "ok", ...} (+ the coalescing stats)
  GET  /sample?index=N -> the pair's question and ground-truth answer
  GET  /image?index=N&which=main|ref -> the pair's PNG (--image_dir)

    python -m ekaid_torch.serving.server --synthetic
    python -m ekaid_torch.serving.server --checkpoint_dir <snapshots>

Concurrent requests are folded into one padded batched decode by
`CoalescingEngine` (the default; `--coalesce_batch 0` serves from the
batch-1 engine). Every decode is `EkaidModel.decode`, so K1 on the card.
It runs on the CUDA device and raises without one, unless `--device cpu`
is asked for. `--export_artifact DIR` writes a serving artifact
(`serving/artifact.py`: the inference-cast weights and the built K1, for
batch 1 and the coalescing batch) and exits; `--artifact DIR` serves
from one, in place of `--checkpoint_dir`, without running nvcc.
"""

from __future__ import annotations

import argparse
import copy
import json
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ekaid_torch.config import default_config, load_config
from ekaid_torch.serving.artifact import load_artifact, save_artifact
from ekaid_torch.serving.engine import InferenceEngine
from ekaid_torch.serving.webui import PAGE_HTML
from ekaid_torch.utils.device import resolve_device, visible_devices
from ekaid_torch.utils.dtypes import cast_params_for_inference


class CoalescingEngine(InferenceEngine):
    """Micro-batch coalescing of concurrent requests.

    Handler threads enqueue requests; one dispatcher thread folds what is
    queued (up to `coalesce_batch`, lingering `linger_ms` for stragglers)
    into one decode. A queue depth of 1 takes the batch-1 path; a deeper
    one is padded to the `coalesce_batch` bucket by repeating item 0. The
    batch is assembled on the device from the cached pair rows; only the
    [B, T] question rows are uploaded. Module weights go to the host only
    when a request of the batch asked for detail.

    Execution slots: each device appears `pipeline_depth` times, and a
    pool thread runs each folded batch; while every slot is busy, the
    dispatcher keeps folding new arrivals into the batch it holds
    (backpressure). Decodes run one at a time per device (K1 is one
    cooperative kernel over the whole card), so depth overlaps the next
    batch's fold, assembly and question upload, and the last batch's
    fetch, with the decode. `replicas` counts devices: the model is
    copied to each; asking for more than are visible raises.

    `stats` counts requests, batches, coalesced batches, the largest
    batch and batches per device; `drain` waits for the queue and every
    slot to empty. A failure reaches every future of its batch and
    leaves the dispatcher running. With an `artifact`, the bucket's
    decode is the artifact's batch-`coalesce_batch` one (raising when
    that size was not exported), on one device."""

    def __init__(self, trainer, seed: int = 0,
                 image_dir: Optional[str] = None,
                 coalesce_batch: int = 16, linger_ms: float = 2.0,
                 replicas: int = 1, pipeline_depth: int = 2,
                 artifact=None):
        if artifact is not None and replicas > 1:
            raise ValueError("replicas>1 with an artifact is not supported: "
                             "its weights and kernels load onto one device")
        super().__init__(trainer, seed=seed, image_dir=image_dir,
                         artifact=artifact)
        self._decode_n = (artifact.fn_for_batch(int(coalesce_batch))
                          if artifact is not None else self._decode1)
        self.coalesce_batch = int(coalesce_batch)
        self.linger_s = float(linger_ms) / 1e3
        self.pipeline_depth = max(1, int(pipeline_depth))
        devices = visible_devices(self.device)
        if replicas > len(devices):
            raise ValueError(f"replicas={replicas} but only "
                             f"{len(devices)} devices are visible")
        self.devices = devices[:max(1, int(replicas))]
        self._models = {self.devices[0]: self.model}
        self._locks = {self.devices[0]: self._decode_lock}
        for d in self.devices[1:]:
            self._models[d] = copy.deepcopy(self.model).to(d)
            self._locks[d] = threading.Lock()
        # warm each device's bucket and batch-1 decodes: K1's weights
        # are packed per tile width, which the batch size decides
        warm = self._gather_rows([(self.index, None)] * self.coalesce_batch)
        for d in self.devices:
            self._decode_on(d, *warm)["seq"].cpu()
            self._decode_on(d, [self._dev_sample(self.index)],
                            np.asarray(self.ds.questions[[self.index]],
                                       np.int32))["seq"].cpu()
        self.stats = {"requests": 0, "batches": 0, "coalesced": 0,
                      "max_batch": 0,
                      "per_device": {str(d): 0 for d in self.devices}}
        self._q: "queue.Queue" = queue.Queue()
        self._free: "queue.Queue" = queue.Queue()
        self._slots = len(self.devices) * self.pipeline_depth
        for _ in range(self.pipeline_depth):
            for d in self.devices:
                self._free.put(d)
        self._pool = ThreadPoolExecutor(max_workers=self._slots,
                                        thread_name_prefix="ekaid-exec")
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def _gather_rows(self, items):
        """items [(index, qids or None)] -> (the cached [1, ...] rows,
        the [B, T] int32 question rows), padded to coalesce_batch by
        repeating item 0."""
        rows, qrows = [], []
        for idx, qids in items:
            rows.append(self._dev_sample(idx))
            qrows.append(qids if qids is not None
                         else np.asarray(self.ds.questions[idx]))
        while len(rows) < self.coalesce_batch:
            rows.append(rows[0])
            qrows.append(qrows[0])
        return rows, np.stack(qrows).astype(np.int32)

    def _decode_on(self, device, rows, questions):
        """Assemble the batch on `device` from the cached rows and the
        uploaded question rows, and decode it there."""
        batch = {k: torch.cat([r[k] for r in rows]).to(device)
                 for k in rows[0]}
        batch["question"] = torch.as_tensor(questions, device=device)
        decode = self._decode1 if len(rows) == 1 else self._decode_n
        with self._locks[device]:
            return decode(self._models[device], batch)

    def _dispatch(self):
        """The folding loop (see the class docstring)."""
        while True:
            items = [self._q.get()]
            deadline = time.time() + self.linger_s
            while len(items) < self.coalesce_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            device = None
            while device is None:
                if len(items) >= self.coalesce_batch:
                    device = self._free.get()
                    break
                try:
                    device = self._free.get_nowait()
                except queue.Empty:
                    try:                    # fold while every slot is busy
                        items.append(self._q.get(timeout=0.001))
                    except queue.Empty:
                        pass
            # the dispatcher is the stats' only writer
            self.stats["batches"] += 1
            self.stats["requests"] += len(items)
            self.stats["coalesced"] += len(items) > 1
            self.stats["max_batch"] = max(self.stats["max_batch"],
                                          len(items))
            self.stats["per_device"][str(device)] += 1
            try:
                if len(items) == 1:
                    idx, qids, _, _ = items[0]
                    q = (qids if qids is not None
                         else np.asarray(self.ds.questions[idx]))
                    work = ([self._dev_sample(idx)],
                            q.astype(np.int32)[None])
                else:
                    work = self._gather_rows([(i, q) for i, q, _, _ in items])
            except Exception as e:          # report, keep serving
                self._free.put(device)
                for *_, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._pool.submit(self._execute, items, work, device)

    def _execute(self, items, work, device):
        """On a pool thread: decode one folded batch on the slot's
        device, release the slot, and resolve the batch's futures."""
        try:
            try:
                out = self._decode_on(device, *work)
                seqs = out["seq"].cpu().numpy()
                mws = (out["module_weights"].cpu().numpy()
                       if any(d for _, _, d, _ in items) else None)
            finally:
                self._free.put(device)
            for k, (idx, qids, _, fut) in enumerate(items):
                fut.set_result((seqs[k], mws[k] if mws is not None else None,
                                idx, qids))
        except Exception as e:              # report, keep serving
            for *_, fut in items:
                if not fut.done():
                    fut.set_exception(e)

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait until no request is queued and every slot is free."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self._q.empty() and self._free.qsize() == self._slots:
                return True
            time.sleep(0.05)
        return False

    def answer(self, question_text: Optional[str],
               index: Optional[int] = None, detail: bool = False) -> dict:
        idx = self.index if index is None else int(index)
        qids = self.question_to_ids(question_text) if question_text else None
        t0 = time.time()
        fut: Future = Future()
        self._q.put((idx, qids, detail, fut))
        seq, mw, idx, qids = fut.result(timeout=120)
        res = {"answer": self.vocab.decode(seq), "index": idx,
               "latency_ms": round(1000 * (time.time() - t0), 2),
               "question_tokens": (qids[qids > 0].tolist()
                                   if qids is not None else None)}
        if detail:
            res.update(self._detail_fields(seq, mw))
        return res


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                body = PAGE_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/health"):
                info = {"status": "ok", "index": engine.index,
                        "vocab_size": engine.vocab.size}
                if hasattr(engine, "stats"):
                    info["coalescing"] = dict(engine.stats)
                self._send(info)
            elif self.path.startswith("/sample"):
                q = self.path.split("index=")
                try:
                    self._send(engine.sample_info(
                        int(q[1]) if len(q) > 1 else None))
                except Exception as e:
                    self._send({"error": str(e)}, 400)
            elif self.path.startswith("/image"):
                qs = parse_qs(urlparse(self.path).query)
                try:
                    body = engine.image_bytes(
                        int(qs["index"][0]) if "index" in qs else None,
                        qs.get("which", ["main"])[0])
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except FileNotFoundError as e:
                    self._send({"error": str(e)}, 404)
            else:
                self._send({"error": "unknown path"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._send({"error": "invalid JSON body"}, 400)
            if self.path.startswith("/question"):
                text = payload.get("question")
                if not text:
                    return self._send(
                        {"error": "missing 'question' field"}, 400)
                try:
                    self._send(engine.answer(
                        text, payload.get("index"),
                        detail=bool(payload.get("detail", False))))
                except Exception as e:
                    self._send({"error": str(e)}, 500)
            elif self.path.startswith("/refresh"):
                self._send({"index": engine.refresh()})
            else:
                self._send({"error": "unknown path"}, 404)

    return Handler


class Server(ThreadingHTTPServer):
    """A listen backlog of 128: socketserver's default of 5 resets
    connections under bursts larger than the handler threads start."""
    request_queue_size = 128


def main(argv=None):
    p = argparse.ArgumentParser(description="ekaid_torch inference server")
    p.add_argument("--cfg", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--port", type=int, default=4000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--image_dir", default=None,
                   help="PNG directory for the /image endpoint")
    p.add_argument("--coalesce_batch", type=int, default=16,
                   help="micro-batch bucket for concurrent requests "
                        "(0: the plain batch-1 engine)")
    p.add_argument("--linger_ms", type=float, default=2.0,
                   help="dispatcher wait for straggler requests")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="execution slots per device")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve from N local devices (needs coalescing)")
    p.add_argument("--export_artifact", default=None, metavar="DIR",
                   help="save a serving artifact (the inference-cast "
                        "weights and the built decode kernel, for batch 1 "
                        "and the coalescing batch) to DIR, then exit "
                        "(serving/artifact.py)")
    p.add_argument("--artifact", default=None, metavar="DIR",
                   help="serve from an artifact: no nvcc at startup; the "
                        "weights come from it (overrides --checkpoint_dir)")
    p.add_argument("--workdir", default="build/ekaid_serve")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    a = p.parse_args(argv)
    if a.coalesce_batch <= 0 and a.replicas > 1:
        raise SystemExit("--replicas requires coalescing "
                         "(--coalesce_batch > 0)")
    device = resolve_device(a.device)

    from ekaid_torch.train.train import build_synthetic_trainer, build_trainer
    from ekaid_torch.utils.checkpoint import CheckpointManager
    cfg = load_config(a.cfg) if a.cfg else default_config()
    if a.synthetic:
        trainer = build_synthetic_trainer(cfg, a.workdir, device=device)
    else:
        trainer = build_trainer(cfg, a.workdir, "test", device=device)
    if a.checkpoint_dir and not a.artifact:
        CheckpointManager(a.checkpoint_dir).restore(trainer.state,
                                                    name=a.checkpoint)
        print(f"loaded checkpoint step {int(trainer.state.step)}")

    if a.export_artifact:
        model = cast_params_for_inference(trainer.model, trainer.model.policy)
        sample = {k: v for k, v in trainer.eval_ds.sample(
            int(trainer.eval_ds.split_idxs[0])).items() if k != "pair_index"}
        sizes = (1, a.coalesce_batch) if a.coalesce_batch > 0 else (1,)
        save_artifact(a.export_artifact, model, sample, batch_sizes=sizes)
        print(f"exported artifact to {a.export_artifact} "
              f"(batch sizes {sorted(set(sizes))})")
        return

    artifact = None
    if a.artifact:
        artifact = load_artifact(a.artifact, device)
        print(f"loaded artifact from {a.artifact} (platform "
              f"{artifact.meta['platform']}, batch sizes "
              f"{artifact.meta['batch_sizes']})")
    if a.coalesce_batch > 0:
        engine: InferenceEngine = CoalescingEngine(
            trainer, image_dir=a.image_dir,
            coalesce_batch=a.coalesce_batch, linger_ms=a.linger_ms,
            replicas=a.replicas, pipeline_depth=a.pipeline_depth,
            artifact=artifact)
    else:
        engine = InferenceEngine(trainer, image_dir=a.image_dir,
                                 artifact=artifact)
    server = Server((a.host, a.port), make_handler(engine))

    # graceful shutdown: stop accepting, then drain the decodes in flight
    import signal

    def _shutdown(signum, frame):
        print(f"signal {signum}: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    print(f"serving on http://{a.host}:{server.server_address[1]} "
          f"(speaker.decode_kernel {engine.decode_kernel!r})", flush=True)
    server.serve_forever()
    server.server_close()
    if hasattr(engine, "drain"):
        print("drained cleanly" if engine.drain() else "drain timed out")


if __name__ == "__main__":
    main()
