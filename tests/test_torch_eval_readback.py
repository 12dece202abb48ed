"""`Trainer.evaluate`'s read-back: each batch's tokens are copied to the
host right behind its own decode (`utils/device.HostCopy`) and read once
the next batch is queued. The predictions equal those of a plain loop
that reads every decode back with `.cpu()` at once, on every input path,
and are made from exactly the dict that `model.decode` returned. On a
card, a batch's read waits for that batch alone, not for the work queued
after it (skipped without a CUDA device)."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ekaid_torch.config import load_config
from ekaid_torch.data.pipeline import synthetic_dataset
from ekaid_torch.data.vocab import identity_vocab
from ekaid_torch.train.train import Loader, Trainer
from ekaid_torch.utils.device import HostCopy

ROOT = Path(__file__).resolve().parent.parent
B = 4


def _cfg(mode0=False):
    cfg = load_config(str(ROOT / "configs" / "smoke.yaml"))
    cfg = cfg.replace(
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=6),
        data=cfg.data.replace(
            num_nodes=6, feature_dim=24, adj_pad=10, num_workers=2,
            eval_device_cache=8,
            test=cfg.data.test.replace(batch_size=B)),
        question=cfg.question.replace(hidden_dim=32))
    if mode0:
        cfg = cfg.replace(
            dtypes=cfg.dtypes.replace(compute_dtype="float32"),
            data=cfg.data.replace(feature_mode="mode0"),
            train=cfg.train.replace(setting="mode0"))
    return cfg


def _trainer(workdir, n_pairs, mode0=False):
    cfg = _cfg(mode0)
    ds = synthetic_dataset(cfg, "all", n_pairs=n_pairs)
    if mode0:
        pool = np.random.default_rng(5).standard_normal(
            (8, 64, 64)).astype(np.float32)
        ds.image_loader = lambda i: pool[i % 8]
    tr = Trainer(cfg, str(workdir), ds, ds,
                 identity_vocab(cfg.speaker.vocab_size), device="cpu")
    tr.model.eval()
    return tr


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Lazily built: mode2 over whole batches, mode2 with a padded last
    batch, mode0."""
    made = {}

    def get(kind):
        if kind not in made:
            n, mode0 = {"whole": (12, False), "padded": (10, False),
                        "mode0": (8, True)}[kind]
            made[kind] = _trainer(tmp_path_factory.mktemp(kind), n, mode0)
        return made[kind]
    return get


def _plain(tr, use_cache, max_batches=None, beam_size=1):
    """The predictions of a loop that reads each decode back at once, over
    the inputs `Trainer.evaluate` decodes."""
    cfg = tr.cfg
    loader = Loader(tr.eval_ds, shuffle=False, pad_final=True,
                    num_threads=cfg.data.num_workers,
                    prefetch=cfg.data.prefetch, wire=cfg.data.eval_wire)
    batches = (tr._cached_batches(loader, cfg.data.eval_device_cache)
               if use_cache else tr._wire_batches(loader))
    preds = {}
    for i, (idxs, batch) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = (tr.model.decode(batch) if beam_size == 1 else
               tr.model.decode_beam(batch, beam_size=beam_size))
        for j, row in enumerate(out["seq"].cpu().numpy()):
            preds[str(int(idxs[j]))] = tr.vocab.decode(row)
    return preds


#: (trainer, evaluate's arguments, whether its inputs come from the cache)
CASES = {
    "cache": ("whole", {"use_cache": True}, True),
    "wire": ("whole", {"use_cache": False}, False),
    "mode0": ("mode0", {}, False),
    "beam2": ("whole", {"beam_size": 2}, False),
    "max_batches": ("whole", {"max_batches": 2, "use_cache": False}, False),
    "padded": ("padded", {"use_cache": True}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_equal_a_plain_readback_loop(trainers, case):
    kind, kw, cached = CASES[case]
    tr = trainers(kind)
    n = len(tr.eval_ds)
    assert (n % B != 0) == (kind == "padded")
    _, got = tr.evaluate(**kw)
    want = _plain(tr, cached, kw.get("max_batches"), kw.get("beam_size", 1))
    assert list(got.items()) == list(want.items())
    rows = n if "max_batches" not in kw else kw["max_batches"] * B
    assert len(got) == rows


def test_predictions_are_the_tokens_decode_returned(trainers, monkeypatch):
    """A wrapped `model.decode` that returns an altered copy of the tokens:
    the predictions read the altered tokens, not the model's own."""
    tr = trainers("whole")
    V = tr.cfg.speaker.vocab_size
    inner = tr.model.decode

    def altered(batch, *args, **kwargs):
        out = dict(inner(batch, *args, **kwargs))
        seq = out["seq"].clone()
        seq[:, 0] = (seq[:, 0] + 7) % (V - 2) + 2
        out["seq"] = seq
        return out

    _, plain = tr.evaluate(use_cache=False)
    monkeypatch.setattr(tr.model, "decode", altered)
    _, got = tr.evaluate(use_cache=False)
    want = _plain(tr, False)
    assert list(got.items()) == list(want.items())
    assert all(got[k] != plain[k] for k in plain)


def _sleep_cycles_per_ms():
    torch.cuda._sleep(1_000_000)
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def test_readback_waits_for_its_own_batch_alone_on_cuda():
    """Batch i's tokens, then a long `torch.cuda._sleep` standing in for
    batch i + 1's decode: `HostCopy.wait` returns well before the sleep
    ends, while `.cpu()` after the sleep is queued waits it out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sleep_ms = 200.0
    cycles = int(sleep_ms * _sleep_cycles_per_ms())
    src = torch.randint(0, 148, (64, 90), dtype=torch.int32, device="cuda")
    HostCopy(src + 1).wait()                        # the pinned pool warm
    torch.cuda.synchronize()

    seq = src + 1
    copy = HostCopy(seq)
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    got = copy.wait()
    ours_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, (src + 1).cpu().numpy())

    seq = src + 1
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    seq.cpu()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"\nread-back wait behind a {sleep_ms:.0f} ms sleep: HostCopy "
          f"{ours_ms:.3f} ms, .cpu() {plain_ms:.3f} ms "
          f"({torch.cuda.get_device_name(0)})")
    assert ours_ms < 0.1 * sleep_ms
    assert plain_ms > 0.5 * sleep_ms
