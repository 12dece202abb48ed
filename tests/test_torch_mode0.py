"""ekaid_torch's pixels-in mode0 encoder against the JAX package at f32:
`SelfAttention` (SSRE), the R101 `PixelEncoder`, the whole mode0
`EkaidModel` (encoder outputs, attention maps, teacher-forced
logprobs, greedy tokens), one training step's gradients (dropout off),
the mode0 dataset, and a mode0 snapshot written by the JAX `Trainer`
read through `utils/orbax_import.py`.

The JAX mode0 model (an R101 trunk) compiles slowly on the CPU, so it
is initialised once and run in one jitted forward-and-gradient (the
trunk's outputs captured there) and one jitted decode. Widths are the
reference's own mode0 test's (att_dim 32), on 64^2 images (2 x 2
cells).

The trunk's f32 gradients: f32 rounding flips the sign of a few of
the ~2.4 million ReLU inputs an image passes through in the R101 trunk
(3 in the port's f32 step at these inputs, against its own step with
every cast promoted to f64), and each flip moves the gradients of the
layers below it by up to ~2e-3 of a tensor's largest magnitude; which
ReLUs flip depends on each package's rounding. So the port's gradient
math is held in f64: its f64 step's gradients within GRAD_TOL of the
reference's f32 gradients, every tensor (at these images the
reference's f32 step flips no ReLU: it stands within 2.1e-5 of the f64
step). The port's f32 step is held to GRAD_TOL of the reference's
outside the trunk and to TRUNK_GRAD_TOL inside it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data import pipeline as jpipe
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import ekaid as jax_ekaid
from ekaid_tpu.models.change_detector import PixelEncoder as JaxPixel
from ekaid_tpu.models.change_detector import SelfAttention as JaxSelfAtt
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import as_torch, flatten, load_flax_params
from ekaid_torch.data import pipeline as ppipe
from ekaid_torch.models.change_detector import SelfAttention
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train.step import init_state, train_step
from ekaid_torch.utils.dtypes import F32, Policy

F64 = Policy(param_dtype=torch.float64, compute_dtype=torch.float64,
             softmax_dtype=torch.float64)

B, S = 2, 64
ATT_RTOL = 1e-5        # SelfAttention, of the output's largest magnitude
ENC_RTOL = 1e-4        # the trunk and the encoder outputs, of max|x|
LP_ATOL = 1e-4         # teacher-forced logprobs
GRAD_TOL = 1e-4        # of each gradient tensor's largest magnitude
#: as tests/test_torch_train_model.py: a tensor whose gradient is under
#: this share of the largest of all is held to GRAD_TOL of that share
GRAD_FLOOR = 1e-3
ATT_REG = 2.5e-3
#: the port's f32 trunk gradients against the reference's, of each
#: tensor's largest magnitude (the ReLU flips above)
TRUNK_GRAD_TOL = 1e-2
IMAGE_SEED = 3


def mode0_cfg():
    """tests/test_pipeline.py::test_mode0_dataset_and_training's widths,
    at f32, both knobs set."""
    cfg = tiny_cfg()
    return cfg.replace(
        dtypes=cfg.dtypes.replace(compute_dtype="float32"),
        data=cfg.data.replace(feature_mode="mode0"),
        train=cfg.train.replace(setting="mode0"),
        change_detector=cfg.change_detector.replace(
            att_dim=32, att_head=4, dim=8, pos_emb_dim=16),
        speaker=cfg.speaker.replace(
            input_dim=32, rnn_size=16, embed_input_dim=96, embed_dim=32,
            word_embed_size=8, seq_length=10),
        question=cfg.question.replace(hidden_dim=32))


def images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, S, S)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """The reference model's params, and from one jitted call its loss,
    outputs, gradients (dropout off) and the trunk's outputs; its greedy
    decode."""
    cfg = mode0_cfg()
    batch = {k: v for k, v in synthetic_batch(cfg, B, seed=0).items()
             if k in ("question", "labels", "masks")}
    img = images(2 * B, seed=IMAGE_SEED)
    batch["d_feats"], batch["q_feats"] = img[:B], img[B:]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)

    def loss_fn(params):
        out, state = flax.apply(
            params, jb, train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, name: (
                isinstance(m, JaxPixel) and name == "__call__"))
        loss, aux = jax_ekaid.total_loss(out, jb, ATT_REG)
        return loss, (out, state["intermediates"])

    (loss, (out, inter)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, tree))
    dec = jax.jit(lambda p: flax.apply(p, jb, method="decode",
                                       sample_max=True))(
        jax.tree.map(jnp.asarray, tree))
    pix = inter["change_detector"]["extractor"]["__call__"]
    return {"cfg": cfg, "batch": batch, "tree": tree, "loss": float(loss),
            "out": jax.tree.map(np.asarray, out),
            "pixels": [np.asarray(p) for p in pix],
            # conv kernels in the port's OIHW layout
            "grads": {k: as_torch(v).numpy() for k, v in flatten(
                jax.tree.map(np.asarray, grads)["params"]).items()},
            "seq": np.asarray(dec["seq"])}


def port_model(setup):
    return load_flax_params(
        EkaidModel(port_cfg(setup["cfg"]), NTOKEN, policy=F32, device="cpu",
                   seed=None), setup["tree"])


def rel_err(got, want):
    return np.abs(to_np(got) - want).max() / np.abs(want).max()


def test_self_attention_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6, 40)).astype(np.float32)
    flax = JaxSelfAtt(32, 4, policy=JF32)
    tree = init_flax(flax, x, x, x)
    want = np.asarray(flax.apply(tree, x, x, x))
    port = load_flax_params(SelfAttention(40, 32, 4, policy=F32), tree)
    t = torch.from_numpy(x)
    with torch.no_grad():
        got = port(t, t, t)
    assert got.shape == (3, 6, 32)
    assert rel_err(got, want) <= ATT_RTOL


def test_pixel_encoder_matches_jax(setup):
    """The R101 trunk + fc_reshape on both images: [B, 4, att_dim], the
    2 x 2 cells in (h, w) order."""
    model = port_model(setup)
    b = setup["batch"]
    with torch.no_grad():
        for key, want in zip(("d_feats", "q_feats"), setup["pixels"]):
            got = model.change_detector.extractor(torch.from_numpy(b[key]))
            assert tuple(got.shape) == want.shape == (B, 4, 32)
            assert rel_err(got, want) <= ENC_RTOL, key


def test_mode0_model_matches_jax(setup):
    model = port_model(setup)
    b = setup["batch"]
    assert set(model.tensors(b)) == {"d_feats", "q_feats", "question"}
    with torch.no_grad():
        got = model(b)
    want = setup["out"]
    for k in ("feat_bef", "feat_aft", "feat_diff", "att_bef", "att_aft",
              "pred"):
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= ENC_RTOL, k
    assert got["att_bef"].shape == (B, 1, 4)
    np.testing.assert_allclose(to_np(got["logprobs"]), want["logprobs"],
                               atol=LP_ATOL, rtol=0)
    seq = model.decode(b)["seq"].numpy()
    np.testing.assert_array_equal(seq, setup["seq"])


def _step_grads(setup, f64=False):
    """(loss, {name: gradient}) of one port `train_step` (train=False:
    no dropout, as the reference's loss here), at f32 or with every
    cast promoted to f64."""
    model = port_model(setup)
    batch = dict(setup["batch"])
    if f64:
        for m in model.modules():
            if hasattr(m, "policy"):
                m.policy = F64
        model.double()
        for k in ("d_feats", "q_feats"):
            batch[k] = batch[k].astype(np.float64)
    state = init_state(model, port_cfg(setup["cfg"]).train.optim)
    m = train_step(state, batch, 0, ATT_REG, train=False)
    return float(m["total_loss"]), {
        n: (p.grad if p.grad is not None else torch.zeros_like(p)
            ).double().numpy() for n, p in model.named_parameters()}


def test_mode0_train_step_gradients_match_jax(setup):
    """One `train_step` against `jax.value_and_grad` of the same loss
    (see the module docstring for the trunk)."""
    loss, got = _step_grads(setup)
    _, exact = _step_grads(setup, f64=True)
    assert abs(loss - setup["loss"]) <= 1e-5 * abs(setup["loss"])
    want = setup["grads"]
    assert set(want) == set(got)
    top = max(np.abs(v).max() for v in want.values())
    for n, w in want.items():
        scale = max(np.abs(w).max(), GRAD_FLOOR * top)
        err64 = np.abs(exact[n] - w).max()
        assert err64 <= GRAD_TOL * scale, f"{n} (f64): {err64}"
        tol = TRUNK_GRAD_TOL if ".extractor.trunk." in n else GRAD_TOL
        err = np.abs(got[n] - w).max()
        assert err <= tol * scale, f"{n}: {err} > {tol * scale}"


def _datasets(cfg=None):
    cfg = cfg or mode0_cfg()
    pool = images(8, seed=5)
    jds = jpipe.synthetic_dataset(cfg, "train", n_pairs=16)
    jds.image_loader = lambda i: pool[i % 8]
    pds = ppipe.synthetic_dataset(port_cfg(cfg), "train", n_pairs=16)
    pds.image_loader = lambda i: pool[i % 8]
    return jds, pds


def test_mode0_dataset_matches_jax():
    jds, pds = _datasets()
    for i in range(4):
        want, got = jds.sample(i), pds.sample(i)
        assert set(got) == set(want)
        assert not {"d_adj", "q_adj", "d_sem_adj", "q_sem_adj", "d_bb",
                    "q_bb"} & set(got)
        assert got["d_feats"].shape == (S, S)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jb = list(jpipe.Loader(jds, batch_size=4, shuffle=True, seed=1))
    pb = list(ppipe.Loader(pds, batch_size=4, shuffle=True, seed=1))
    assert len(pb) == len(jb) > 0
    for want, got in zip(jb, pb):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pds.image_loader = None
    with pytest.raises(ValueError, match="image_loader"):
        pds.sample(0)


def test_mode0_snapshot_from_the_jax_trainer(setup, tmp_path, monkeypatch):
    """The reference's `Trainer` on the mode0 dataset (its init replaced
    by the fixture's params) writes a snapshot; the port's `Trainer`
    restores it through orbax_import, evaluates without the device
    cache, and decodes the reference's tokens."""
    from ekaid_tpu.train import train as jtrain
    from ekaid_torch.train.train import Trainer
    from ekaid_torch.data.vocab import identity_vocab

    cfg = setup["cfg"]
    cfg = cfg.replace(data=cfg.data.replace(
        train=cfg.data.train.replace(batch_size=B),
        test=cfg.data.test.replace(batch_size=B)))
    vocab = jtrain.identity_vocab(cfg.speaker.vocab_size)
    assert len(vocab.word_to_idx) == NTOKEN
    jds, pds = _datasets(cfg)
    tree = jax.tree.map(jnp.asarray, setup["tree"])

    def given_init(model, tx, batch, rng):
        from ekaid_tpu.train.step import TrainState
        return TrainState(step=jnp.zeros((), jnp.int32), params=tree,
                          opt_state=tx.init(tree))

    monkeypatch.setattr(jtrain, "init_state", given_init)
    jtr = jtrain.Trainer(cfg, str(tmp_path / "jax"), jds, jds, vocab)
    jtr.ckpt.save(jtr.state, config_dict=cfg.to_dict())

    pcfg = port_cfg(cfg)
    pcfg = pcfg.replace(data=pcfg.data.replace(eval_device_cache=16))
    ptr = Trainer(pcfg, str(tmp_path / "port"), pds, pds,
                  identity_vocab(cfg.speaker.vocab_size), device="cpu")
    ptr.ckpt.__class__(str(tmp_path / "jax" / "snapshots")).restore(
        ptr.state)
    want = flatten(setup["tree"]["params"])
    for n, p in ptr.model.named_parameters():
        np.testing.assert_array_equal(to_np(p), as_torch(want[n]).numpy(),
                                      err_msg=n)
    seq = ptr.model.decode(setup["batch"])["seq"].numpy()
    np.testing.assert_array_equal(seq, setup["seq"])
    scores, preds = ptr.evaluate(max_batches=1)    # the cache is skipped
    assert len(preds) > 0 and ptr._eval_cache is None


def test_device_cache_refuses_mode0():
    from ekaid_torch.data.device_cache import DeviceEvalCache
    _, pds = _datasets()
    with pytest.raises(ValueError, match="graph features, not raw pixels"):
        DeviceEvalCache(pds, capacity=4, device="cpu")
