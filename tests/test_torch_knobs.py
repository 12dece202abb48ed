"""ekaid_torch's eval knobs against the JAX package, on the CPU at f32:
`change_detector.pair_batch`, `speaker.weight_quant='int8'`
(`models/quant.py`), `speaker.fused_core` and `speaker.decode_kernel`.

Tolerances:
  * pair_batch, eval: 'on' and 'train' against the port's 'off' within
    PAIR_RTOL of each output's largest magnitude (the two passes differ
    only in the rows a GEMM blocks together); against JAX's 'on' at the
    encoder's atol = rtol = 1e-4 (`tests/test_torch_encoder.py`).
  * pair_batch, gradients in eval mode: 'on' against the port's 'off'
    at the reference's own gate (loss 1e-7 relative, gradients rtol
    1e-5 atol 1e-7, `tests/test_model.py`); against JAX's 'on' at the
    training tests' gate (loss 1e-5 relative, each gradient within 1e-4
    of its largest magnitude, floor 1e-3 of the largest of all).
  * 'train' equals 'on' bit for bit under one generator state.
  * quantize_matrix: q and scale bit-equal to JAX's; |w - q s| <= s / 2.
  * the int8 step: the dequantized weights bit-equal to JAX's; the step
    bit-equal to the port's own core on those weights; within STEP_TOL
    of JAX's int8 step; within the reference's 5e-2 of the unquantized
    step.
  * decodes through the torch loop (decode_kernel='xla'), int8, fused
    (the port runs the core's step, JAX its merged products) and plain,
    against JAX's: tokens exact, logprobs within LP_TOL.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import ekaid as jax_ekaid
from ekaid_tpu.models import quant as jquant
from ekaid_tpu.models.decoder import DynamicSpeaker as JaxSpeaker
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import load_config
from ekaid_torch.convert import flatten, load_flax_params
from ekaid_torch.models import ekaid as port_ekaid
from ekaid_torch.models import quant
from ekaid_torch.models.decoder import DynamicSpeaker, greedy_path
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.utils.platform import resolve_decode_kernel

PAIR_RTOL = 1e-6
ENC_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-3
STEP_TOL = 1e-5
QUANT_TOL = 5e-2
LP_TOL = 1e-4
B = 6
#: the reference's mid dims, where every large core matrix crosses
#: QUANT_MIN_ELEMS
MID = dict(input_dim=256, rnn_size=128, embed_dim=256, embed_input_dim=768)
OUTPUTS = ("logprobs", "pos_logprobs", "module_weights", "pred", "att_bef",
           "att_aft", "feat_bef", "feat_aft", "feat_diff")


def _f32(cfg, pair="off", **speaker):
    return cfg.replace(
        dtypes=cfg.dtypes.replace(compute_dtype="float32"),
        change_detector=cfg.change_detector.replace(pair_batch=pair),
        speaker=cfg.speaker.replace(**speaker))


# ------------------------------------------------------------ pair_batch ---

@pytest.fixture(scope="module")
def pair_setup():
    """The reference's params at the smoke dims and its eval-mode
    outputs, loss and gradients with pair_batch 'on'."""
    cfg = _f32(tiny_cfg())
    batch = synthetic_batch(cfg, 3, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=True)
    flax = JaxModel(_f32(tiny_cfg(), "on"), ntoken=NTOKEN, policy=JF32)

    def loss_fn(params):
        out = flax.apply(params, jb, train=False)
        return jax_ekaid.total_loss(out, jb, 2.5e-3)[0], out

    (loss, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    ref = (float(loss), jax.tree.map(np.asarray, out),
           flatten(jax.tree.map(np.asarray, g)["params"]))
    return cfg, batch, tree, ref


def _port(tree, pair, **speaker):
    return load_flax_params(EkaidModel(port_cfg(_f32(tiny_cfg(), pair,
                                                     **speaker)),
                                       NTOKEN, device="cpu", seed=None),
                            tree)


def _loss_and_grads(model, batch):
    out = model(batch)
    loss = port_ekaid.total_loss(out, model.tensors(batch, train=True),
                                 2.5e-3)[0]
    loss.backward()
    return float(loss.detach()), out, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()}


@pytest.mark.parametrize("pair", ["on", "train", True])
def test_pair_batch_eval_matches_two_passes_and_jax(pair_setup, pair):
    cfg, batch, tree, ref = pair_setup
    with torch.no_grad():
        off = _port(tree, "off")(batch)
        got = _port(tree, pair)(batch)
    for k in OUTPUTS:
        top = float(off[k].abs().max())
        err = float((got[k] - off[k]).abs().max())
        assert err <= PAIR_RTOL * top, f"{k}: {err} vs the two passes"
        np.testing.assert_allclose(to_np(got[k]), ref[1][k], **ENC_TOL,
                                   err_msg=k)


def test_pair_batch_gradients_match_two_passes_and_jax(pair_setup):
    cfg, batch, tree, (loss_w, _, grads_w) = pair_setup
    loss_off, _, g_off = _loss_and_grads(_port(tree, "off"), batch)
    loss_on, _, g_on = _loss_and_grads(_port(tree, "on"), batch)
    assert abs(loss_on - loss_off) <= 1e-7 * abs(loss_off)
    for n, g in g_on.items():
        np.testing.assert_allclose(to_np(g), to_np(g_off[n]), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    assert abs(loss_on - loss_w) <= LOSS_RTOL * abs(loss_w)
    top = max(np.abs(v).max() for v in grads_w.values())
    for n, w in grads_w.items():
        scale = GRAD_TOL * max(np.abs(w).max(), GRAD_FLOOR * top)
        err = np.abs(to_np(g_on[n]) - w).max()
        assert err <= scale, f"{n}: {err} > {scale}"


def test_pair_batch_train_equals_on_under_one_generator(pair_setup):
    """In training mode 'train' takes the [2B] pass, drawing one [2B]
    dropout mask a site: the same draws as 'on'; 'off' draws others."""
    cfg, batch, tree, _ = pair_setup
    outs = {}
    for pair in ("on", "train", "off"):
        model = _port(tree, pair)
        model.train()
        outs[pair] = model(batch, gen=torch.Generator().manual_seed(5))
    for k in OUTPUTS:
        assert torch.equal(outs["train"][k], outs["on"][k]), k
    assert not torch.equal(outs["off"]["feat_diff"], outs["on"]["feat_diff"])


def test_config_accepts_the_reference_values_only():
    for v, want in (("off", "off"), ("on", "on"), ("train", "train"),
                    (True, "on"), (False, "off"), ("True", "on")):
        c = load_config(overrides={"change_detector": {"pair_batch": v}})
        assert c.change_detector.pair_batch == want
    for section, key, value in (("change_detector", "pair_batch", "both"),
                                ("speaker", "weight_quant", "int4"),
                                ("speaker", "decode_kernel", "cuda")):
        with pytest.raises(ValueError, match=key):
            load_config(overrides={section: {key: value}})
    for k in ("auto", "xla", "pallas", "pallas_interpret"):
        assert load_config(overrides={"speaker": {"decode_kernel": k}})
    assert load_config(overrides={"speaker": {"weight_quant": "int8"}})


# ------------------------------------------------------------------ int8 ---

def test_quantize_matrix_matches_jax_and_its_error_bound():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((300, 200)) * 0.3).astype(np.float32)
    w[:, 7] = 0.0                                   # scale 1 there
    w[3, 9] = 0.5 * np.abs(w[:, 9]).max() / 127.0 * 127.0  # a tie or two
    q, s = quant.quantize_matrix(torch.from_numpy(w))
    jq, js = jquant.quantize_matrix(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[7] == 1.0 and (q[:, 7] == 0).all()
    err = np.abs(w - q.numpy().astype(np.float32) * s.numpy())
    assert (err <= s.numpy()[None, :] / 2 + 1e-7).all()


def _speaker(speaker=None, seed=0, **extra):
    """A reference speaker and the port's on its params, and B rows of
    (bef, aft, diff) features."""
    cfg = tiny_cfg()
    cfg = cfg.replace(speaker=cfg.speaker.replace(**(speaker or {}),
                                                  **extra))
    sp = cfg.speaker
    rng = np.random.default_rng(seed)
    feats = tuple(rng.standard_normal((B, sp.input_dim)).astype(np.float32)
                  for _ in range(3))
    flax = JaxSpeaker(sp, policy=JF32)
    tree = init_flax(flax, *map(jnp.asarray, feats), sample_max=True,
                     method="sample")
    port = load_flax_params(DynamicSpeaker(port_cfg(cfg).speaker), tree)
    return cfg, flax, tree, port, feats


def _step_inputs(cfg, seed=3):
    sp = cfg.speaker
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (r(B, sp.word_embed_size), r(B, sp.embed_dim),
            r(B, 3, sp.input_dim), [r(B, sp.rnn_size) * 0.5
                                    for _ in range(4)])


def _jax_state(state):
    return dict(zip(("h_mod", "c_mod", "h_lang", "c_lang"),
                    map(jnp.asarray, state)))


def _assert_steps(got, want, tol, what):
    (h, st, d, m), (hw, stw, dw, mw) = got, want
    pairs = [(h, hw), (d, dw), (m, mw)] + list(zip(
        st, [stw[k] for k in ("h_mod", "c_mod", "h_lang", "c_lang")]))
    for a, b in pairs:
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=tol,
                                   rtol=0, err_msg=what)


def test_quant_core_step_matches_jax_at_mid_dims():
    cfg, _, tree, port, _ = _speaker(MID)
    core_p = jax.tree.map(jnp.asarray, tree["params"]["core"])
    assert any(v.ndim == 2 and v.size >= quant.QUANT_MIN_ELEMS
               for sub in core_p.values() for v in sub.values())
    xt, fused, feats, state = _step_inputs(cfg)
    targs = (torch.from_numpy(xt), torch.from_numpy(fused),
             torch.from_numpy(feats), tuple(map(torch.from_numpy, state)))
    jargs = (jnp.asarray(xt), jnp.asarray(fused), jnp.asarray(feats),
             _jax_state(state))
    got = quant.make_quant_core_step(port.core, port.policy)(*targs)
    want = jquant.make_quant_core_step(core_p, cfg.speaker, JF32)(*jargs)
    _assert_steps(got, want, STEP_TOL, "int8 step vs JAX's")

    # the dequantized weights are JAX's, bit for bit, and on them the
    # int8 step is the port's own core step, bit for bit
    deq = copy.deepcopy(port.core)
    qp = quant.quantize_core_params(port.core, port.policy)
    jqp = jquant.quantize_core_params(core_p, JF32)
    with torch.no_grad():
        for name, p in deq.named_parameters():
            if isinstance(qp[name], tuple):
                w = qp[name][0].float() * qp[name][1]
                jq, js = jqp[name]
                np.testing.assert_array_equal(
                    w.numpy(), np.asarray(jq.astype(jnp.float32) * js))
                p.copy_(w)
    ref = deq(*targs)
    for a, b in zip(got[:1] + got[2:] + got[1], ref[:1] + ref[2:] + ref[1]):
        assert torch.equal(a, b)

    module = jax.tree.map(np.asarray, JaxSpeaker(cfg.speaker, JF32).apply(
        {"params": tree["params"]}, *jargs, method=lambda s, *a: s.core(
            *a, drop_key=None)))
    _assert_steps(got, module, QUANT_TOL, "int8 step vs the unquantized")


@pytest.mark.parametrize("knob", [{"weight_quant": "int8"},
                                  {"fused_core": True}, {}],
                         ids=["int8", "fused", "plain"])
def test_greedy_loop_with_knobs_matches_jax(knob):
    """decode_kernel='xla' on both sides, mid dims: tokens exact,
    logprobs and module weights within LP_TOL."""
    cfg, flax, tree, port, feats = _speaker(MID, decode_kernel="xla",
                                            **knob)
    want = flax.apply(jax.tree.map(jnp.asarray, tree),
                      *map(jnp.asarray, feats), sample_max=True,
                      method="sample")
    got = port.sample(*map(torch.from_numpy, feats))
    np.testing.assert_array_equal(to_np(got["seq"]), np.asarray(want["seq"]))
    for k in ("logprobs", "module_weights"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                   atol=LP_TOL, rtol=0, err_msg=k)


def test_int8_at_tiny_dims_equals_the_unquantized_decode():
    """No tiny core matrix crosses QUANT_MIN_ELEMS: the int8 loop is the
    plain loop exactly (the step's wiring), greedy and multinomial."""
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg, 4, seed=8)
    outs = {}
    for wq in ("none", "int8"):
        c = port_cfg(_f32(cfg, decode_kernel="xla", weight_quant=wq))
        model = EkaidModel(c, NTOKEN, device="cpu", seed=0)
        assert not any(p.dim() == 2 and p.numel() >= quant.QUANT_MIN_ELEMS
                       for p in model.speaker.core.parameters())
        g = torch.Generator().manual_seed(1)
        outs[wq] = (model.decode(batch),
                    model.decode(batch, sample_max=False, gen=g))
    for a, b in zip(outs["none"], outs["int8"]):
        for k in ("seq", "logprobs", "module_weights"):
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------- decode_kernel ---

def test_resolve_decode_kernel():
    assert resolve_decode_kernel("auto") == "pallas"
    for k in ("xla", "pallas", "pallas_interpret"):
        assert resolve_decode_kernel(k) == k
    with pytest.raises(ValueError, match="decode_kernel"):
        resolve_decode_kernel("triton")


@pytest.mark.parametrize("kernel", ["auto", "pallas", "pallas_interpret"])
@pytest.mark.parametrize("knob", [{"weight_quant": "int8"},
                                  {"fused_core": True}])
def test_kernel_paths_refuse_the_knobs(kernel, knob):
    """As the reference: a knob with any kernel name raises, greedy or
    multinomial, and the message names the loop's setting."""
    c = port_cfg(_f32(tiny_cfg(), decode_kernel=kernel, **knob))
    model = EkaidModel(c, NTOKEN, device="cpu", seed=0)
    batch = synthetic_batch(tiny_cfg(), 2, seed=1)
    for kw in ({}, {"sample_max": False, "gen": torch.Generator()}):
        with pytest.raises(ValueError, match="decode_kernel='xla'"):
            model.decode(batch, **kw)
    with pytest.raises(ValueError, match="weight_quant"):
        greedy_path(c.speaker, torch.device("cpu"))


def test_greedy_paths_by_name_and_device(monkeypatch):
    """'auto'/'pallas' and 'pallas_interpret' run greedy_decode (the
    plain twin on the CPU; 'pallas_interpret' refuses a CUDA device),
    'xla' the torch loop, which never calls greedy_decode; all give the
    same tokens at f32."""
    sp = port_cfg(tiny_cfg()).speaker
    for k in ("auto", "pallas", "pallas_interpret"):
        assert greedy_path(sp.replace(decode_kernel=k),
                           torch.device("cpu")) == "kernel"
    assert greedy_path(sp.replace(decode_kernel="auto"),
                       torch.device("cuda")) == "kernel"
    for dev in ("cpu", "cuda"):
        assert greedy_path(sp.replace(decode_kernel="xla", fused_core=True),
                           torch.device(dev)) == "loop"
    with pytest.raises(ValueError, match="CPU tensors only"):
        greedy_path(sp.replace(decode_kernel="pallas_interpret"),
                    torch.device("cuda"))

    from ekaid_torch.models import decoder
    batch = synthetic_batch(tiny_cfg(), 4, seed=2)
    seqs, calls = {}, []
    real = decoder.greedy_decode
    monkeypatch.setattr(decoder, "greedy_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    samples = {}
    for k in ("auto", "pallas_interpret", "xla"):
        model = EkaidModel(port_cfg(_f32(tiny_cfg(), decode_kernel=k)),
                           NTOKEN, device="cpu", seed=0)
        seqs[k] = model.decode(batch)["seq"]
        samples[k] = model.decode(batch, sample_max=False,
                                  gen=torch.Generator().manual_seed(3))
    assert len(calls) == 2            # multinomial decodes run the loop
    assert torch.equal(seqs["auto"], seqs["pallas_interpret"])
    assert torch.equal(seqs["auto"], seqs["xla"])
    for k in ("auto", "pallas_interpret"):
        assert torch.equal(samples[k]["logprobs"], samples["xla"]["logprobs"])


def test_trainer_resolves_and_logs_the_decode_kernel(tmp_path, capsys):
    from ekaid_torch.train.train import build_synthetic_trainer
    cfg = load_config(str(Path(__file__).resolve().parent.parent
                          / "configs" / "smoke.yaml"))
    tr = build_synthetic_trainer(cfg, str(tmp_path), n_pairs=16,
                                 device="cpu")
    assert tr.cfg.speaker.decode_kernel == "pallas"
    assert "speaker.decode_kernel 'auto' -> 'pallas'" in capsys.readouterr().err
