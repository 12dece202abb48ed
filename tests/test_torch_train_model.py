"""ekaid_torch training path of the model: teacher forcing, the losses and
their gradients against the JAX package at f32 (dropout off), the remat
choices, training-mode dropout and scheduled sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import ekaid as jax_ekaid
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import flatten, load_flax_params
from ekaid_torch.models import ekaid as port_ekaid
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.models.layers import dropout, frobenius
from ekaid_torch.train.step import generator

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of each gradient tensor's largest magnitude
#: a tensor whose gradient is under this share of the largest gradient of
#: all is held to GRAD_TOL of that share. Some gradients are zero in
#: exact arithmetic (a softmax is invariant to the key biases, to the
#: score head's bias and to the implicit relation's label bias over its
#: all-ones adjacency), others nearly so; both packages give rounding
#: noise there.
GRAD_FLOOR = 1e-3


def _f32_cfg(**speaker):
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"),
                       speaker=cfg.speaker.replace(**speaker))


@pytest.fixture(scope="module")
def setup():
    """The reference model's params (init at f32, B=3 batch) and its
    loss, aux, outputs and gradients with entropy weight 0.1, dropout
    off, for train_hoist off and on."""
    cfg = _f32_cfg()
    batch = synthetic_batch(cfg, 3, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=True)
    ref = {}
    for hoist in (False, True):
        c = _f32_cfg(train_hoist=hoist)
        flax = JaxModel(c, ntoken=NTOKEN, policy=JF32)

        def loss_fn(params, ew):
            out = flax.apply(params, jb, train=False)
            loss, aux = jax_ekaid.total_loss(out, jb, 2.5e-3,
                                             entropy_weight=ew)
            return loss, (aux, out)

        for ew in (0.0, 0.1):
            (loss, (aux, out)), g = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True), static_argnums=1)(
                    jax.tree.map(jnp.asarray, tree), ew)
            ref[hoist, ew] = (float(loss), jax.tree.map(np.asarray, aux),
                              jax.tree.map(np.asarray, out),
                              flatten(jax.tree.map(np.asarray, g)["params"]))
    return cfg, batch, tree, ref


def _port(cfg, tree, **speaker):
    c = port_cfg(cfg)
    c = c.replace(speaker=c.speaker.replace(**speaker))
    return load_flax_params(EkaidModel(c, NTOKEN, device="cpu", seed=None),
                            tree)


def _port_loss(model, batch, ew=0.0, **kw):
    out = model(batch, **kw)
    loss, aux = port_ekaid.total_loss(out, model.tensors(batch, train=True),
                                      2.5e-3, entropy_weight=ew)
    return loss, aux, out


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _assert_grads(got, want):
    top = max(np.abs(v).max() for v in want.values())
    for n, w in want.items():
        scale = GRAD_TOL * max(np.abs(w).max(), GRAD_FLOOR * top)
        err = np.abs(to_np(got[n]) - w).max()
        assert err <= scale, f"{n}: {err} > {scale}"


@pytest.mark.parametrize("hoist", [False, True])
def test_teacher_forcing_matches_jax(setup, hoist):
    cfg, batch, tree, ref = setup
    want = ref[hoist, 0.0][2]
    with torch.no_grad():
        got = _port(cfg, tree, train_hoist=hoist)(batch)
    for k in ("logprobs", "pos_logprobs", "module_weights", "att_bef",
              "feat_diff"):
        np.testing.assert_allclose(to_np(got[k]), want[k], atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("ew", [0.0, 0.1])
def test_loss_and_grads_match_jax(setup, hoist, ew):
    cfg, batch, tree, ref = setup
    loss_w, aux_w, _, grads_w = ref[hoist, ew]
    model = _port(cfg, tree, train_hoist=hoist)
    loss, aux, _ = _port_loss(model, batch, ew)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - loss_w) <= LOSS_RTOL * abs(loss_w)
    assert set(aux) == set(aux_w)
    for k, v in aux.items():
        assert abs(float(v.detach()) - float(aux_w[k])) <= LOSS_RTOL * abs(
            float(aux_w[k])), k
    _assert_grads(_grads(model), grads_w)
    # the frozen embedding copy takes no gradient
    fixed = model.change_detector.question.WordEmbedding_0.emb_fixed
    assert fixed.grad is None and not fixed.requires_grad


def test_loss_terms_match_jax():
    rng = np.random.default_rng(3)
    logp = np.log(rng.dirichlet(np.ones(7), (4, 5))).astype(np.float32)
    targets = rng.integers(0, 7, (4, 6)).astype(np.int32)
    masks = (rng.random((4, 6)) < 0.7).astype(np.float32)
    mw = rng.dirichlet(np.ones(3), (4, 5)).astype(np.float32)
    seq = rng.integers(0, 3, (4, 5)).astype(np.int32)
    reward = rng.standard_normal((4, 5)).astype(np.float32)
    taken = rng.standard_normal((4, 5)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (port_ekaid.language_model_loss(t(logp), t(targets), t(masks)),
         jax_ekaid.language_model_loss(logp, targets, masks)),
        (port_ekaid.language_model_loss(t(logp), t(targets), t(masks),
                                        denom=7.0),
         jax_ekaid.language_model_loss(logp, targets, masks, denom=7.0)),
        (port_ekaid.attention_regularizer(t(mw), t(mw), batch=8),
         jax_ekaid.attention_regularizer(mw, mw, batch=8)),
        (port_ekaid.entropy_loss(t(mw), t(masks)),
         jax_ekaid.entropy_loss(mw, masks)),
        (port_ekaid.reward_loss(t(taken), t(seq), t(reward)),
         jax_ekaid.reward_loss(taken, seq, reward)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_remat_modes_give_equal_gradients(setup):
    """'none', 'full' and 'dots' with dropout on: the same masks (drawn
    outside the recomputed step) and the same gradients."""
    cfg, batch, tree, _ = setup
    grads = {}
    for remat in ("none", "full", "dots"):
        model = _port(cfg, tree, remat=remat)
        loss, _, _ = _port_loss(model, batch,
                                gen=generator(0, 0, 0, 0, "cpu"))
        loss.backward()
        grads[remat] = (float(loss.detach()), _grads(model))
    for remat in ("full", "dots"):
        assert grads[remat][0] == grads["none"][0]
        for n, g in grads["none"][1].items():
            torch.testing.assert_close(grads[remat][1][n], g, rtol=1e-6,
                                       atol=1e-9, msg=f"{remat} {n}")


def test_dropout_share_and_scale():
    x = torch.ones(200_000)
    for p in (0.2, 0.5):
        y = dropout(x, p, generator(1, 0, 0, 0, "cpu"))
        kept = y != 0
        n, share = x.numel(), kept.float().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        assert abs(share - (1 - p)) <= 3 * sigma
        torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                            1 / (1 - p)))
    assert dropout(x, 0.5, None) is x


def test_dropout_draws_follow_seed_step_and_microbatch():
    x = torch.ones(4096)

    def mask(*key):
        return dropout(x, 0.5, generator(*key, 0, "cpu")) != 0

    assert torch.equal(mask(7, 3, 0), mask(7, 3, 0))
    assert not torch.equal(mask(7, 3, 0), mask(7, 4, 0))
    assert not torch.equal(mask(7, 3, 0), mask(7, 3, 1))
    assert not torch.equal(mask(7, 3, 0), mask(8, 3, 0))


def test_train_mode_forward_draws_per_step_masks(setup):
    """With a generator the forward differs from eval, is repeatable for
    an equal draw key and differs for another step."""
    cfg, batch, tree, _ = setup
    model = _port(cfg, tree)
    with torch.no_grad():
        ev = model(batch)["logprobs"]
        a = model(batch, gen=generator(0, 5, 0, 0, "cpu"))["logprobs"]
        b = model(batch, gen=generator(0, 5, 0, 0, "cpu"))["logprobs"]
        c = model(batch, gen=generator(0, 6, 0, 0, "cpu"))["logprobs"]
    assert torch.equal(a, b)
    assert not torch.equal(a, ev) and not torch.equal(a, c)
    # one mask per step: the word-embedding masks of two steps differ
    masks = model.speaker._step_masks(4, 3, generator(0, 0, 0, 0, "cpu"),
                                      torch.device("cpu"))
    assert not torch.equal(masks[0][0], masks[0][1])


def test_scheduled_sampling_replaces_inputs(setup):
    """ss_prob 1: every input from step 1 on is a draw from the previous
    step's log-probs, so the outputs from step 1 on follow those draws
    and not the labels; step 0 reads <start> either way."""
    cfg, batch, tree, _ = setup
    model = _port(cfg, tree, drop_prob_lm=0.0)
    seen = []
    emb = model.speaker._embed_word

    def spy(it, mask=None):
        seen.append(it.clone())
        return emb(it, mask)

    model.speaker._embed_word = spy
    labels = torch.as_tensor(batch["labels"]).long()
    with torch.no_grad():
        gen, ss = generator(0, 0, 0, 0, "cpu"), generator(0, 0, 0, 1, "cpu")
        model(batch, ss_prob=1.0, gen=gen, ss_gen=ss)
    T = labels.shape[1] - 1
    assert len(seen) == T
    assert torch.equal(seen[0], labels[:, 0])
    replaced = torch.stack([(s != labels[:, i]) for i, s in
                            enumerate(seen)])[1:]
    assert replaced.float().mean() > 0.5
    seen.clear()
    with torch.no_grad():
        model(batch, ss_prob=0.0, gen=gen)
    assert all(torch.equal(s, labels[:, i]) for i, s in enumerate(seen))


def test_weight_norm_keeps_f32_accuracy_on_large_kernels():
    """The weight norm of a 4096 x 1024 kernel within 1e-6 of its f64
    value (torch.linalg.norm of an f32 tensor this size strays far past
    that on the CPU)."""
    v = torch.rand(4096, 1024, generator=torch.Generator().manual_seed(0))
    got = frobenius((v * 2 - 1) / 32).double()
    want = torch.linalg.norm(((v * 2 - 1) / 32).double())
    assert abs(float(got / want) - 1) <= 1e-6
