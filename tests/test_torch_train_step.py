"""ekaid_torch train step and optimizer against the JAX package and optax:
three steps of every optimizer kind, the learning-rate schedule, gradient
accumulation, an optax Adam state carried across, and the step's other
options."""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.models.ekaid import total_loss as jax_total_loss
from ekaid_tpu.train import step as jstep
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import flatten, load_flax_params, \
    load_optax_state
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train import step as pstep

#: each parameter tensor after three steps: ||port - optax|| / ||optax||
PARAM_RTOL = 1e-5
#: same gradients into both optimizers: elementwise, of the largest
#: magnitude of each tensor
UPDATE_RTOL = 1e-6
ATT_REG = 2.5e-3
#: parameters whose gradient is zero in exact arithmetic: a softmax is
#: invariant to them (the key biases shift every score of a query alike,
#: the score head's bias every token alike, the implicit relation's label
#: bias reads an all-ones adjacency). Both packages compute rounding
#: noise there, which adam, rmsprop and adagrad scale up to a full step
#: of either sign, so these are held to a noise-sized gradient instead.
SHIFT_INVARIANT = re.compile(r"key\.WNDense_0\.bias$|FCNet_1\.WNDense_0\."
                             r"bias$|imp_relation\.gat\.bias\.")
NOISE = 1e-6           # of the largest gradient
#: (kind, weight_decay): adam with weight decay is optax's adamw
KINDS = [("adam", 0.0), ("adam", 0.01), ("sgd", 0.0), ("sgdm", 0.0),
         ("sgdmom", 0.0), ("rmsprop", 0.0), ("adagrad", 0.0)]


def _cfg():
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))


def _optim(cfg, kind, wd, clip, **kw):
    # step_size 1 epoch of 1 step: the schedule moves at every update
    return cfg.train.optim.replace(type=kind, weight_decay=wd,
                                   grad_clip=clip, step_size=1, gamma=0.5,
                                   **kw)


@pytest.fixture(scope="module")
def ref():
    cfg = _cfg()
    batches = [synthetic_batch(cfg, 4, seed=s) for s in range(3)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jbs[0], train=True)

    def loss_fn(params, b):
        return jax_total_loss(flax.apply(params, b, train=False), b,
                              ATT_REG)[0]

    grad = jax.jit(jax.grad(loss_fn))
    return cfg, flax, batches, jbs, tree, grad


def _port(cfg, tree):
    return load_flax_params(
        EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None), tree)


def _optax_run(tx, params, grads_of, n):
    """n updates of optax's tx; grads_of(i, params) gives step i's."""
    state = tx.init(params)
    for i in range(n):
        updates, state = tx.update(grads_of(i, params), state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _assert_params(model, params, rtol=PARAM_RTOL):
    want = flatten(jax.tree.map(np.asarray, params)["params"])
    for n, p in model.named_parameters():
        if SHIFT_INVARIANT.search(n):
            continue
        w = want[n]
        err = np.linalg.norm(to_np(p) - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rtol, f"{n}: {err}"


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("kind,wd", KINDS)
def test_three_steps_match_optax(ref, kind, wd, clip):
    """Three train steps (dropout off) of each kind, with and without
    clipping, against the reference model's gradients through optax."""
    cfg, _, batches, jbs, tree, grad = ref
    oc = _optim(cfg, kind, wd, clip)
    tx = jstep.make_optimizer(oc, steps_per_epoch=1)
    params, _ = _optax_run(tx, jax.tree.map(jnp.asarray, tree),
                           lambda i, p: grad(p, jbs[i]), 3)
    model = _port(cfg, tree)
    state = pstep.init_state(model, port_cfg(cfg).train.optim.replace(
        **oc.__dict__), steps_per_epoch=1)
    noise = []
    step = state.opt.step

    def spy(grads, grad_norm=None):
        top = max(float(g.abs().max()) for g in grads)
        noise.append(max(float(g.abs().max()) for n, g in zip(
            state.opt.names, grads) if SHIFT_INVARIANT.search(n)) / top)
        step(grads, grad_norm)

    state.opt.step = spy
    for b in batches:
        pstep.train_step(state, b, 0, ATT_REG, train=False)
    assert state.step == 3 and state.opt.count == 3
    assert max(noise) <= NOISE
    _assert_params(model, params)
    # the frozen embedding copy moves only under adamw's decay
    fixed = model.change_detector.question.WordEmbedding_0.emb_fixed
    moved = not np.array_equal(
        to_np(fixed), tree["params"]["change_detector"]["question"][
            "WordEmbedding_0"]["emb_fixed"])
    assert moved == (kind == "adam" and wd > 0)


class _Params(torch.nn.Module):
    """A matrix, a vector, a scalar and a frozen table."""

    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(1)
        self.w = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal((6, 5)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.zeros(5))
        self.g = torch.nn.Parameter(torch.tensor(1.5))
        self.fixed = torch.nn.Parameter(torch.ones(3, 2),
                                        requires_grad=False)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("kind,wd", KINDS)
def test_update_rules_match_optax(kind, wd, clip):
    """The same gradients into optax and into the port's optimizer: four
    updates across two schedule transitions; clip 1.0 clips the larger
    gradients only."""
    cfg = port_cfg(_cfg())
    rng = np.random.default_rng(0)
    shapes = {n: tuple(p.shape) for n, p in _Params().named_parameters()}
    grads = [{n: np.asarray(rng.standard_normal(sh) * s, np.float32)
              for n, sh in shapes.items()} for s in (0.05, 3.0, 0.2, 2.0)]
    grads[1]["fixed"][:] = 0.0          # a parameter without a gradient
    params = {n: jnp.asarray(to_np(p))
              for n, p in _Params().named_parameters()}
    oc = _optim(cfg, kind, wd, clip, lr=1e-2)
    tx = jstep.make_optimizer(oc, steps_per_epoch=2)
    want, _ = _optax_run(tx, params,
                         lambda i, _: {n: jnp.asarray(g)
                                       for n, g in grads[i].items()}, 4)
    model = _Params()
    opt = pstep.make_optimizer(oc, model, steps_per_epoch=2)
    for g in grads:
        opt.step([torch.from_numpy(g[n]) for n in shapes])
    for n, p in model.named_parameters():
        w = np.asarray(want[n])
        np.testing.assert_allclose(
            to_np(p), w, rtol=0, atol=UPDATE_RTOL * np.abs(w).max(),
            err_msg=n)


def test_learning_rate_follows_exponential_decay():
    cfg = _cfg()
    oc = cfg.train.optim.replace(lr=3e-4, step_size=2, gamma=0.1)
    spe = 5
    sched = optax.exponential_decay(oc.lr, oc.step_size * spe, oc.gamma,
                                    staircase=True)
    model = EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=0)
    opt = pstep.make_optimizer(oc, model, steps_per_epoch=spe)
    for count in (0, 1, 9, 10, 11, 19, 20, 35):
        assert opt.lr(count) == pytest.approx(float(sched(count)),
                                              rel=1e-7, abs=0), count
    assert pstep.make_optimizer(oc, model).lr(1000) == pytest.approx(oc.lr)


def test_accumulation_equals_one_step(ref):
    """accum_steps 2 with dropout off: the loss and the parameters after
    one step equal the full batch's step, in the port and against the
    reference's accumulated step (SGD: the update is linear in the
    gradients, so they are compared directly)."""
    cfg, flax, _, _, tree, _ = ref
    batch = synthetic_batch(cfg, 8, seed=5)
    oc = cfg.train.optim.replace(type="sgd", lr=0.1)
    out = {}
    for accum in (1, 2):
        model = _port(cfg, tree)
        state = pstep.init_state(model, port_cfg(cfg).train.optim.replace(
            type="sgd", lr=0.1))
        m = pstep.train_step(state, batch, 0, ATT_REG, accum_steps=accum,
                             train=False)
        out[accum] = (float(m["total_loss"]), float(m["speaker_loss"]),
                      {n: to_np(p) for n, p in model.named_parameters()})
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[2][1] == pytest.approx(out[1][1], rel=1e-6)
    for n, p in out[1][2].items():
        np.testing.assert_allclose(out[2][2][n], p, rtol=0, atol=1e-6,
                                   err_msg=n)
    tx = jstep.make_optimizer(oc)
    params = jax.tree.map(jnp.asarray, tree)
    st = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params))
    st, jm = jax.jit(partial(jstep.train_step, flax, tx, ATT_REG,
                             accum_steps=2, train=False))(
        st, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    assert out[2][0] == pytest.approx(float(jm["total_loss"]), rel=1e-6)
    want = flatten(jax.tree.map(np.asarray, st.params)["params"])
    for n, p in out[2][2].items():
        np.testing.assert_allclose(p, want[n], rtol=0, atol=1e-6, err_msg=n)


def test_accumulation_refuses_an_indivisible_batch(ref):
    cfg, _, batches, _, tree, _ = ref
    state = pstep.init_state(_port(cfg, tree), port_cfg(cfg).train.optim)
    with pytest.raises(ValueError, match="accum_steps"):
        pstep.train_step(state, batches[0], 0, ATT_REG, accum_steps=3)


def test_adam_state_carried_from_jax_continues(ref):
    """Two optax Adam steps in the reference, its state exported as numpy
    and loaded with the params by `convert`, then one more step on each
    side: the same parameters."""
    cfg, _, batches, jbs, tree, grad = ref
    oc = _optim(cfg, "adam", 0.0, 0.0)
    tx = jstep.make_optimizer(oc, steps_per_epoch=1)
    params, st = _optax_run(tx, jax.tree.map(jnp.asarray, tree),
                            lambda i, p: grad(p, jbs[i]), 2)
    adam = st[0]
    model = _port(cfg, jax.tree.map(np.asarray, params))
    state = pstep.init_state(model, port_cfg(cfg).train.optim.replace(
        **oc.__dict__), steps_per_epoch=1)
    load_optax_state(state.opt, {"mu": jax.tree.map(np.asarray, adam.mu),
                                 "nu": jax.tree.map(np.asarray, adam.nu)},
                     int(adam.count))
    state.step = 2
    assert state.opt.lr() == pytest.approx(oc.lr * oc.gamma ** 2)
    pstep.train_step(state, batches[2], 0, ATT_REG, train=False)
    updates, _ = tx.update(grad(params, jbs[2]), st, params)
    _assert_params(model, optax.apply_updates(params, updates))


def test_train_step_reports_metrics_and_draws_by_step(ref):
    """Metrics as 0-d tensors; with dropout the step draws from (seed,
    step): two equal states take equal steps, another seed differs."""
    cfg, _, batches, _, tree, _ = ref
    c = port_cfg(cfg).replace(train=port_cfg(cfg).train.replace(
        entropy_weight=0.05))
    runs = []
    for seed in (0, 0, 1):
        model = _port(cfg, tree)
        state = pstep.init_state(model, c.train.optim)
        m = pstep.train_step(state, batches[0], seed, ATT_REG,
                             ss_prob=0.5, entropy_weight=0.05)
        runs.append((m, to_np(model.speaker.logit.kernel)))
    m = runs[0][0]
    assert set(m) == {"total_loss", "speaker_loss", "att_reg", "entropy",
                      "grad_norm"}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in m.values())
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert not np.array_equal(runs[0][1], runs[2][1])


def test_param_cast_step_runs_in_bf16(ref):
    """train_param_cast: the products read bf16 weights; the masters stay
    f32 and take finite gradients."""
    cfg, _, batches, _, tree, _ = ref
    c = port_cfg(cfg).replace(dtypes=port_cfg(cfg).dtypes.replace(
        compute_dtype="bfloat16"))
    from ekaid_torch.utils.dtypes import Policy
    model = load_flax_params(EkaidModel(c, NTOKEN, policy=Policy.from_config(
        c.dtypes), device="cpu", seed=None), tree)
    state = pstep.init_state(model, c.train.optim)
    m = pstep.train_step(state, batches[0], 0, ATT_REG, param_cast=True)
    assert torch.isfinite(m["total_loss"]) and torch.isfinite(m["grad_norm"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
