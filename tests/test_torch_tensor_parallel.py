"""ekaid_torch's data x model mesh (`parallel/mesh.py`,
`parallel/tensor.py`) on the CPU.

The ranks are processes of their own (`tests/_torch_tp.py`), joined in
a gloo group through a `file://` rendezvous in tmp_path, each waited
for with its own timeout. Three groups run: 2 x 2 (the conjugate ops,
one train step, the data-sharded eval), 1 x 2 (a step with gradient
accumulation and clipping, a snapshot restored and written again) and
2 x 1 (the data-sharded eval). Every step runs with dropout off, f32,
at the tiny dims of `_torch_port.tiny_cfg`.

The rule table is held against the reference's `param_shardings` on
the 8 virtual CPU devices, and the 2 x 2 step's gradients against the
reference's gradient on a `make_mesh(data=2, model=2)` mesh, with the
params placed by its rules and the batch over 'data'. (The reference's
`make_jitted_steps` draws dropout; its sharded gradient is taken here
with the same placements and dropout off.)
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import ekaid as jax_ekaid
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.parallel import mesh as jmesh
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import load_config
from ekaid_torch.convert import as_torch, flatten, load_flax_params
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.parallel import mesh
from ekaid_torch.train.step import init_state, train_step
from ekaid_torch.train.train import build_synthetic_trainer
from ekaid_torch.utils.checkpoint import CheckpointManager
from ekaid_torch.utils.dtypes import F32

HERE = Path(__file__).resolve().parent
B = 8
ATT_REG = 2.5e-3
RANK_TIMEOUT_S = 120
LOSS_RTOL = 2e-5
ONE_PROCESS_RTOL = 1e-5       # of the largest gradient magnitude
#: of the largest gradient magnitude: the port's one-process f32 step
#: stands up to 6.1e-5 of it from the reference's (test_torch_parallel.py)
JAX_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6
GRAD_CLIP = 0.05
EVAL_PAIRS, EVAL_BATCHES = 160, 2


def _cfg(model=1, **train):
    cfg = tiny_cfg()
    cfg = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"),
                      mesh=cfg.mesh.replace(model=model))
    if train:
        cfg = cfg.replace(train=cfg.train.replace(**train))
    return cfg


def _eval_cfg(model):
    cfg = _cfg(model)
    return port_cfg(cfg.replace(data=cfg.data.replace(
        test=cfg.data.test.replace(batch_size=B))))


def _clip_cfg(model):
    """accum_steps 2 and grad_clip on, with the teacher-forcing hoist
    (each LSTM's `pre_product`: the module LSTM's 96 rows split at 48,
    inside its 64 hoisted rows; the language LSTM's hoisted 24 rows all
    on rank 0) and remat 'dots' (the collectives run again in the
    recomputation)."""
    cfg = _cfg(model, accum_steps=2)
    return cfg.replace(
        train=cfg.train.replace(optim=cfg.train.optim.replace(
            grad_clip=GRAD_CLIP)),
        speaker=cfg.speaker.replace(train_hoist=True, remat="dots"))


def _launch(tmp: Path, world: int, inputs: dict) -> list:
    """Run `world` ranks of _torch_tp.py on `inputs`; their results."""
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), str(HERE.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_tp.py"), str(r), str(world),
         str(tmp / "rendezvous"), str(tmp / "inputs.pkl"),
         str(tmp / f"rank{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _one_process_step(cfg, tree, batch):
    """The port's step in one process: metrics, gradients, parameters
    and Adam slots after it."""
    pcfg = port_cfg(cfg)
    model = load_flax_params(EkaidModel(pcfg, NTOKEN, policy=F32,
                                        device="cpu", seed=None), tree)
    state = init_state(model, pcfg.train.optim)
    m = train_step(state, batch, 0, ATT_REG, train=False,
                   accum_steps=pcfg.train.accum_steps)
    sd = state.state_dict()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.detach().clone() if p.grad is not None
                      else torch.zeros_like(p)
                      for n, p in model.named_parameters()},
            "params": sd["params"], "slots": sd["opt"]["slots"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The flax params and global batch, the one-process port steps, the
    reference's sharded gradient, and the three groups' results."""
    cfg = _cfg()
    batch = synthetic_batch(cfg, B, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)

    # the reference's gradient on a data 2 x model 2 mesh
    m22 = jmesh.make_mesh(data=2, model=2)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            jmesh.param_shardings(m22, tree))
    placed = jmesh.shard_batch(m22, jb)

    def loss_fn(p, b):
        return jax_ekaid.total_loss(flax.apply(p, b, train=False), b,
                                    ATT_REG)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, placed)
    logit = jgrads["params"]["speaker"]["logit"]["kernel"]
    assert logit.sharding.spec == jax.sharding.PartitionSpec(None, "model")
    jgrads = {k: as_torch(v).numpy() for k, v in flatten(
        jax.tree.map(np.asarray, jgrads)["params"]).items()}

    out = {"batch": batch, "tree": tree, "jax": jgrads,
           "jax_loss": float(jloss),
           "one": _one_process_step(cfg, tree, batch),
           "one_clip": _one_process_step(_clip_cfg(1), tree, batch)}

    # a 1 x 1 snapshot after one step (Adam's slots set)
    snaps = tmp_path_factory.mktemp("snapshots")
    pcfg = port_cfg(cfg)
    model = load_flax_params(EkaidModel(pcfg, NTOKEN, policy=F32,
                                        device="cpu", seed=None), tree)
    state = init_state(model, pcfg.train.optim)
    train_step(state, batch, 0, ATT_REG, train=False)
    CheckpointManager(str(snaps)).save(state, name="one")
    out["snapshots"] = snaps

    common = {"tree": tree, "batch": batch, "ntoken": NTOKEN,
              "eval_pairs": EVAL_PAIRS, "eval_batches": EVAL_BATCHES}
    tmp = tmp_path_factory.mktemp("mesh22")
    out["2x2"] = _launch(tmp, 4, dict(
        common, cfg=_eval_cfg(2).to_dict(), tasks=["ops", "step", "eval"],
        workdir=str(tmp)))
    tmp = tmp_path_factory.mktemp("mesh12")
    out["1x2"] = _launch(tmp, 2, dict(
        common, cfg=port_cfg(_clip_cfg(2)).to_dict(),
        tasks=["step", "snapshot"], snapshot_dir=str(snaps),
        snapshot_in="one", snapshot_out="two"))
    tmp = tmp_path_factory.mktemp("mesh21")
    out["2x1"] = _launch(tmp, 2, dict(
        common, cfg=_eval_cfg(1).to_dict(), tasks=["eval"],
        workdir=str(tmp)))
    return out


def _max_gap(got, want):
    return max(np.abs(to_np(got[n]) - to_np(want[n])).max() for n in want)


def _top(grads):
    return max(np.abs(to_np(g)).max() for g in grads.values())


def _spec_dims(tree, prefix=""):
    """{'a.b.c': dim} of a nested dict of PartitionSpecs: 1 for
    P(None, 'model'), 0 for P('model', None), None for P()."""
    dims = {jax.sharding.PartitionSpec(None, "model"): 1,
            jax.sharding.PartitionSpec("model", None): 0}
    out = {}
    for k, v in tree.items():
        if isinstance(v, jax.sharding.PartitionSpec):
            out[prefix + k] = dims.get(v)
        else:
            out.update(_spec_dims(v, f"{prefix}{k}."))
    return out


# ---- (a) the rule table ----------------------------------------------------

@pytest.mark.parametrize("word_embed", [24, 26])
@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_rule_table_equals_the_reference(data, model, word_embed):
    """The port's `param_shardings` over its own parameter names gives
    the dim of every spec of the reference's `param_shardings` on the
    same tree. word_embed 26 makes the language LSTM's w_ih 90 rows,
    which 4 does not divide: both fall back to replication there."""
    cfg = tiny_cfg()
    cfg = cfg.replace(speaker=cfg.speaker.replace(
        word_embed_size=word_embed))
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 2).items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    shapes = jax.eval_shape(
        lambda: flax.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, batch,
                          train=False))
    specs = jax.tree.map(lambda s: s.spec, jmesh.param_shardings(
        jmesh.make_mesh(data=data, model=model), shapes))
    want = _spec_dims(specs["params"])
    port = EkaidModel(port_cfg(cfg), NTOKEN, policy=F32, device="cpu",
                      seed=None)
    got = mesh.param_shardings(((n, tuple(p.shape))
                                for n, p in port.named_parameters()), model)
    assert got == want
    fallback = (word_embed, model) == (26, 4)
    assert sum(d is not None for d in got.values()) == 11 - fallback
    assert (got["speaker.core.lang_lstm.w_ih"] is None) == fallback


def test_flagship_rule_table():
    """At the flagship config the rules shard 11 tensors, 29.8 M of the
    54.8 M parameters, over a model axis of 2 or 4; at 8 the vocabulary
    logits (148 columns) and the language LSTM's w_ih (1,324 rows) fall
    back to replication."""
    model = EkaidModel(load_config(), 147, policy=F32, device="cpu",
                       seed=None)
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    for m in (2, 4, 8):
        dims = mesh.param_shardings(((n, tuple(p.shape)) for n, p in
                                     model.named_parameters()), m)
        sharded = [n for n, d in dims.items() if d is not None]
        if m == 8:
            assert set(dims) - set(sharded) >= {
                "speaker.logit.kernel", "speaker.core.lang_lstm.w_ih"}
            assert len(sharded) == 9
            continue
        assert len(sharded) == 11, m
        assert round(sum(sizes[n] for n in sharded) / 1e6, 1) == 29.8
    assert round(sum(sizes.values()) / 1e6, 1) == 54.8


# ---- (b) the conjugate ops -------------------------------------------------

def test_conjugate_ops_against_the_unsharded_math(setup):
    """Over each model group of 2: copy_in's backward sums the ranks'
    gradients, reduce_out sums the blocks (backward: the identity),
    gather_last joins them (backward: this rank's block), and
    take_slice's backward gathers uneven blocks."""
    for r, res in enumerate(setup["2x2"]):
        o, m = res["ops"], res["grid"][3]
        x, parts, u, spans = o["x"], o["parts"], o["u"], o["spans"]
        exact = dict(rtol=0, atol=1e-12)
        y, g = o["copy_in"]
        torch.testing.assert_close(y, x, **exact)
        torch.testing.assert_close(g, u[:, :, :8].sum(0), **exact)
        y, g = o["reduce_out"]
        torch.testing.assert_close(y, parts.sum(0), **exact)
        torch.testing.assert_close(g, u[0, :, :8], **exact)
        y, g = o["gather_last"]
        torch.testing.assert_close(y, torch.cat(list(parts), -1), **exact)
        torch.testing.assert_close(g, u[0, :, 8 * m:8 * m + 8], **exact)
        y, g = o["take_slice"]
        a, b = spans[m]
        want = torch.zeros_like(x)
        for i, (a_i, b_i) in enumerate(spans):
            want[:, a_i:b_i] = u[i, :, a_i:b_i]
        torch.testing.assert_close(y, x[:, a:b], **exact)
        torch.testing.assert_close(g, want, **exact)


# ---- (c), (d) the 2 x 2 step -----------------------------------------------

def test_shard_shapes_follow_the_rule_table(setup):
    """Each rank holds its half of each rule-matched tensor (and so of
    its gradient and Adam slots), and the rest whole."""
    one = setup["one"]["params"]
    dims = mesh.param_shardings(((n, tuple(t.shape)) for n, t in one.items()),
                                2)
    assert sum(d is not None for d in dims.values()) == 11
    for res in setup["2x2"]:
        for n, shape in res["step"]["shapes"].items():
            want = list(one[n].shape)
            if dims[n] is not None:
                want[dims[n]] //= 2
            assert shape == tuple(want), n


def test_tp_step_equals_the_one_process_step(setup):
    """Loss within 2e-5 relative, every gathered gradient within 1e-5 of
    the largest magnitude, and the Adam-updated parameters within
    2e-4 / 2e-6, on every rank; the ranks hold the same state."""
    one = setup["one"]
    top = _top(one["grads"])
    for r, res in enumerate(setup["2x2"]):
        s = res["step"]
        assert abs(s["metrics"]["total_loss"] - one["metrics"]["total_loss"]
                   ) <= LOSS_RTOL * abs(one["metrics"]["total_loss"]), r
        assert set(s["grads"]) == set(one["grads"])
        assert _max_gap(s["grads"], one["grads"]) <= ONE_PROCESS_RTOL * top
        for n, p in one["params"].items():
            np.testing.assert_allclose(to_np(s["params"][n]), to_np(p),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=n)
    first = setup["2x2"][0]["step"]["params"]
    for res in setup["2x2"][1:]:
        for n, p in res["step"]["params"].items():
            assert torch.equal(p, first[n]), n


def test_tp_step_equals_the_reference_sharded_step(setup):
    """The 2 x 2 step's gradients within JAX_RTOL of the largest
    magnitude of the reference's gradient on its own 2 x 2 mesh, and
    the loss within 2e-5."""
    want = setup["jax"]
    got = setup["2x2"][0]["step"]
    assert set(got["grads"]) == set(want)
    assert _max_gap(got["grads"], want) <= JAX_RTOL * _top(want)
    assert abs(got["metrics"]["total_loss"] - setup["jax_loss"]) <= \
        LOSS_RTOL * abs(setup["jax_loss"])


# ---- (e) accumulation and clipping at 1 x 2 --------------------------------

def test_accumulated_clipped_step_equals_one_process(setup):
    """accum_steps 2 and grad_clip on (the norm above the limit, so the
    update is clipped), the hoist and remat 'dots' (`_clip_cfg`): the
    global norm adds the blocks' squares once, and the step equals the
    one-process step."""
    one = setup["one_clip"]
    assert one["metrics"]["grad_norm"] > GRAD_CLIP
    top = _top(one["grads"])
    for r, res in enumerate(setup["1x2"]):
        s = res["step"]
        for k in ("total_loss", "grad_norm"):
            assert abs(s["metrics"][k] - one["metrics"][k]) <= \
                LOSS_RTOL * abs(one["metrics"][k]), (r, k)
        assert _max_gap(s["grads"], one["grads"]) <= ONE_PROCESS_RTOL * top
        for n, p in one["params"].items():
            np.testing.assert_allclose(to_np(s["params"][n]), to_np(p),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=n)
        for k, slot in one["slots"].items():
            for n, t in slot.items():
                np.testing.assert_allclose(
                    to_np(s["slots"][k][n]), to_np(t), rtol=PARAM_RTOL,
                    atol=PARAM_ATOL, err_msg=f"{k}.{n}")


# ---- (f) a snapshot across meshes ------------------------------------------

def test_snapshot_restores_across_meshes(setup):
    """A 1 x 1 snapshot restored at 1 x 2 gives each rank its blocks of
    the parameters and Adam slots, bit for bit; written again from
    there, it equals the first file, and restored at 1 x 1 it gives the
    state that wrote the first."""
    for res in setup["1x2"]:
        s = res["snapshot"]
        assert s["blocks_equal"] and s["slots_equal"]
        assert len(s["sharded"]) == 11 and (s["count"], s["step"]) == (1, 1)
    ckpt = CheckpointManager(str(setup["snapshots"]))
    one = torch.load(ckpt._path("one"), weights_only=True)
    two = torch.load(ckpt._path("two"), weights_only=True)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    assert same(one, two)
    pcfg = port_cfg(_cfg())
    state = init_state(EkaidModel(pcfg, NTOKEN, policy=F32, device="cpu",
                                  seed=2), pcfg.train.optim)
    ckpt.restore(state, name="two")
    assert same(state.state_dict(), one)


# ---- (g) the data-sharded eval ---------------------------------------------

@pytest.mark.parametrize("grid", ["2x1", "2x2"])
def test_data_sharded_eval_gives_the_one_process_predictions(setup, grid):
    """`Trainer.evaluate` with two data ranks: each rank runs the greedy
    decode's plain version (K1's twin on the CPU) on its 4 of each
    batch's 8 rows, and rank 0's predictions equal one process's. The
    untrained model answers alike for most rows, so the decode of the
    step's batch is held row by row too: tokens equal, logprobs and the
    encoder's feat_diff within 1e-5."""
    tr = build_synthetic_trainer(_eval_cfg(1), str(setup["snapshots"]
                                                    / f"one_{grid}"),
                                 n_pairs=EVAL_PAIRS, device="cpu")
    _, want = tr.evaluate(max_batches=EVAL_BATCHES)
    assert len(want) == EVAL_BATCHES * B
    one = tr.model.decode(setup["batch"])
    ranks = setup[grid]
    assert ranks[0]["eval"]["predictions"] == want
    for res in ranks:
        e = res["eval"]
        assert e["rows"] == [B // 2] * (EVAL_BATCHES + 1)
        assert len(e["sharded"]) == (11 if grid == "2x2" else 0)
        assert torch.equal(e["decode"]["seq"], one["seq"])
        for k in ("logprobs", "module_weights", "feat_diff"):
            torch.testing.assert_close(e["decode"][k], one[k], rtol=0,
                                       atol=1e-5, msg=k)
    assert len(set(one["logprobs"][:, 0].tolist())) == B
    assert all(res["eval"]["predictions"] == {} for res in ranks[1:])
