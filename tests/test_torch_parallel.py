"""ekaid_torch's data parallelism (`parallel/mesh.py`) on the CPU: one
DDP `train_step` over two gloo ranks against the one-process step on the
same global batch and against the JAX package's single-device step;
`--dp` extraction over two CPU replicas; the mesh refusals.

The ranks are processes of their own (`tests/_torch_ddp.py`), joined
through a `file://` rendezvous in tmp_path (no TCP port, so parallel
test workers do not collide), each waited for with its own timeout.
Dropout is off (`train=False`): with dropout, each rank draws its own
masks, which cannot equal one process's draws over the whole batch.

The two halves of the batch have different answer lengths, so the
global loss (the answer NLL over the whole batch's tokens) differs from
the mean of the halves' own mean losses; the test shows that the
latter, what plain per-rank averaging gives, misses the bound."""

import dataclasses
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
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import MeshConfig
from ekaid_torch.convert import as_torch, flatten, load_flax_params
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.parallel import mesh
from ekaid_torch.train.step import init_state, train_step
from ekaid_torch.utils.dtypes import F32

HERE = Path(__file__).resolve().parent
WORLD = 2
B = 8
RANK_TIMEOUT_S = 120
ATT_REG = 2.5e-3
ONE_PROCESS_RTOL = 1e-6       # of the largest gradient magnitude
#: of the largest gradient magnitude. The port's one-process f32 step
#: itself stands 6.1e-5 of it from the reference's on this batch, in the
#: bias of the implicit relation's `pair_pos_fc1`, whose gradient passes
#: through log(max(relu(x), 1e-6)) and so magnifies the f32 rounding of
#: x near 1e-6 (tests/test_torch_train_model.py holds such tensors to
#: 1e-4 of the largest of all too)
JAX_RTOL = 1e-4


def _cfg():
    cfg = tiny_cfg()
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))


def _batch(cfg):
    """B pairs whose even rows (rank 0) answer in 5 tokens and odd rows
    (rank 1) in 1."""
    batch = synthetic_batch(cfg, B, seed=0)
    t = batch["labels"].shape[1]
    batch["labels"][:, 1:] = 0
    batch["masks"][:] = 0.0
    for i in range(B):
        n = 5 if i % 2 == 0 else 1
        batch["labels"][i, 1:1 + n] = 7 + i
        batch["masks"][i, :n + 2] = 1.0
    assert t >= 8
    return batch


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The flax params, the global batch, the one-process port step's
    gradients and loss, the two ranks' results, and the JAX step's
    gradients."""
    cfg = _cfg()
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flax = JaxModel(cfg, ntoken=NTOKEN, policy=JF32)
    tree = init_flax(flax, jb, train=False)

    def loss_fn(params):
        out = flax.apply(params, jb, train=False)
        return jax_ekaid.total_loss(out, jb, ATT_REG)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, tree))
    jgrads = {k: as_torch(v).numpy() for k, v in flatten(
        jax.tree.map(np.asarray, jgrads)["params"]).items()}

    pcfg = port_cfg(cfg)

    def port_step(b):
        model = load_flax_params(EkaidModel(pcfg, NTOKEN, policy=F32,
                                            device="cpu", seed=None), tree)
        m = train_step(init_state(model, pcfg.train.optim), b, 0, ATT_REG,
                       train=False)
        return float(m["total_loss"]), _grads(model)

    one_loss, one = port_step(batch)
    halves = [port_step({k: v[r::WORLD] for k, v in batch.items()})[1]
              for r in range(WORLD)]

    tmp = tmp_path_factory.mktemp("ddp")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"cfg": pcfg.to_dict(), "tree": tree, "batch": batch,
                     "ntoken": NTOKEN}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), str(HERE.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_ddp.py"), str(r), str(WORLD),
         str(tmp / "rendezvous"), str(inputs), str(tmp / f"rank{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
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
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return {"batch": batch, "one": one, "one_loss": one_loss,
            "halves": halves, "ranks": ranks, "jax": jgrads,
            "jax_loss": float(jloss)}


def _max_gap(got, want):
    return max((to_np(got[n]) - to_np(want[n])).__abs__().max()
               for n in want)


def _top(grads):
    return max(np.abs(to_np(g)).max() for g in grads.values())


def test_the_halves_differ_in_answer_length(setup):
    masks = setup["batch"]["masks"][:, 1:]
    assert masks[0::2].sum() != masks[1::2].sum()


def test_ddp_step_equals_the_one_process_step(setup):
    """Both ranks hold the global batch's loss and gradient, within
    1e-6 of the largest gradient magnitude of the one-process step."""
    one, top = setup["one"], _top(setup["one"])
    for r, res in enumerate(setup["ranks"]):
        assert abs(res["metrics"]["total_loss"] - setup["one_loss"]) <= \
            1e-6 * abs(setup["one_loss"]), r
        assert _max_gap(res["grads"], one) <= ONE_PROCESS_RTOL * top, r
    assert _max_gap(setup["ranks"][0]["grads"],
                    setup["ranks"][1]["grads"]) == 0.0


def test_ddp_step_equals_the_jax_step(setup):
    """Within JAX_RTOL of the largest gradient magnitude of the
    reference's single-device step, and no further from it than the
    one-process step plus the all-reduce's rounding."""
    want = setup["jax"]
    got = setup["ranks"][0]["grads"]
    assert set(got) == set(want)
    top = _top(want)
    assert _max_gap(got, want) <= JAX_RTOL * top
    assert _max_gap(got, want) <= _max_gap(setup["one"], want) + \
        ONE_PROCESS_RTOL * top
    assert abs(setup["ranks"][0]["metrics"]["total_loss"]
               - setup["jax_loss"]) <= 1e-5 * abs(setup["jax_loss"])


def test_per_rank_mean_averaging_misses_the_bound(setup):
    """What DDP over per-rank mean losses would give: the mean of the
    halves' own gradients. It is far from the global batch's."""
    naive = {n: sum(h[n] for h in setup["halves"]) / WORLD
             for n in setup["one"]}
    assert _max_gap(naive, setup["one"]) > \
        100 * ONE_PROCESS_RTOL * _top(setup["one"])


@pytest.mark.parametrize("axes,error,msg", [
    ({"model": 2}, ValueError, "mesh.model=2 does not divide the 1 process"),
    ({"data": 2}, ValueError, "mesh.data=2 but the data axis has 1"),
    ({"data": 0}, ValueError, "mesh.data=0"),
])
def test_data_axis_refuses(axes, error, msg):
    with pytest.raises(error, match=msg):
        mesh.make_mesh(MeshConfig(**axes), "cpu")


@pytest.mark.parametrize("data", [-1, 1])
def test_data_axis_of_one_process(data):
    axis = mesh.make_mesh(MeshConfig(data=data), "cpu")
    assert (axis.rank, axis.world, axis.distributed) == (0, 1, False)
    assert (axis.data, axis.model, axis.d, axis.m) == (1, 1, 0, 0)


def test_dp_extraction_over_two_cpu_replicas():
    """`build_detector_fns(devices=[cpu, cpu])`: each replica takes a
    contiguous half of the batch; the records equal one device's."""
    from ekaid_torch.config import load_config
    from ekaid_torch.extract import pipeline as tpipe
    from ekaid_torch.extract import runner as trunner
    det = load_config().detector.replace(
        image_size=64, pre_nms_topk=50, post_nms_topk=30, roi_feat_dim=32,
        fpn_channels=16, extract_batch_size=4)
    cfg = load_config(overrides={"detector": dataclasses.asdict(det),
                                 "dtypes": {"compute_dtype": "float32"}})
    images = next(trunner.synthetic_batches(4, 64, 4))

    def records(devices):
        fns = trunner.build_detector_fns(cfg, device="cpu", devices=devices)
        return tpipe.Extractor(*fns, det.num_disease_classes).process_batch(
            images)

    want, got = records(None), records(["cpu", "cpu"])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    fns = trunner.build_detector_fns(cfg, device="cpu",
                                     devices=["cpu", "cpu", "cpu"])
    with pytest.raises(ValueError, match="must divide over 3 replicas"):
        fns[0](images)
