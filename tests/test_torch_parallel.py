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

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ddp import ATT_REG, launch, one_process_step
from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import ekaid as jax_ekaid
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.config import MeshConfig
from ekaid_torch.convert import as_torch, flatten
from ekaid_torch.parallel import mesh

WORLD = 2
B = 8
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
        r = one_process_step(pcfg, tree, NTOKEN, b)
        return r["metrics"]["total_loss"], r["grads"]

    one_loss, one = port_step(batch)
    halves = [port_step({k: v[r::WORLD] for k, v in batch.items()})[1]
              for r in range(WORLD)]
    ranks = [res["step"] for res in launch(
        tmp_path_factory.mktemp("ddp"), WORLD,
        {"cfg": pcfg.to_dict(), "tree": tree, "batch": batch,
         "ntoken": NTOKEN, "tasks": ["step"]})]
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
    ({"model": 2}, ValueError, "mesh.model=2: the port has no model axis"),
    ({"data": 2}, ValueError, "mesh.data=2 but the data axis has 1"),
    ({"data": 0}, ValueError, "mesh.data=0"),
])
def test_data_axis_refuses(axes, error, msg):
    with pytest.raises(error, match=msg):
        mesh.make_mesh(MeshConfig(**axes), "cpu")


@pytest.mark.parametrize("data", [-1, 1])
def test_data_axis_of_one_process(data):
    axis = mesh.make_mesh(MeshConfig(data=data), "cpu")
    assert (axis.rank, axis.data, axis.distributed) == (0, 1, False)


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
