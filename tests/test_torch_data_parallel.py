"""ekaid_torch's data axis (`parallel/mesh.py`) over several processes
on the CPU: a DDP step with gradient accumulation and clipping, a
snapshot written on two ranks and restored in one process, the axis
and the decode under a group of two, and the data-sharded greedy eval
on two and four ranks.

The ranks are processes of their own (`tests/_torch_ddp.py`), joined in
a gloo group through a `file://` rendezvous in tmp_path, each waited
for with its own timeout. Every step runs with dropout off, f32, at the
tiny dims of `_torch_port.tiny_cfg`, from one flax param tree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ddp import launch, one_process_step
from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train.step import init_state
from ekaid_torch.train.train import build_synthetic_trainer
from ekaid_torch.utils.checkpoint import CheckpointManager
from ekaid_torch.utils.dtypes import F32

B = 8
LOSS_RTOL = 2e-5
ONE_PROCESS_RTOL = 1e-5       # of the largest gradient magnitude
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6
GRAD_CLIP = 0.05
EVAL_PAIRS, EVAL_BATCHES = 160, 2
#: the data-sharded evals: grid name -> ranks
EVAL_GRIDS = {"2x1": 2, "4x1": 4}


def _cfg(**train):
    cfg = tiny_cfg()
    cfg = cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype="float32"))
    if train:
        cfg = cfg.replace(train=cfg.train.replace(**train))
    return cfg


def _eval_cfg():
    cfg = _cfg()
    return port_cfg(cfg.replace(data=cfg.data.replace(
        test=cfg.data.test.replace(batch_size=B))))


def _clip_cfg():
    """accum_steps 2 and grad_clip on, with the teacher-forcing hoist
    (each LSTM's `pre_product`) and remat 'dots'."""
    cfg = _cfg(accum_steps=2)
    return cfg.replace(
        train=cfg.train.replace(optim=cfg.train.optim.replace(
            grad_clip=GRAD_CLIP)),
        speaker=cfg.speaker.replace(train_hoist=True, remat="dots"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The flax params and global batch, the one-process clipped step,
    the two ranks' clipped step, snapshot and axis, and each eval grid's
    results."""
    cfg = _cfg()
    batch = synthetic_batch(cfg, B, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = init_flax(JaxModel(cfg, ntoken=NTOKEN, policy=JF32), jb,
                     train=False)
    snaps = tmp_path_factory.mktemp("snapshots")
    out = {"batch": batch, "snapshots": snaps,
           "one_clip": one_process_step(port_cfg(_clip_cfg()), tree,
                                        NTOKEN, batch)}
    common = {"tree": tree, "batch": batch, "ntoken": NTOKEN,
              "eval_pairs": EVAL_PAIRS, "eval_batches": EVAL_BATCHES}
    tmp = tmp_path_factory.mktemp("step")
    out["step"] = launch(tmp, 2, dict(
        common, cfg=port_cfg(_clip_cfg()).to_dict(),
        tasks=["step", "snapshot", "axis"], snapshot_dir=str(snaps),
        snapshot_out="two"))
    for grid, world in EVAL_GRIDS.items():
        tmp = tmp_path_factory.mktemp(f"eval{grid}")
        out[grid] = launch(tmp, world, dict(
            common, cfg=_eval_cfg().to_dict(), tasks=["eval"],
            workdir=str(tmp)))
    return out


def _max_gap(got, want):
    return max(np.abs(to_np(got[n]) - to_np(want[n])).max() for n in want)


def _top(grads):
    return max(np.abs(to_np(g)).max() for g in grads.values())


def _assert_decodes_equal(got, want):
    """Tokens equal; logprobs, module weights and the encoder's
    feat_diff within 1e-5."""
    assert torch.equal(got["seq"], want["seq"])
    for k in ("logprobs", "module_weights", "feat_diff"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5,
                                   msg=k)


def test_accumulated_clipped_step_equals_one_process(setup):
    """accum_steps 2 and grad_clip on (the norm above the limit, so the
    update is clipped), the hoist and remat 'dots' (`_clip_cfg`), over
    two data ranks: the global norm is the whole batch's, and the step
    equals the one-process step on every rank."""
    one = setup["one_clip"]
    assert one["metrics"]["grad_norm"] > GRAD_CLIP
    top = _top(one["grads"])
    for r, res in enumerate(setup["step"]):
        assert res["grid"] == (r, 2)
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


def test_snapshot_of_two_ranks_restores_in_one_process(setup):
    """The snapshot rank 0 wrote after the two ranks' step, restored in
    one process into a model drawn from another seed: the parameters
    and Adam slots are the ranks' bit for bit, and its greedy decode of
    the batch gives the ranks' data-sharded predictions."""
    ranks = setup["step"]
    pcfg = port_cfg(_clip_cfg())
    state = init_state(EkaidModel(pcfg, NTOKEN, policy=F32, device="cpu",
                                  seed=2), pcfg.train.optim)
    CheckpointManager(str(setup["snapshots"])).restore(state, name="two")
    assert (state.step, state.opt.count) == (1, 1)
    sd = state.state_dict()
    for res in ranks:
        s = res["step"]
        assert all(torch.equal(sd["params"][n], p)
                   for n, p in s["params"].items())
        assert all(torch.equal(sd["opt"]["slots"][k][n], t)
                   for k, slot in s["slots"].items()
                   for n, t in slot.items())
    got = state.model.decode(setup["batch"])
    for res in ranks:
        _assert_decodes_equal(got, res["snapshot"]["decode"])


def test_data_axis_of_two_ranks_takes_minus_one(setup):
    """Under a group of two, mesh.data -1 places each rank at its index
    on an axis of two."""
    assert [res["axis"]["auto"] for res in setup["step"]] == [(0, 2), (1, 2)]


def test_data_axis_of_two_ranks_refuses_another_size(setup):
    for res in setup["step"]:
        assert res["axis"]["other_size"].startswith(
            "mesh.data=4 but the data axis has 2 process(es)")


def test_decode_refuses_a_batch_the_ranks_do_not_divide(setup):
    """A greedy decode of 3 rows over two ranks raises on both, before
    any collective, so neither waits on the other."""
    for res in setup["step"]:
        assert res["axis"]["undivided"] == (
            "decode batch 3 does not split over the 2 ranks of the data "
            "axis")


@pytest.mark.parametrize("grid", EVAL_GRIDS)
def test_data_sharded_eval_gives_the_one_process_predictions(setup, grid):
    """`Trainer.evaluate` over the grid's data ranks: each rank runs the
    greedy decode's plain version (K1's twin on the CPU) on its block of
    each batch's 8 rows, and rank 0's predictions equal one process's.
    The untrained model answers alike for most rows, so the decode of
    the step's batch is held row by row too: tokens equal, logprobs and
    the encoder's feat_diff within 1e-5."""
    tr = build_synthetic_trainer(_eval_cfg(), str(setup["snapshots"]
                                                  / f"one_{grid}"),
                                 n_pairs=EVAL_PAIRS, device="cpu")
    _, want = tr.evaluate(max_batches=EVAL_BATCHES)
    assert len(want) == EVAL_BATCHES * B
    one = tr.model.decode(setup["batch"])
    ranks = setup[grid]
    world = EVAL_GRIDS[grid]
    assert ranks[0]["eval"]["predictions"] == want
    for r, res in enumerate(ranks):
        assert res["grid"] == (r, world)
        assert res["eval"]["rows"] == [B // world] * (EVAL_BATCHES + 1)
        _assert_decodes_equal(res["eval"]["decode"], one)
    assert len(set(one["logprobs"][:, 0].tolist())) == B
    assert all(res["eval"]["predictions"] == {} for res in ranks[1:])
