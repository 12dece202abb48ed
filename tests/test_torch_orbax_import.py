"""ekaid_torch.utils.orbax_import: the reference's orbax checkpoints read
without JAX. VQA snapshots of adam, adamw and sgd (with and without
clipping; sgdm, sgdmom, rmsprop and adagrad are in
test_torch_orbax_import_kinds.py), a bf16 leaf, the checkpoint manager's
view of the reference's step directories, the missing-tensorstore error
and the CLI (a detector checkpoint: test_torch_orbax_detector.py)."""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import _torch_orbax as H
from ekaid_tpu.utils.checkpoint import CheckpointManager as JaxManager
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.train import step as pstep
from ekaid_torch.utils import orbax_import as oi
from ekaid_torch.utils.checkpoint import CheckpointManager

CASES = [(k, wd, clip) for k, wd in (("adam", 0.0), ("adam", 0.01),
                                     ("sgd", 0.0))
         for clip in (0.0, 0.05)]
IDS = [f"{'adamw' if wd else k}-clip{clip}" for k, wd, clip in CASES]


@pytest.fixture(scope="module")
def ref():
    return H.reference()


@pytest.fixture(scope="module")
def converted(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    cases, pairs = {}, []
    for case, name in zip(CASES, IDS):
        saved, after = H.snapshot(ref, tmp / name, *case)
        cases[name] = (saved, after, tmp / f"{name}.pt")
        pairs.append(("vqa", tmp / name / str(H.SAVED), tmp / f"{name}.pt"))
    loaded = H.read_without_jax(pairs)
    return tmp, cases, loaded


def test_reader_loads_no_jax(converted):
    assert converted[2] == []


@pytest.mark.parametrize("name", IDS)
def test_snapshot_leaves_bit_equal(converted, name):
    saved, _, pt = converted[1][name]
    H.assert_bit_equal(H.load(pt), saved)


@pytest.mark.parametrize("name", IDS)
def test_continued_steps_match_jax(ref, converted, name):
    case = CASES[IDS.index(name)]
    saved, after, pt = converted[1][name]
    H.assert_params_close(H.port_steps(ref, H.load(pt), *case), after)


def test_bf16_leaf_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"w": jnp.asarray(rng.standard_normal((5, 3)),
                                   jnp.bfloat16),
                  "b": jnp.asarray(rng.standard_normal(3), jnp.float32)},
            "n": jnp.int32(7)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "c"), tree)
    ckptr.wait_until_finished()
    got = oi.read_tree(str(tmp_path / "c"))
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].view(torch.int16).numpy(),
                                  np.asarray(tree["a"]["w"]).view(np.int16))
    np.testing.assert_array_equal(got["a"]["b"].numpy(), tree["a"]["b"])
    assert int(got["n"]) == 7


def _port_state(ref, kind="adam", wd=0.0, clip=0.0):
    from _torch_port import NTOKEN, port_cfg
    c = ref[0]
    model = EkaidModel(port_cfg(c), NTOKEN, device="cpu", seed=0)
    return pstep.init_state(model, port_cfg(c).train.optim.replace(
        **H.optim(c, kind, wd, clip).__dict__), steps_per_epoch=1)


def test_manager_sees_reference_step_dirs_and_best(ref, converted,
                                                   tmp_path):
    src = converted[0] / "adam-clip0.0"
    saved = converted[1]["adam-clip0.0"][0]
    snaps = tmp_path / "snaps"
    shutil.copytree(src, snaps)
    jm = JaxManager(str(snaps))
    state = jax.tree.map(jnp.asarray, saved)
    jm.save(state.replace(step=jnp.int32(1)))
    jm.save_best(state, 0.5)
    mgr = CheckpointManager(str(snaps))
    assert mgr.orbax_steps() == [1, 2] and mgr.steps() == []
    assert mgr.latest_step() == 2
    for name, step in ((None, 2), (1, 1), ("best", 2)):
        st = mgr.restore(_port_state(ref), name=name)
        assert st.step == step and st.opt.count == 2
        H.assert_params_close(st.model, saved.params)
    # the port's own file comes first
    st = _port_state(ref)
    st.step = 2
    mgr.save(st)
    assert mgr.restore(_port_state(ref), name=2).opt.count == 0
    with pytest.raises(ValueError, match="keeps slots"):
        mgr.restore(_port_state(ref, "sgd"), name=1)


def test_missing_tensorstore_names_the_converter(converted, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="orbax_import"):
        oi.read_tree(str(converted[0] / "sgd-clip0.0" / str(H.SAVED)))


def test_unknown_layouts_raise(converted, tmp_path):
    with pytest.raises(oi.UnsupportedCheckpoint, match="none of"):
        oi.optax_state([{"mu": 1}, {"count": 2}])
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "c"), {"w": jnp.ones(2)})
    ckptr.wait_until_finished()
    with pytest.raises(oi.UnsupportedCheckpoint, match="not a VQA"):
        oi.vqa_state_dict(str(tmp_path / "c"))


def test_cli_writes_what_the_loaders_read(ref, converted, tmp_path,
                                          capsys):
    src = converted[0] / "adam-clip0.05" / str(H.SAVED)
    oi.main(["vqa", str(src), str(tmp_path / "2.pt")])
    assert "step 2" in capsys.readouterr().out
    st = CheckpointManager(str(tmp_path)).restore(
        _port_state(ref, clip=0.05))
    H.assert_params_close(st.model, converted[1]["adam-clip0.05"][0].params)
