"""ekaid_torch.utils.orbax_import on VQA snapshots of sgdm, sgdmom,
rmsprop and adagrad, with and without clipping (adam, adamw and sgd are
in test_torch_orbax_import.py): read without JAX, every leaf bit-equal,
and 3 more steps of the port against 3 more of the reference."""

import pytest

import _torch_orbax as H

CASES = [(k, 0.0, clip) for k in ("sgdm", "sgdmom", "rmsprop", "adagrad")
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
