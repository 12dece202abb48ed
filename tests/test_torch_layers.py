"""ekaid_torch atoms, graph ops, synthetic data and weight bridge against
the JAX package (f32, same weights, same numpy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import init_flax, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch as jax_batch
from ekaid_tpu.models import layers as jl
from ekaid_tpu.ops import graph as jg
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import load_flax_params
from ekaid_torch.data.synthetic import synthetic_batch as port_batch
from ekaid_torch.models import layers as tl
from ekaid_torch.ops import graph as tg
from ekaid_torch.utils.dtypes import BF16, F32, cast_params_for_inference

RTOL = 2e-5
ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_matches_flax(use_bias):
    x = _x((3, 5, 12))
    flax = jl.DenseT(7, use_bias=use_bias, policy=JF32)
    tree = init_flax(flax, jnp.asarray(x))
    port = load_flax_params(tl.DenseT(12, 7, use_bias=use_bias), tree)
    _close(port(torch.from_numpy(x)), flax.apply(tree, jnp.asarray(x)))


def test_wndense_matches_flax():
    x = _x((4, 10), 1)
    flax = jl.WNDense(6, policy=JF32)
    tree = init_flax(flax, jnp.asarray(x))
    tree["params"]["g"] = np.float32(2.5)         # g != ||v|| at init
    port = load_flax_params(tl.WNDense(10, 6), tree)
    _close(port(torch.from_numpy(x)), flax.apply(tree, jnp.asarray(x)))


@pytest.mark.parametrize("act", [None, "relu"])
def test_fcnet_matches_flax(act):
    x = _x((2, 3, 9), 2)
    flax = jl.FCNet([9, 8, 5], act=act, dropout=0.2, policy=JF32)
    tree = init_flax(flax, jnp.asarray(x))
    port = load_flax_params(tl.FCNet([9, 8, 5], act=act), tree)
    _close(port(torch.from_numpy(x)),
           flax.apply(tree, jnp.asarray(x), train=False))


@pytest.mark.parametrize("pre_width", [0, 6])
def test_lstm_cell_matches_flax(pre_width):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 10 - pre_width)).astype(np.float32)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    c = rng.standard_normal((4, 8)).astype(np.float32)
    pre = (rng.standard_normal((4, 32)).astype(np.float32)
           if pre_width else None)
    kw = {"pre": pre, "pre_width": pre_width} if pre_width else {}
    flax = jl.LSTMCell(8, policy=JF32)
    tree = init_flax(flax, x, h, c, **kw)
    want_h, want_c = flax.apply(tree, x, h, c, **kw)
    port = load_flax_params(tl.LSTMCell(10, 8), tree)
    tkw = ({"pre": torch.from_numpy(pre), "pre_width": pre_width}
           if pre_width else {})
    got_h, got_c = port(torch.from_numpy(x), torch.from_numpy(h),
                        torch.from_numpy(c), **tkw)
    _close(got_h, want_h)
    _close(got_c, want_c)


def test_gru_matches_flax():
    x = _x((3, 7, 6), 4)
    flax = jl.GRU(5, policy=JF32)
    tree = init_flax(flax, jnp.asarray(x))
    port = load_flax_params(tl.GRU(6, 5), tree)
    _close(port(torch.from_numpy(x)), flax.apply(tree, jnp.asarray(x)))


def test_init_params_follows_reference_rules():
    dense = tl.init_params(tl.DenseT(100, 50), torch.Generator().manual_seed(0))
    assert dense.kernel.abs().max() <= 0.1 and dense.bias.abs().max() <= 0.1
    wn = tl.init_params(tl.WNDense(20, 4), torch.Generator().manual_seed(1))
    assert torch.allclose(wn.g, torch.linalg.norm(wn.v))
    table = tl.normal_table((6, 3), torch.Generator().manual_seed(2), 5)
    assert (table[5] == 0).all() and (table[:5] != 0).all()


def test_cast_params_for_inference_skips_weight_norm():
    model = torch.nn.Sequential(tl.DenseT(4, 3), tl.FCNet([3, 2]))
    cast_params_for_inference(model, BF16)
    assert model[0].kernel.dtype == torch.bfloat16
    assert model[0].bias.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model[1].parameters())
    assert cast_params_for_inference(tl.DenseT(2, 2), F32).kernel.dtype \
        == torch.float32


# ------------------------------------------------------------- graph ops --

def test_broadcast_adjacency_matches_jax():
    labels = np.random.default_rng(5).integers(0, 13, (2, 9, 9))
    want = jg.broadcast_adjacency(jnp.asarray(labels), 11, 7)
    got = tg.broadcast_adjacency(torch.from_numpy(labels), 11, 7)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_position_matrix_and_embedding_match_jax():
    bb = jax_batch(tiny_cfg(), 2, seed=6)["d_bb"]
    want = jg.position_matrix(jnp.asarray(bb), nongt_dim=5)
    got = tg.position_matrix(torch.from_numpy(bb), nongt_dim=5)
    _close(got, want, rtol=1e-5, atol=1e-5)
    _close(tg.position_embedding(got, feat_dim=16),
           jg.position_embedding(want, feat_dim=16), rtol=1e-4, atol=1e-4)


def test_spatial_adjacency_equals_jax_numpy_path():
    bb = jax_batch(tiny_cfg(), 3, seed=7)["q_bb"]
    np.testing.assert_array_equal(
        tg.spatial_adjacency(bb, pad_to=12),
        jg.spatial_adjacency(bb, pad_to=12, xp=np))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batch_equals_jax(seed):
    cfg = tiny_cfg()
    want = jax_batch(cfg, 4, seed=seed)
    got = port_batch(cfg, 4, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------- weight bridge --

def test_bridge_consumes_every_leaf():
    x = _x((2, 9), 8)
    flax = jl.FCNet([9, 4], act=None, policy=JF32)
    tree = init_flax(flax, jnp.asarray(x))
    port = load_flax_params(tl.FCNet([9, 4], act=None), tree)
    leaves = tree["params"]["WNDense_0"]
    for name, p in port.WNDense_0.named_parameters():
        np.testing.assert_array_equal(to_np(p), leaves[name])


def test_bridge_rejects_extra_missing_and_misshapen_leaves():
    x = _x((2, 9), 9)
    tree = init_flax(jl.DenseT(4, policy=JF32), jnp.asarray(x))["params"]
    with pytest.raises(KeyError, match="unknown leaves"):
        load_flax_params(tl.DenseT(9, 4), {**tree, "extra": np.zeros(1)})
    with pytest.raises(KeyError, match="missing leaves"):
        load_flax_params(tl.DenseT(9, 4), {"kernel": tree["kernel"]})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tl.DenseT(9, 5), tree)
