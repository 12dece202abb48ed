"""ekaid_torch encoder (question encoder, relation GATs, ChangeDetector)
against the JAX package at the smoke dims, f32.

Tolerance atol 1e-4, rtol 1e-4: the two libraries sum f32 products in
different orders across chained 1024-wide (here 64-wide) products."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NTOKEN, init_flax, port_cfg, tiny_cfg, to_np
from ekaid_tpu.data.synthetic import synthetic_batch
from ekaid_tpu.models import gat as jgat
from ekaid_tpu.models.ekaid import EkaidModel as JaxModel
from ekaid_tpu.models.language import QuestionEncoder as JaxQuestion
from ekaid_tpu.ops import graph as jg
from ekaid_tpu.utils.dtypes import F32 as JF32
from ekaid_torch.convert import load_flax_params
from ekaid_torch.models import gat as tgat
from ekaid_torch.models.ekaid import EkaidModel
from ekaid_torch.models.language import QuestionEncoder

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(tiny_cfg(), 3, seed=11)


@pytest.mark.parametrize("att_mode", ["fixed", "reference"])
def test_question_encoder_matches_jax(batch, att_mode):
    q = batch["question"]
    flax = JaxQuestion(NTOKEN, hidden_dim=64, att_mode=att_mode,
                       policy=JF32)
    tree = init_flax(flax, jnp.asarray(q))
    port = load_flax_params(
        QuestionEncoder(NTOKEN, hidden_dim=64, att_mode=att_mode), tree)
    _close(port(torch.from_numpy(q)),
           flax.apply(tree, jnp.asarray(q), train=False))


def _node_inputs(batch, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, 8, 64)).astype(np.float32)
    v[:, -1] = 0.0                             # a missing node
    q = rng.standard_normal((3, 64)).astype(np.float32)
    return v, q


@pytest.mark.parametrize("dir_reduce", ["reference", "sum"])
def test_explicit_relation_encoder_matches_jax(batch, dir_reduce):
    v, q = _node_inputs(batch, 12)
    adj = np.array(jg.broadcast_adjacency(
        jnp.asarray(batch["d_adj"]), 11, 8))
    kw = dict(v_dim=64, q_dim=64, out_dim=64, dir_num=2, label_num=11,
              nongt_dim=8, num_heads=4, dir_reduce=dir_reduce)
    flax = jgat.ExplicitRelationEncoder(policy=JF32, **kw)
    tree = init_flax(flax, v, adj, q)
    port = load_flax_params(tgat.ExplicitRelationEncoder(**kw), tree)
    _close(port(*map(torch.from_numpy, (v, adj, q))),
           flax.apply(tree, v, adj, q, train=False))


@pytest.mark.parametrize("dir_reduce", ["reference", "sum"])
def test_implicit_relation_encoder_matches_jax(batch, dir_reduce):
    v, q = _node_inputs(batch, 13)
    pos = np.array(jg.position_embedding(
        jg.position_matrix(jnp.asarray(batch["q_bb"]), nongt_dim=6), 16))
    kw = dict(v_dim=64, q_dim=64, out_dim=64, dir_num=2, pos_emb_dim=16,
              nongt_dim=6, num_heads=4, dir_reduce=dir_reduce)
    flax = jgat.ImplicitRelationEncoder(policy=JF32, **kw)
    tree = init_flax(flax, v, pos, q)
    port = load_flax_params(tgat.ImplicitRelationEncoder(**kw), tree)
    _close(port(*map(torch.from_numpy, (v, pos, q))),
           flax.apply(tree, v, pos, q, train=False))


def test_q_expand_v_cat_matches_jax(batch):
    v, q = _node_inputs(batch, 14)
    np.testing.assert_array_equal(
        to_np(tgat.q_expand_v_cat(torch.from_numpy(q), torch.from_numpy(v))),
        np.asarray(jgat.q_expand_v_cat(jnp.asarray(q), jnp.asarray(v))))


@pytest.fixture(scope="module")
def cd_tree(batch):
    """One reference init (graph 'all'); the other graphs' trees are its
    subsets, and branch_mix does not change the tree."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jb, init_flax(JaxModel(tiny_cfg(), ntoken=NTOKEN, policy=JF32),
                         jb, train=True)


_BRANCHES = {"all": ("semantic_relation", "spatial_relation", "imp_relation"),
             "i+s": ("spatial_relation", "imp_relation"),
             "semantic": ("semantic_relation",)}


@pytest.mark.parametrize("branch_mix,graph", [
    ("sequential", "all"), ("parallel", "all"), ("parallel", "i+s"),
    ("sequential", "semantic")])
def test_change_detector_matches_jax(batch, cd_tree, branch_mix, graph):
    cfg = tiny_cfg()
    cfg = cfg.replace(
        change_detector=cfg.change_detector.replace(branch_mix=branch_mix),
        train=cfg.train.replace(graph=graph))
    jb, full = cd_tree
    cd = {k: v for k, v in full["params"]["change_detector"].items()
          if k not in _BRANCHES["all"] or k in _BRANCHES[graph]}
    tree = {"params": {**full["params"], "change_detector": cd}}
    want = JaxModel(cfg, ntoken=NTOKEN, policy=JF32).apply(
        tree, jb, method="encode", train=False)
    port = EkaidModel(port_cfg(cfg), NTOKEN, device="cpu", seed=None)
    load_flax_params(port, tree)
    got = port.encode(batch)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])
