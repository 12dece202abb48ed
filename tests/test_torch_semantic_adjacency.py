"""`ekaid_torch.ops.graph.semantic_adjacency`, the batched torch op of
the expert-knowledge semantic adjacency, against the reference's
`ekaid_tpu.ops.graph.semantic_adjacency` on the same tables, and against
the table that the extraction path's numpy builder
(`extract/pipeline.py::combine_pair`) writes for a record."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ekaid_torch.data.knowledge as tk
import ekaid_torch.extract.pipeline as tpipe
from ekaid_tpu.ops import graph as jgraph
from ekaid_torch.ops import graph as tgraph


def _tables(seed):
    """The knowledge tables with a co-occurrence table from seeded
    counts, so that labels 1 and 2 both occur."""
    counts = np.random.default_rng(seed).uniform(1, 9, (14, 14))
    return tk.semantic_tables(counting_adj=counts + counts.T)


def _ids(rng, shape, sentinel_share=0.3):
    ids = rng.integers(0, tk.NUM_CLASSES, shape)
    return np.where(rng.uniform(size=shape) < sentinel_share,
                    tk.NUM_CLASSES, ids)


def _both(ids, tables, pad_to=None):
    got = tgraph.semantic_adjacency(torch.as_tensor(ids),
                                    *map(torch.as_tensor, tables),
                                    pad_to=pad_to)
    want = jgraph.semantic_adjacency(jnp.asarray(ids),
                                     *map(jnp.asarray, tables),
                                     pad_to=pad_to)
    return got, np.asarray(want)


@pytest.mark.parametrize("pad_to", [None, 52, 100])
@pytest.mark.parametrize("seed", range(3))
def test_equals_the_reference(seed, pad_to):
    """A batch [3, 52] of combined class ids, the sentinel among them,
    with and without padding: int32 and equal to JAX's, labels 1 and 2
    both present, no edge on a sentinel node."""
    rng = np.random.default_rng(seed)
    ids = _ids(rng, (3, 52))
    got, want = _both(ids, _tables(seed), pad_to)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (3, pad_to or 52, pad_to or 52)
    np.testing.assert_array_equal(got.numpy(), want)
    assert {1, 2} <= set(np.unique(want).tolist())
    sentinel = ids == tk.NUM_CLASSES
    assert (got.numpy()[:, :52, :52][np.broadcast_to(
        sentinel[:, :, None], (3, 52, 52))] == 0).all()
    if pad_to and pad_to > 52:
        assert (got[:, 52:].numpy() == 0).all()
        assert (got[:, :, 52:].numpy() == 0).all()


def test_toy_world_and_leading_dims():
    """The reference's toy world (anatomy 0, 1; disease 2, 3; sentinel
    4; 2 and 3 co-occur) under two leading dims."""
    tables = (np.array([0, 1, 0, 1, -1]),
              np.array([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 2, 2, 0],
                        [0, 0, 2, 2, 0], [0, 0, 0, 0, 0]], np.int32),
              np.array([False, False, True, True, False]))
    ids = np.array([[[0, 1, 2, 3, 4], [4, 3, 2, 1, 0]]])
    got, want = _both(ids, tables, pad_to=7)
    np.testing.assert_array_equal(got.numpy(), want)
    adj = got.numpy()[0, 0]
    assert adj[0, 2] == adj[2, 0] == adj[1, 3] == 1
    assert adj[0, 1] == 0 and adj[2, 3] == adj[2, 2] == 2
    assert (adj[4] == 0).all() and (adj[:, 4] == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_equals_the_record_of_the_numpy_builder(seed):
    """`combine_pair`'s `semantic_adj_matrix` for one image's anatomy
    and disease extractions equals the op on the record's `bbox_label`,
    padded to the record's size."""
    rng = np.random.default_rng(seed)
    found = rng.uniform(size=26) > 0.2
    xy = rng.uniform(0, 700, (26, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 300, (26, 2))], 1)
    ana = {"features": rng.standard_normal((26, 8)).astype(np.float32),
           "boxes": np.where(found[:, None], boxes, 0).astype(np.float32),
           "classes": np.where(found, np.arange(26), 26), "found": found}
    dis = {"features": rng.standard_normal((26, 8)).astype(np.float32),
           "classes": np.where(rng.uniform(size=26) > 0.5,
                               rng.integers(0, 22, 26), 22)}
    tables = _tables(seed)
    rec = tpipe.combine_pair(ana, dis, *tables, adj_pad=100)
    got = tgraph.semantic_adjacency(
        torch.as_tensor(rec["bbox_label"])[None],
        *map(torch.as_tensor, tables), pad_to=100)[0]
    np.testing.assert_array_equal(got.numpy(), rec["semantic_adj_matrix"])
    assert {1, 2} <= set(np.unique(rec["semantic_adj_matrix"]).tolist())
