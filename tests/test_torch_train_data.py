"""ekaid_torch training data layer against the JAX package: both synthetic
corpora, the Loader's batches, length buckets, the vocabulary functions
and the HDF5 feature store."""

import json

import numpy as np
import pytest

from _torch_port import port_cfg, tiny_cfg
from ekaid_tpu.data import pipeline as jp
from ekaid_tpu.data import vocab as jv
from ekaid_torch.data import pipeline as pp
from ekaid_torch.data import vocab as pv


def _cfg(batch=4):
    cfg = tiny_cfg()
    return cfg.replace(data=cfg.data.replace(
        train=cfg.data.train.replace(batch_size=batch),
        test=cfg.data.test.replace(batch_size=batch)))


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("corpus", ["synthetic", "learnable"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_corpora_equal_jax(corpus, split):
    cfg = _cfg()
    if corpus == "learnable":
        j = jp.learnable_dataset(cfg, split, n_pairs=64, n_images=16)
        p = pp.learnable_dataset(port_cfg(cfg), split, n_pairs=64,
                                 n_images=16)
        _equal(j.store.rows, p.store.rows)
    else:
        j = jp.synthetic_dataset(cfg, split, n_pairs=40)
        p = pp.synthetic_dataset(port_cfg(cfg), split, n_pairs=40)
    for k in ("questions", "answers", "pos", "feature_idx", "split_idxs"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))
    idx = p.split_idxs[:5]
    _equal(p.sample_batch(idx), j.sample_batch(idx))
    _equal(p.sample(int(idx[0])), j.sample(int(idx[0])))


@pytest.mark.parametrize("feature_mode", ["single_ana", "single_loc"])
def test_feature_modes_equal_jax(feature_mode):
    cfg = _cfg()
    cfg = cfg.replace(data=cfg.data.replace(feature_mode=feature_mode,
                                            node_one_num=4))
    j = jp.synthetic_dataset(cfg, "train", n_pairs=12)
    p = pp.synthetic_dataset(port_cfg(cfg), "train", n_pairs=12)
    _equal(p.sample_batch(p.split_idxs[:3]), j.sample_batch(j.split_idxs[:3]))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3),
    dict(shuffle=False, pad_final=True, wire="compact"),
    dict(shuffle=True, seed=5, drop_remainder=False),
])
def test_loader_batches_equal_jax(threads, kw):
    """Two epochs, the second resumed mid-way with skip_next, batch for
    batch bit-equal to the reference Loader."""
    cfg = _cfg(batch=6)
    j = jp.learnable_dataset(cfg, "train", n_pairs=64, n_images=16)
    p = pp.learnable_dataset(port_cfg(cfg), "train", n_pairs=64,
                             n_images=16)
    jl = jp.Loader(j, num_threads=threads, **kw)
    pl = pp.Loader(p, num_threads=threads, **kw)
    assert len(pl) == len(jl)
    for epoch in range(2):
        if epoch:
            jl.skip_next = pl.skip_next = 2
        got, want = list(pl), list(jl)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _equal(a, b)
    assert pl.epoch == jl.epoch == 2


def test_loader_surfaces_worker_errors():
    cfg = _cfg()
    p = pp.synthetic_dataset(port_cfg(cfg), "train", n_pairs=16)
    p.feature_idx = p.feature_idx[:1]             # out-of-range rows
    with pytest.raises(IndexError):
        list(pp.Loader(p, num_threads=2))


def test_trim_batch_to_bucket_equals_jax():
    cfg = _cfg()
    j = jp.synthetic_dataset(cfg, "train", n_pairs=16)
    batch = j.sample_batch(j.split_idxs[:4])
    for buckets in ((), (3,), (4, 8), (100,), (6, 2)):
        _equal(pp.trim_batch_to_bucket(batch, buckets, 12),
               jp.trim_batch_to_bucket(batch, buckets, 12))
    _equal(pp.compact_wire(batch), jp.compact_wire(batch))


def test_vocabulary_functions_equal_jax(tmp_path):
    texts = ["Is there a change in the left lung?",
             "yes, the opacity has increased.",
             "what abnormalities are seen in this image? atelectasis, "
             "pleural effusion", "it's 2.5 cm and enlarging"]
    toks = [pv.treebank_tokenize(t) for t in texts]
    assert toks == [jv.treebank_tokenize(t) for t in texts]
    pvoc, jvoc = pv.Vocabulary.build(toks), jv.Vocabulary.build(toks)
    assert pvoc.word_to_idx == jvoc.word_to_idx and pvoc.size == jvoc.size
    for t in toks:
        assert pvoc.encode(t, 8) == jvoc.encode(t, 8)
        assert pv.pos_tag_lite(t) == jv.pos_tag_lite(t)
        assert pv.pos_tag(t) == jv.pos_tag(t)
    ids = np.array([[2, 5, 7, 0, 3], [1, 99, 0, 0, 0]])
    assert pvoc.decode_batch(ids) == jvoc.decode_batch(ids)
    pvoc.save(tmp_path / "v.json")
    assert pv.Vocabulary.load(tmp_path / "v.json").word_to_idx == \
        json.loads((tmp_path / "v.json").read_text())


@pytest.mark.parametrize("chunks", [None, (2, 4, 6)])
def test_h5_feature_store_reads_a_written_file(tmp_path, chunks):
    """A graph file written here, read by both stores (raw mmap rows for
    the unfiltered layouts, h5py for a compressed one)."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    m, n, f, pad = 9, 4, 6, 7
    arrays = {"image_features": rng.standard_normal((m, n, f)).astype(
                  np.float32),
              "image_bb": rng.uniform(0, 9, (m, n, 4)).astype(np.float32),
              "image_adj_matrix": rng.integers(0, 11, (m, pad, pad)),
              "semantic_adj_matrix": rng.integers(0, 3, (m, pad, pad))}
    for name, comp in (("raw.h5", None), ("gz.h5", "gzip")):
        path = str(tmp_path / name)
        with h5py.File(path, "w") as h:
            for k, v in arrays.items():
                ch = None if chunks is None else (2,) + v.shape[1:]
                h.create_dataset(k, data=v, chunks=ch if comp is None
                                 else (2,) + v.shape[1:], compression=comp)
        ps, js = pp.H5FeatureStore(path), jp.H5FeatureStore(path)
        assert (ps._raw is None) == (comp is not None) == (js._raw is None)
        assert len(ps) == m
        idx = [3, 0, 3, 8]
        _equal(ps.get_batch(idx), js.get_batch(idx))
        _equal(ps.get(5), js.get(5))
        np.testing.assert_array_equal(ps.get(2)["adj"],
                                      arrays["image_adj_matrix"][2])
        assert ps.clone() is ps or comp is not None

