"""ekaid_torch's native host library (`ekaid_torch/native/`) against the
port's numpy and Python versions and against the JAX package's
`ekaid_tpu.native` (each C function, as `tests/test_native.py` holds the
reference's), its build (hash-named, concurrent first builds, a broken
compiler) and the three callers: extraction's adjacency, `_RawRows.take`
and the caption metrics.

Tolerances: the adjacency, LCS, the BLEU counts and the row gathers are
integer or byte results, held exactly; the caption scores native against
Python and the reference within 1e-12 relative, and per image against
Python exactly."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ekaid_tpu.metrics import caption as jcap
from ekaid_tpu.native import bindings as jnat
from ekaid_torch.data import pipeline as dp
from ekaid_torch.extract import pipeline as xp
from ekaid_torch.metrics import caption as cap
from ekaid_torch.native import bindings as nat
from ekaid_torch.ops.graph import spatial_adjacency

ROOT = Path(__file__).resolve().parent.parent


def random_boxes(rng, n, size=1024):
    x1 = rng.uniform(0, size * 0.8, n)
    y1 = rng.uniform(0, size * 0.8, n)
    w = rng.uniform(5, size * 0.5, n)
    h = rng.uniform(5, size * 0.5, n)
    return np.stack([x1, y1, np.minimum(x1 + w, size),
                     np.minimum(y1 + h, size)], -1).astype(np.float32)


@pytest.fixture
def plain(monkeypatch):
    """Run the callers' plain versions: each caller's `_native` gives
    None."""
    def use_plain():
        for mod in (cap, dp, xp):
            monkeypatch.setattr(mod, "_native", lambda: None)
    return use_plain


# ------------------------------------------------------------- the build ---

def test_build_is_named_by_its_inputs_and_reused(tmp_path, monkeypatch):
    lib = nat.build(tmp_path)
    assert lib.name.startswith("libekaid_native-") and lib.exists()
    assert nat.build(tmp_path) == lib
    assert sorted(p.name for p in tmp_path.glob("*.so*")) == [lib.name]
    # another host CPU (-march=native) names another library
    monkeypatch.setattr(nat, "host_cpu", lambda: "another cpu")
    assert nat._key(nat.compiler()) != lib.name[16:-3]


_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from pathlib import Path; import ctypes; "
          "from ekaid_torch.native import bindings; "
          "p = bindings.build(Path(sys.argv[2])); ctypes.CDLL(str(p)); "
          "print(p)")


def test_concurrent_first_builds_end_in_one_loadable_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(ROOT),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.glob("*.so*")] == \
        [Path(paths.pop()).name]


def test_a_broken_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="does not run"):
        nat.build(tmp_path)
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\nif [ \"$1\" = --version ]; then echo fake 1;"
                    " exit 0; fi\necho 'no compiling here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="no compiling here"):
        nat.build(tmp_path / "b")
    assert not list((tmp_path / "b").glob("*.so*"))


# ------------------------------------------------------------- the graph ---

def test_adjacency_matches_numpy_and_the_reference(rng):
    boxes = np.stack([random_boxes(rng, 52) for _ in range(4)])
    got = nat.spatial_adjacency_batch(boxes, pad=100)
    assert got.dtype == np.int32 and got.shape == (4, 100, 100)
    np.testing.assert_array_equal(
        got, np.stack([spatial_adjacency(b, pad_to=100) for b in boxes]))
    np.testing.assert_array_equal(got, jnat.spatial_adjacency_batch(
        boxes, pad=100))


def test_combine_pair_native_equals_numpy(rng, plain):
    from ekaid_torch.data import knowledge as K
    n = 26
    ana = {"features": rng.standard_normal((n, 8)).astype(np.float32),
           "boxes": random_boxes(rng, n),
           "classes": np.arange(n), "found": np.ones(n, bool)}
    dis = {"features": rng.standard_normal((n, 8)).astype(np.float32),
           "classes": rng.integers(0, len(K.DISEASE_CLASSES) + 1, n)}
    tables = K.semantic_tables()
    got = xp.combine_pair(ana, dis, *tables)
    plain()
    want = xp.combine_pair(ana, dis, *tables)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _match_plain(dis_boxes, dis_valid, ana_boxes):
    """match_disease's plain version: the disease index each anatomy
    box takes in `match_disease_to_anatomy`, -1 where none."""
    n = len(dis_boxes)
    _, cls = xp.match_disease_to_anatomy(
        dis_boxes, np.arange(n, dtype=np.float32)[:, None], np.arange(n),
        np.asarray(dis_valid, bool), ana_boxes, n)
    return np.where(cls >= n, -1, cls).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "steals", "none valid",
                                  "fewer diseases", "repeated boxes"])
def test_match_disease_matches_python_and_the_reference(rng, case):
    ana = random_boxes(rng, 26)
    dis = random_boxes(rng, 26)
    valid = rng.random(26) > 0.3
    if case == "steals":            # every disease near an anatomy box
        dis = ana[rng.permutation(26)] + rng.uniform(-20, 20, (26, 4))
        dis = dis.astype(np.float32)
    elif case == "none valid":
        valid[:] = False
    elif case == "fewer diseases":
        dis, valid = dis[:5], valid[:5]
    elif case == "repeated boxes":
        dis[1::2] = dis[0::2]
    got = nat.match_disease(dis, valid, ana)
    assert got.dtype == np.int32 and got.shape == (26,)
    np.testing.assert_array_equal(got, _match_plain(dis, valid, ana))
    np.testing.assert_array_equal(got, jnat.match_disease(dis, valid, ana))


def test_exact_match_matches_numpy_and_the_reference(rng):
    gt = rng.integers(1, 9, (64, 12)).astype(np.int32)
    ends = rng.integers(0, 13, 64)
    for i, e in enumerate(ends):
        gt[i, e:] = 0
    seq = gt.copy()
    seq[::3, 2] += 1                   # differ before the end
    seq[1::3, -1] = 7                  # differ past the first 0 only
    got = nat.exact_match(seq, gt)
    assert got.dtype == np.uint8 and got.shape == (64,)
    want = np.array([all(a == b for a, b in zip(
        s[:list(g).index(0) + 1] if 0 in g else s,
        g[:list(g).index(0) + 1] if 0 in g else g))
        for s, g in zip(seq, gt)], np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnat.exact_match(seq, gt))
    assert 0 < got.sum() < 64


# ------------------------------------------------------------ the gather ---

def test_gather_rows_match_numpy_slicing(tmp_path, rng):
    path = tmp_path / "rows.bin"
    rows = rng.integers(-2**40, 2**40, (1000, 33), dtype=np.int64)
    rows.tofile(path)
    mm = np.memmap(path, np.uint8, "r")
    idx = rng.integers(0, 1000, 300)
    rowbytes = 33 * 8
    starts = idx * rowbytes
    out = np.empty((300, rowbytes), np.uint8)
    assert nat.gather_rows(mm.ctypes.data, starts, rowbytes, out)
    want = np.stack([np.asarray(mm[s:s + rowbytes]) for s in starts])
    np.testing.assert_array_equal(out, want)
    out32 = np.empty((300, 33), np.int32)
    assert nat.gather_rows_i64_i32(mm.ctypes.data, starts, 33, out32)
    np.testing.assert_array_equal(out32, rows[idx].astype(np.int32))
    for ref, arr in ((jnat.gather_rows, np.empty_like(out)),
                     (jnat.gather_rows_i64_i32, np.empty_like(out32))):
        n = rowbytes if arr.dtype == np.uint8 else 33
        if ref(mm.ctypes.data, starts, n, arr):
            np.testing.assert_array_equal(arr, out if n == rowbytes
                                          else out32)
    with pytest.raises(ValueError, match="out"):
        nat.gather_rows(mm.ctypes.data, starts, rowbytes, out[:5])


@pytest.mark.parametrize("chunks", [None, 2])
def test_raw_rows_take_native_equals_numpy(tmp_path, rng, plain, chunks):
    """`_RawRows.take` through a real HDF5 file: the native gathers equal
    the numpy slicing and h5py's own read, int64 -> int32 included."""
    h5py = pytest.importorskip("h5py")
    arrays = {"image_features": rng.standard_normal((9, 4, 6)).astype(
                  np.float32),
              "image_bb": rng.uniform(0, 9, (9, 4, 4)).astype(np.float32),
              "image_adj_matrix": rng.integers(0, 11, (9, 7, 7)),
              "semantic_adj_matrix": rng.integers(0, 3, (9, 7, 7))}
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w") as h:
        for k, v in arrays.items():
            h.create_dataset(k, data=v, chunks=None if chunks is None
                             else (chunks,) + v.shape[1:])
    idx = [3, 0, 3, 8, -1]
    store = dp.H5FeatureStore(path)
    assert store._raw is not None
    got = {k: store._raw[k].take(idx, dt)
           for k, dt in store._DTYPES.items()}
    got["adj64"] = store._raw["adj"].take(idx)
    plain()
    want = {k: store._raw[k].take(idx, dt)
            for k, dt in store._DTYPES.items()}
    want["adj64"] = store._raw["adj"].take(idx)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["adj"],
                                  arrays["image_adj_matrix"][idx])
    assert got["adj"].dtype == np.int32 and got["adj64"].dtype == np.int64


# ------------------------------------------------------- caption metrics ---

VOCAB = ["yes", "no", "lung", "effusion", "the", "left", "is", "worse",
         "nodule", "illness", "disease", "has", "changed", "cats", "cat"]


def _corpus(rng, n=30):
    def sent(k):
        return [VOCAB[i] for i in rng.integers(0, len(VOCAB), k)]

    gts = {str(i): [sent(rng.integers(1, 14))
                    for _ in range(rng.integers(1, 3))] for i in range(n)}
    res = {str(i): sent(rng.integers(1, 14)) for i in range(n)}
    return gts, res


def _scores(gts, res):
    return {"bleu": cap.bleu(gts, res), "rouge": cap.rouge_l(gts, res),
            "meteor": cap.meteor15(gts, res), "cider": cap.cider(gts, res)}


def _assert_cider_close(got, want):
    """CIDEr's mean and every per-image value within 1e-12 relative:
    only the order of its float sums differs."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    assert list(got[1]) == list(want[1])
    np.testing.assert_allclose(list(got[1].values()),
                               list(want[1].values()), rtol=1e-12, atol=0)


def test_caption_kernels_match_python(rng):
    """One batch call over 50 packed segments against the Python
    versions and the reference's per-segment kernels; the same counts
    when the ids are renamed to ids past 16 bits, as a corpus-wide
    numbering gives; negative ids refused."""
    segs = [[[int(w) for w in rng.integers(0, 6, rng.integers(0, 20))]
             for _ in range(rng.integers(1, 4))] for _ in range(50)]
    p = nat.pack_segments(segs)
    lcs = nat.lcs_len_batch(p, len(segs))
    m, t = nat.bleu_counts_batch(p, len(segs), 4)
    lcs_of = iter(lcs.tolist())
    for k, s in enumerate(segs):
        cand = np.asarray(s[0], np.int32)
        for ref in s[1:]:
            assert next(lcs_of) == cap._lcs_len(ref, s[0]) == \
                jnat.lcs_len(np.asarray(ref, np.int32), cand)
        jm, jt = jnat.bleu_counts(cand,
                                  [np.asarray(r, np.int32) for r in s[1:]],
                                  4)
        np.testing.assert_array_equal(m[k], jm)
        np.testing.assert_array_equal(t[k], jt)
        assert t[k].tolist() == [max(0, len(s[0]) - n) for n in range(4)]
    assert next(lcs_of, None) is None and len(lcs) == p.refs(len(segs))
    wide = [0, 1, 65535, 65536, 65537, 2 ** 31 - 1]
    w = nat.pack_segments([[[wide[i] for i in toks] for toks in s]
                           for s in segs])
    np.testing.assert_array_equal(nat.lcs_len_batch(w, len(segs)), lcs)
    for got, want in zip(nat.bleu_counts_batch(w, len(segs), 4), (m, t)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nat.cider_batch(w, len(segs)),
                                  nat.cider_batch(p, len(segs)))
    with pytest.raises(ValueError, match="ids >= 0"):
        nat.pack_segments([[[0, -1]]])
    with pytest.raises(ValueError, match="max_n"):
        nat.bleu_counts_batch(p, len(segs), 5)


def test_caption_metrics_native_equal_python(rng, plain):
    gts, res = _corpus(rng)
    native = _scores(gts, res)
    ref = {"bleu": jcap.bleu(gts, res), "rouge": jcap.rouge_l(gts, res),
           "meteor": jcap.meteor15(gts, res), "cider": jcap.cider(gts, res)}
    plain()
    python = _scores(gts, res)
    for k in ("bleu", "rouge", "meteor", "cider"):
        np.testing.assert_allclose(native[k][0], python[k][0], rtol=1e-12,
                                   atol=0, err_msg=k)
        np.testing.assert_allclose(native[k][0], ref[k][0], rtol=1e-12,
                                   atol=0, err_msg=k)
    assert native["rouge"] == python["rouge"]
    assert native["meteor"] == python["meteor"]
    assert native["bleu"][1] == python["bleu"][1]
    _assert_cider_close(native["cider"], python["cider"])
    _assert_cider_close(native["cider"], ref["cider"])


@pytest.mark.parametrize("shape", ["empty candidates", "many references",
                                   "long answers", "one word"])
def test_caption_batches_equal_python(rng, plain, shape):
    """BLEU, ROUGE-L and CIDEr through one native call each, at the
    shapes that move the batch's offsets: empty candidates, up to 5
    references a segment, answers up to the decode's 90 tokens, one-word
    answers."""
    lo, hi, refs = {"empty candidates": (0, 4, 1),
                    "many references": (1, 12, 5),
                    "long answers": (40, 91, 2),
                    "one word": (1, 2, 1)}[shape]

    def sent(lo_):
        return [VOCAB[i] for i in rng.integers(0, len(VOCAB),
                                               rng.integers(lo_, hi))]

    gts = {str(i): [sent(max(lo, 1)) for _ in range(rng.integers(1, refs
                                                                 + 1))]
           for i in range(40)}
    res = {str(i): sent(lo) for i in range(40)}
    native = (cap.bleu(gts, res), cap.rouge_l(gts, res), cap.cider(gts, res))
    plain()
    python = (cap.bleu(gts, res), cap.rouge_l(gts, res), cap.cider(gts, res))
    assert native[:2] == python[:2]
    _assert_cider_close(native[2], python[2])

