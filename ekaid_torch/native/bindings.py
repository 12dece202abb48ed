"""ctypes bindings of the port's native host library (counterpart of
`ekaid_tpu/native/bindings.py`).

`graph.cpp` (the spatial adjacency, the disease-to-anatomy matching
and the exact-match comparison of token rows), `gather.cpp` (the threaded row
gather of `data/pipeline.py::_RawRows`) and `caption.cpp` (ROUGE-L's LCS,
BLEU's clipped counts and CIDEr-D, each over a whole eval in one call) are
compiled together by g++ (`CXX` overrides it) into one shared
library under `build/ekaid_torch/native/` at the repository root, on
first use. The library is named by a hash of the three sources, the
flags, the compiler's `--version` and the host CPU's model and flags
(`-march=native` makes it host-specific). Concurrent first uses (test
workers, loader threads) build once: the build runs under a file lock
into a temporary file that `os.replace` puts in place. A failed build
raises with the compiler's message; nothing falls back quietly. The
numpy and Python versions stay in their modules as the plain versions,
and each caller reaches this module through `native()`, which the tests
replace to run them.

    python -m ekaid_torch.native.bindings      # build, print the path
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import itertools
import os
import platform
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SRC = Path(__file__).resolve().parent
SOURCES = (SRC / "graph.cpp", SRC / "gather.cpp", SRC / "caption.cpp")
BUILD = SRC.parent.parent / "build" / "ekaid_torch" / "native"
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
         "-shared")
GATHER_THREADS = max(1, min(8, os.cpu_count() or 1))

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def host_cpu() -> str:
    """The host CPU's vendor, family, model, stepping, model name and
    sorted feature flags (the first processor of /proc/cpuinfo), or the
    platform's machine and processor names where that file is absent."""
    parts = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                        # end of the first CPU
                key, _, val = line.partition(":")
                key, val = key.strip(), val.strip()
                if key in ("vendor_id", "cpu family", "model", "stepping",
                           "model name"):
                    parts.append(f"{key}={val}")
                elif key == "flags":
                    parts.append("flags=" + " ".join(sorted(val.split())))
    except OSError:
        pass
    return "|".join(parts) or f"{platform.machine()}|{platform.processor()}"


def _key(cxx: str) -> str:
    """Hash of what the library is built from and for."""
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"native library: compiler {cxx!r} does not "
                           f"run: {e}") from e
    h = hashlib.sha256()
    for f in SOURCES:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(version.encode())
    h.update(host_cpu().encode())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD) -> Path:
    """The library for this host, compiled into `build_dir` unless one
    built from the same inputs is there."""
    cxx = compiler()
    lib = Path(build_dir) / f"libekaid_native-{_key(cxx)}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():                         # built while we waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=lib.parent)
        os.close(fd)
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp,
                               *map(str, SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"native library: {cxx} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    signatures = {
        "spatial_adjacency_batch": ([f32p, i64, i64, i64, ctypes.c_float,
                                     ctypes.c_float, i32p], None),
        "match_disease": ([f32p, u8p, i64, f32p, i64, i32p], None),
        "exact_match": ([i32p, i32p, i64, i64, u8p], None),
        "lcs_len_batch": ([i32p, i64p, i64p, i64, i64p], None),
        "bleu_counts_batch": ([i32p, i64p, i64p, i64, i64, i64p, i64p],
                              None),
        "cider_batch": ([i32p, i64p, i64p, i64, i64, i64, ctypes.c_double,
                         f64p], None),
        "gather_rows": ([ctypes.c_void_p, i64p, i64, i64, ctypes.c_void_p,
                         i64], None),
        "gather_rows_i64_i32": ([ctypes.c_void_p, i64p, i64, i64, i32p,
                                 i64], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> ctypes.CDLL:
    """The library's ctypes handle, built on first use (raises when the
    build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def native():
    """This module with its library loaded: what the callers' native
    branches call (the tests replace a caller's reference to it with
    `lambda: None` to run the plain version)."""
    load()
    return sys.modules[__name__]


# ------------------------------------------------------------- the graph ---

def spatial_adjacency_batch(boxes: np.ndarray, pad: int = 100,
                            img_w: float = 1024.0, img_h: float = 1024.0
                            ) -> np.ndarray:
    """boxes [N, R, 4] (or [R, 4]) float32 -> [N, pad, pad] int32
    adjacency labels (`ops/graph.py::spatial_adjacency` of each image,
    padded to `pad`)."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.ndim == 2:
        boxes = boxes[None]
    n, r = boxes.shape[0], boxes.shape[1]
    if boxes.shape[2:] != (4,) or r > pad:
        raise ValueError(f"boxes {boxes.shape}: want [N, R <= {pad}, 4]")
    out = np.zeros((n, pad, pad), np.int32)
    load().spatial_adjacency_batch(boxes, n, r, pad, img_w, img_h, out)
    return out


def match_disease(dis_boxes: np.ndarray, dis_valid: np.ndarray,
                  ana_boxes: np.ndarray) -> np.ndarray:
    """The disease index [n_ana] int32 each anatomy box takes under
    `extract/pipeline.py::match_disease_to_anatomy`'s greedy rule, -1
    where none: dis_boxes [n_dis, 4] in score order, dis_valid [n_dis],
    ana_boxes [n_ana, 4]."""
    dis_boxes = np.ascontiguousarray(dis_boxes, np.float32)
    ana_boxes = np.ascontiguousarray(ana_boxes, np.float32)
    valid = np.ascontiguousarray(dis_valid, np.uint8)
    if (dis_boxes.ndim != 2 or dis_boxes.shape[1:] != (4,)
            or ana_boxes.ndim != 2 or ana_boxes.shape[1:] != (4,)
            or valid.shape != (len(dis_boxes),)):
        raise ValueError(f"boxes {dis_boxes.shape}, valid {valid.shape}, "
                         f"anatomy {ana_boxes.shape}: want [n, 4], [n], "
                         "[m, 4]")
    out = np.empty(len(ana_boxes), np.int32)
    load().match_disease(dis_boxes, valid, len(dis_boxes), ana_boxes,
                         len(ana_boxes), out)
    return out


def exact_match(seq: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[n] uint8: 1 where row i of seq equals row i of gt up to and
    including its first 0 token (or over the whole row), for [n, t]
    token arrays."""
    seq = np.ascontiguousarray(seq, np.int32)
    gt = np.ascontiguousarray(gt, np.int32)
    if seq.ndim != 2 or seq.shape != gt.shape:
        raise ValueError(f"seq {seq.shape}, gt {gt.shape}: want two [n, t]")
    out = np.empty(len(seq), np.uint8)
    load().exact_match(seq, gt, seq.shape[0], seq.shape[1], out)
    return out


# ------------------------------------------------------------ the gather ---

def _check_gather(starts, rowlen, out, dtype):
    if out.dtype != dtype or not out.flags.c_contiguous or out.shape != (
            len(starts), rowlen):
        raise ValueError(f"out {out.dtype} {out.shape}: want a contiguous "
                         f"{np.dtype(dtype)} [{len(starts)}, {rowlen}]")


def gather_rows(base_addr: int, starts: np.ndarray, rowbytes: int,
                out: np.ndarray) -> bool:
    """out[i] = the `rowbytes` bytes at base_addr + starts[i], on
    GATHER_THREADS threads without the GIL. The caller keeps the mapping
    at base_addr alive across the call and the rows inside it."""
    starts = np.ascontiguousarray(starts, np.int64)
    _check_gather(starts, rowbytes, out, np.uint8)
    load().gather_rows(base_addr, starts, len(starts), rowbytes,
                       out.ctypes.data, GATHER_THREADS)
    return True


def gather_rows_i64_i32(base_addr: int, starts: np.ndarray, rowelems: int,
                        out: np.ndarray) -> bool:
    """gather_rows of int64 rows of `rowelems` elements, narrowed to
    int32 in the same pass (the reference's adjacency dtype)."""
    starts = np.ascontiguousarray(starts, np.int64)
    _check_gather(starts, rowelems, out, np.int32)
    load().gather_rows_i64_i32(base_addr, starts, len(starts), rowelems,
                               out, GATHER_THREADS)
    return True


# ------------------------------------------------------- caption metrics ---

class Segments(NamedTuple):
    """Token-id lists packed for the caption entry points: list k is
    ids[off[k]:off[k + 1]], and segment s is lists seg[s] (its
    candidate) to seg[s + 1] - 1 (its references)."""
    ids: np.ndarray     # int32
    off: np.ndarray     # int64 [lists + 1]
    seg: np.ndarray     # int64 [segments + 1]

    def refs(self, n_seg: int) -> int:
        """The references of the first n_seg segments."""
        return int(self.seg[n_seg]) - n_seg


MAX_N = 4   # an n-gram's key holds 4 ids


def pack_segments(segments) -> Segments:
    """Segments [candidate, *references] of token-id lists -> Segments.
    The ids are ints >= 0 that name one token alike in every list (one
    numbering for the corpus), under 2**31."""
    lists = [toks for s in segments for toks in s]
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, lists), np.int64, len(lists)),
              out=off[1:])
    ids = np.fromiter(itertools.chain.from_iterable(lists), np.int32,
                      int(off[-1]))
    if ids.size and ids.min() < 0:
        raise ValueError(f"token id {ids.min()}: want ids >= 0")
    seg = np.zeros(len(segments) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, segments), np.int64, len(segments)),
              out=seg[1:])
    return Segments(ids, off, seg)


def _check_segments(p: Segments, n_seg: int, max_n: int = MAX_N):
    if not 0 <= n_seg < len(p.seg) or not 1 <= max_n <= MAX_N:
        raise ValueError(f"{n_seg} of {len(p.seg) - 1} segments, orders "
                         f"1..{max_n}: want n_seg within, max_n 1..{MAX_N}")


def lcs_len_batch(p: Segments, n_seg: int) -> np.ndarray:
    """ROUGE-L's LCS lengths [p.refs(n_seg)] int64 of each of the first
    n_seg segments' candidate with each of its references, in order, in
    one call."""
    _check_segments(p, n_seg)
    out = np.zeros(p.refs(n_seg), np.int64)
    load().lcs_len_batch(p.ids, p.off, p.seg, n_seg, out)
    return out


def bleu_counts_batch(p: Segments, n_seg: int, max_n: int = 4):
    """Clipped n-gram (matches, totals) [n_seg, max_n] int64 of the
    first n_seg segments, in one call."""
    _check_segments(p, n_seg, max_n)
    matches = np.zeros((n_seg, max_n), np.int64)
    totals = np.zeros((n_seg, max_n), np.int64)
    load().bleu_counts_batch(p.ids, p.off, p.seg, n_seg, max_n, matches,
                             totals)
    return matches, totals


def cider_batch(p: Segments, n_seg: int, max_n: int = 4,
                sigma: float = 6.0) -> np.ndarray:
    """CIDEr-D [n_seg] float64 of the first n_seg segments' candidates,
    in one call: the idf counts the references of every segment in p,
    each segment an image."""
    _check_segments(p, n_seg, max_n)
    out = np.zeros(n_seg, np.float64)
    load().cider_batch(p.ids, p.off, p.seg, len(p.seg) - 1, n_seg, max_n,
                       sigma, out)
    return out


if __name__ == "__main__":
    print(build())
