"""Build and load the port's CUDA kernels.

Each source under `ekaid_torch/csrc/` is compiled by `nvcc` for sm_90a
into a shared library with a plain C interface under `build/ekaid_torch/`
at the repository root, on first use, and loaded with ctypes. A library
is named by a hash of its source, the headers beside it, the nvcc flags
and the nvcc version, and is reused only while all of them are
unchanged. Nothing here runs at import time.

A serving artifact (`serving/artifact.py`) carries built libraries to
a host that need not have nvcc: `source_hash` names what a library was
built from without asking nvcc, and `load_prebuilt` loads a library at
a given path in place of `build`, never running nvcc.

    python -m ekaid_torch.kernels      # build every kernel, print seconds
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build" / "ekaid_torch"
SOURCES = {"greedy_decode": CSRC / "greedy_decode.cu",
           "roi_align": CSRC / "roi_align.cu",
           "nms": CSRC / "nms.cu",
           "group_norm": CSRC / "group_norm.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_I, _P = ctypes.c_int, ctypes.c_void_p
# each library's entry point: (name, argtypes); every one returns a CUDA
# error code (int)
ENTRY = {
    "greedy_decode": ("ekaid_greedy_decode", [_I, _P, _P, _P, _P]),
    # dtype, round_a, level table, rois, n, rois per image, out, C,
    # out_size, sampling ratio, geometry (or null), stream
    "roi_align": ("ekaid_roi_align", [_I, _I, _P, _P, _I, _I, _P, _I, _I,
                                      _I, _P, _P]),
    # boxes, scores, iou threshold, indices, valid, scratch, images, rows,
    # slots, full mask, stream
    "nms": ("ekaid_nms", [_P, _P, ctypes.c_float, _P, _P, _P, _I, _I, _I,
                          _I, _P]),
    # x, residual (or null), y, gamma, beta, affine bf16, epilogue, N, P,
    # C, groups, blocks, split, threads, cached, eps, stream
    "group_norm": ("ekaid_group_norm", [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _I,
                                        ctypes.c_float, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _hash_sources(h, name: str) -> None:
    for f in [SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())


def source_hash(name: str) -> str:
    """Hash of the library of `name`'s source, the headers beside it and
    the nvcc flags (no nvcc needed)."""
    h = hashlib.sha256()
    _hash_sources(h, name)
    return h.hexdigest()[:16]


def _key(name: str, compiler: str) -> str:
    """Hash of what the library of `name` is built from."""
    h = hashlib.sha256()
    _hash_sources(h, name)
    h.update(subprocess.run([compiler, "--version"], capture_output=True,
                            check=True).stdout)
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile one kernel source unless a library built from the same
    inputs exists; the compiler's resource report goes to
    build/ekaid_torch/<name>.log."""
    compiler = nvcc()
    src = SOURCES[name]
    lib = BUILD / f"lib{name}-{_key(name, compiler)}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    proc = subprocess.run([compiler, *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    (BUILD / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)                     # atomic for concurrent builds
    return lib


def _build_pool(names) -> Dict[str, Path]:
    """Build the kernels `names`, one nvcc per source, all started
    together."""
    with ThreadPoolExecutor(len(names)) as pool:
        futs = {name: pool.submit(build, name) for name in names}
        return {name: fut.result() for name, fut in futs.items()}


def build_all() -> float:
    """Build every kernel in one pool; returns the wall seconds."""
    t0 = time.perf_counter()
    _build_pool(list(SOURCES))
    return time.perf_counter() - t0


def _declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    lib.ekaid_error_string.argtypes = [ctypes.c_int]
    lib.ekaid_error_string.restype = ctypes.c_char_p
    fn, argtypes = ENTRY[name]
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built if needed (or the
    one `load_prebuilt` loaded), with its entry point's signature
    declared."""
    if name not in _libs:
        _libs[name] = _declare(ctypes.CDLL(str(build(name))), name)
    return _libs[name]


def load_all(names) -> None:
    """`load` each of the kernels `names`, building those not loaded yet
    in one pool, so that a process that launches several waits for
    nvcc once."""
    todo = [name for name in dict.fromkeys(names) if name not in _libs]
    if todo:
        for name, path in _build_pool(todo).items():
            _libs[name] = _declare(ctypes.CDLL(str(path)), name)


def load_prebuilt(name: str, path) -> ctypes.CDLL:
    """Load the built library of `name` at `path` as the one `load`
    returns from now on, without nvcc. Raises when the file does not
    load or lacks the entry point, or when another library of `name` is
    loaded already."""
    path = Path(path)
    if name in _libs:
        if Path(_libs[name]._name) != path:
            raise RuntimeError(f"kernel {name}: {_libs[name]._name} is "
                               f"loaded already; cannot load {path}")
        return _libs[name]
    try:
        _libs[name] = _declare(ctypes.CDLL(str(path)), name)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"kernel {name}: the prebuilt library {path} "
                           f"does not load: {e}") from e
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ekaid_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


if __name__ == "__main__":
    print(f"built {sorted(SOURCES)} in {build_all():.1f} s")
