"""ctypes loader for the port's host library (counterpart of
:mod:`apex_tpu.io.native`).

Builds ``apex_tpu_torch/csrc/host/apex_tpu_native.cpp`` with g++ at
first use into ``build/apex_tpu_torch/`` at the repository root (a hash
stamp rebuilds it when the source changes) and exposes
:func:`flatten`, :func:`unflatten` and :func:`gather_rows`, plus the
atomic publish helper :func:`atomic_output`.  It is a host library, apart
from the CUDA kernel library: g++ alone builds it, so it runs on the CPU
too.  The JAX package falls back to NumPy loops when g++ is missing;
the port does not: a library that fails to build raises.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["atomic_output", "flatten", "gather_rows", "get_lib", "unflatten"]


@contextlib.contextmanager
def atomic_output(path):
    """THE atomic write/rename helper for checkpoint bytes: yields a
    binary file open on ``<path>.tmp``; on clean exit the data is
    fsync'd, renamed onto ``path``, and the directory entry fsync'd —
    a crash or power loss mid-write can never leave a truncated file
    under the final name, and the published bytes are durable.  On any
    exception the temp file is unlinked and nothing is published."""
    tmp = str(path) + ".tmp"
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())  # data durable before the rename publishes it
        f.close()
        os.replace(tmp, str(path))
        dfd = os.open(os.path.dirname(str(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)  # the rename itself durable
        finally:
            os.close(dfd)
    except BaseException:
        try:
            f.close()
        except OSError:
            pass
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
        raise


SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "apex_tpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
LIB_PATH = BUILD_DIR / "libapex_tpu_native.so"
STAMP_PATH = BUILD_DIR / "libapex_tpu_native.sha256"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None

DEFAULT_THREADS = min(8, os.cpu_count() or 1)


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()


def _build(digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libapex_tpu_native.{os.getpid()}.so"
    res = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building the host library {SRC.name} with g++ failed "
                           f"(rc={res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)
    STAMP_PATH.write_text(digest + "\n")


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            digest = _digest()
            if not (LIB_PATH.exists() and STAMP_PATH.exists()
                    and STAMP_PATH.read_text().strip() == digest):
                _build(digest)
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.apex_tpu_native_abi_version.restype = ctypes.c_int
            if lib.apex_tpu_native_abi_version() != 1:
                raise RuntimeError(f"{LIB_PATH}: unexpected ABI version")
            _lib = lib
        return _lib


def flatten(arrays: List[np.ndarray], threads: int = DEFAULT_THREADS) -> np.ndarray:
    """Concatenate arbitrary-dtype arrays into one byte buffer
    (apex_C.flatten, csrc/flatten_unflatten.cpp:16)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    sizes = np.array([a.nbytes for a in arrays], np.int64)
    out = np.empty(int(sizes.sum()), np.uint8)
    srcs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    get_lib().apex_tpu_flatten(
        srcs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(arrays)), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(threads))
    return out


def unflatten(buf: np.ndarray, shapes, dtypes, threads: int = DEFAULT_THREADS) -> List[np.ndarray]:
    """Split a flat byte buffer back into arrays (apex_C.unflatten)."""
    outs = [np.empty(s, d) for s, d in zip(shapes, dtypes)]
    sizes = np.array([o.nbytes for o in outs], np.int64)
    if int(sizes.sum()) > np.asarray(buf).nbytes:
        raise ValueError(f"unflatten: the buffer holds {np.asarray(buf).nbytes} bytes, "
                         f"the arrays need {int(sizes.sum())}")
    buf = np.ascontiguousarray(buf)
    dsts = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    get_lib().apex_tpu_unflatten(
        buf.ctypes.data_as(ctypes.c_void_p), dsts,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(outs)), ctypes.c_int(threads))
    return outs


def gather_rows(src: np.ndarray, indices: np.ndarray, threads: int = DEFAULT_THREADS) -> np.ndarray:
    """dst[i] = src[indices[i]] — batch assembly for input pipelines."""
    src = np.ascontiguousarray(src)
    indices = np.ascontiguousarray(np.asarray(indices).astype(np.int64))
    n = len(indices)
    if n and (indices.min() < 0 or indices.max() >= src.shape[0]):
        raise IndexError(f"gather_rows: an index is outside [0, {src.shape[0]})")
    out = np.empty((n,) + src.shape[1:], src.dtype)
    row_bytes = src[0].nbytes if src.shape[0] else 0
    get_lib().apex_tpu_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(threads))
    return out
