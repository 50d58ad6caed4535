"""Build and load the port's CUDA kernels (``apex_tpu_torch/csrc/*.cu``).

The sources have a plain C interface and include no PyTorch header.
On first use each source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c <src>.cu

and the objects are linked with ``nvcc -shared`` into
``build/apex_tpu_torch/libapex_kernels.so`` at the repository root (a
directory ``.gitignore`` lists).  A stamp beside the library holds the
SHA-256 of the sources and flags; a changed source rebuilds.  The
compiler's output, ptxas' register and spill report included, is kept
in ``build/apex_tpu_torch/build.log``.

The library is loaded with :mod:`ctypes` with explicit ``argtypes``:
``c_void_p`` for every pointer and the stream, so no pointer is cut to
32 bits.  Every C entry returns ``cudaGetLastError()`` after its
launches; :func:`check` raises on a nonzero code.  A failed build or
launch raises: nothing here falls back to another implementation.

``torch.utils.cpp_extension`` is not used: a source that includes
PyTorch's headers takes minutes to compile, this takes seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "apex_tpu_torch"
LIB_PATH = BUILD_DIR / "libapex_kernels.so"
STAMP_PATH = BUILD_DIR / "libapex_kernels.sha256"
LOG_PATH = BUILD_DIR / "build.log"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry -> (restype, argtypes)
SIGNATURES = {
    "apex_set_device": (_I, [_I]),
    "apex_error_string": (ctypes.c_char_p, [_I]),
    # x, w, b, y, mean, rstd, rows, hidden, eps, rms, dtype, stream
    "apex_layer_norm_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P]),
    # rows, hidden, dtype, aligned, out (int64 x 9)
    "apex_layer_norm_plan": (_I, [_I, _I, _I, _I, _P]),
    # x, w, dy, mean, rstd, dx, part_w, part_b, dw, db, rows, hidden,
    # rms, dtype, stream
    "apex_layer_norm_bwd": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # which, D, dtype, ring
    "apex_flash_smem": (_I, [_I, _I, _I, _I]),
    # q, k, v, bias, out, lse, BH, Sq, Sk, D, heads, kv_heads, scale,
    # causal, q_offset, k_offset, dtype, ring, stream (ring: the bf16
    # ring-chunk mode, fp32 out)
    "apex_flash_fwd": (
        _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P]),
    # q, k, v, do, lse, delta, bias, dq, BH, Sq, Sk, D, heads, kv_heads,
    # scale, causal, q_offset, k_offset, dtype, ring, stream (ring: fp32
    # do and dq)
    "apex_flash_dq": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
             _I, _I, _P]),
    # q, k, v, do, lse, delta, bias, dk, dv, BKV, Sq, Sk, D, heads,
    # kv_heads, scale, causal, q_offset, k_offset, dtype, ring, stream
    # (ring: fp32 do, dk and dv)
    "apex_flash_dkv": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
             _I, _I, _I, _P]),
    # width, group, D, q_dtype, kv_dtype, out (int32 x 3)
    "apex_paged_decode_attention_plan": (_I, [_I, _I, _I, _I, _I, _P]),
    # q, k_pool, v_pool, page_table, lengths, out, B, width, H, HKV, D,
    # num_pages, page_size, pages_per_seq, denom, q_dtype, kv_dtype, stream
    "apex_paged_decode_attention": (
        _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
    # N, H, V, sm_count, out (int64 x 9)
    "apex_sample_plan": (_I, [_I, _I, _I, _I, _P]),
    # x, embed, seeds, tokens, part_v, part_i, logits, tau, N, H, V,
    # nblocks, temperature, top_k, x_dtype, stream
    "apex_fused_sample": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # N, H, V, x_dtype, embed_dtype, out (int64 x 8)
    "apex_ce_fwd_plan": (_I, [_I, _I, _I, _I, _I, _P]),
    # x, embed, t, scratch, m, l, tgt, N, H, V, x_dtype, embed_dtype, stream
    "apex_ce_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # which, N, H, V, x_dtype, embed_dtype, out (int64 x 7)
    "apex_ce_bwd_plan": (_I, [_I, _I, _I, _I, _I, _I, _P]),
    # x, embed, t, lse, g, dx, scratch, N, H, V, x_dtype, embed_dtype, stream
    "apex_ce_dx": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # x, embed, t, lse, g, dembed, scratch, N, H, V, x_dtype, embed_dtype,
    # stream
    "apex_ce_dembed": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # kind, n (int64 x T), T, out (int64 x 6)
    "apex_mt_plan": (_I, [_I, _P, _I, _P]),
    # ptrs (8 x T), n, lr, wd, codes (4 x T), T, bc1, bc2, pred, coef, lr,
    # beta1, 1 - beta1, beta2, 1 - beta2, eps, adam_w_mode, stream, launches
    "apex_mt_adam": (
        _I, [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _I, _P, _P]),
    # src, out, n, codes (2 x T), T, mult_ptr, mult, flag, stream, launches
    "apex_mt_scale": (_I, [_P, _P, _P, _P, _I, _P, _F, _P, _P, _P]),
    # src, n, codes, T, partial, per-leaf, total, stream, launches
    "apex_mt_l2norm": (_I, [_P, _P, _P, _I, _P, _P, _P, _P, _P]),
    # ptrs (9 x T), n, lr, wd, codes (2 x T), T, bc1, bc2, pred, coef, lr,
    # beta1, 1 - beta1, beta2, 1 - beta2, eps, adam_w_mode, stream, launches
    "apex_mt_adam_remainder": (
        _I, [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _I, _P, _P]),
}

#: torch dtype -> the C entries' dtype code (as ``ops/multi_tensor.py``'s)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the dtypes of the kernels with no float16 instantiation: the fused CE,
#: paged decode attention and the sampling head (the LayerNorm and flash
#: kernels take all three)
FP32_BF16 = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_lib = None
#: the library's current device: it links the CUDA runtime statically,
#: so only this module's calls move it
_device_set = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """SHA-256 of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels cannot be built")


def build(force: bool = False) -> float:
    """Compile the sources into :data:`LIB_PATH` unless the stamp says
    it is current.  Returns the seconds spent (0.0 when up to date)."""
    digest = source_hash()
    if (not force and LIB_PATH.exists() and STAMP_PATH.exists()
            and STAMP_PATH.read_text().strip() == digest):
        return 0.0
    t0 = time.monotonic()
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = BUILD_DIR / f"libapex_kernels.{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, LIB_PATH)
            STAMP_PATH.write_text(digest + "\n")
    for obj in objs:
        if obj.exists():
            obj.unlink()
    LOG_PATH.write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"building the CUDA kernels failed ({', '.join(failed)}):\n"
            + "\n".join(log))
    return time.monotonic() - t0


def load():
    """The loaded kernel library (built first when needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = load().apex_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def prepare(device: torch.device):
    """Load the library, make ``device`` its current device, and return
    ``(lib, stream)`` with PyTorch's current stream on that device."""
    global _device_set
    lib = _lib if _lib is not None else load()
    if device.index != _device_set:
        check(lib.apex_set_device(device.index), "cudaSetDevice")
        _device_set = device.index
    return lib, torch.cuda.current_stream(device).cuda_stream
