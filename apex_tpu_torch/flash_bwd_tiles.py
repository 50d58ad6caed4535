"""Time the bf16 flash backward's tile choices on one GPU.

    python -m apex_tpu_torch.flash_bwd_tiles [--iters 20] [--rounds 2]

Builds ``csrc/flash_attention.cu`` as it stands and once for each
variant in :data:`VARIANTS` -- the same source with constants of its
``Dq`` or ``Dkv`` tile plan replaced -- each by its own ``nvcc``, all
started together, into its own library under
``build/apex_tpu_torch/variants/``.  Then it times ``apex_flash_dq`` and
``apex_flash_dkv`` of every library at GPT-124M's training shape (B = 8,
H = 12, S = 1024, causal, bf16) at D = 64 and 128 with CUDA events
around ``--iters`` back-to-back calls, the libraries in turns (a, b,
..., b, a, for ``--rounds`` rounds), and holds each variant's outputs
against the landed kernels'.  Prints one JSON line per library and head
dim (the median time of its turns, every turn, the largest difference
from the landed outputs, ptxas' register and spill lines for its
backward kernels), then the card's ``nvidia-smi`` name and power limit.
Needs a CUDA device and ``nvcc``; the variants are measurement only,
nothing else loads them.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import flash_attention as fa

#: variant -> {(struct, constant): the C++ expression that replaces its value}
VARIANTS = {
    # dkv: 128 key rows a block (8 warps), one block an SM
    "dkv_128_rows": {("Dkv", "kWarps"): "8", ("Dkv", "kMinBlocks"): "1"},
    # dkv: k and v fragments read from shared memory at every D
    "dkv_kv_in_smem": {("Dkv", "kRegs"): "false"},
    # dq: 16 rows a warp (8 warps) at D = 48, 64 too, q and do in registers
    "dq_16_rows_a_warp": {("Dq", "kMi"): "D <= 32 ? 2 : 1", ("Dq", "kWarps"): "D <= 32 ? 4 : 8",
                          ("Dq", "kRegs"): "true", ("Dq", "kMinBlocks"): "D <= 32 ? 2 : 1"},
}

VARIANT_DIR = _build.BUILD_DIR / "variants"


def variant_source(text, changes):
    """``text`` with each (struct, constant) of ``changes`` given its new
    value inside ``struct <name> { ... };``."""
    for (struct, name), value in changes.items():
        body = re.search(r"struct %s \{.*?\n\};" % struct, text, re.S)
        if body is None:
            raise ValueError(f"struct {struct} not found")
        new, n = re.subn(r"(static constexpr \w+ %s = )[^;]*;" % name,
                         lambda m: m.group(1) + value + ";", body.group(0))
        if n != 1:
            raise ValueError(f"{struct}::{name} found {n} times")
        text = text[:body.start()] + new + text[body.end():]
    return text


def build_all():
    """{name: (CDLL, ptxas lines)} for the landed source and each variant."""
    nvcc = _build.find_nvcc()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    jobs = {}
    for name in ("landed", *VARIANTS):
        cu = VARIANT_DIR / f"{name}.cu"
        cu.write_text(src if name == "landed" else variant_source(src, VARIANTS[name]))
        lib = VARIANT_DIR / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib),
               str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{out}")
        lib = ctypes.CDLL(str(path))
        for entry in ("apex_flash_dq", "apex_flash_dkv"):
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build.SIGNATURES[entry]
        libs[name] = (lib, ptxas_report(out))
    return libs


def ptxas_report(log):
    """{"flash_dq_mma<64>": [ptxas' register and spill lines], ...} for
    the backward kernels, from ``nvcc -Xptxas -v`` output."""
    report, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            k = re.search(r"(flash_dk?v?q?_mma)ILi(\d+)E", m.group(1))
            fn = f"{k.group(1)}<{k.group(2)}>" if k else None
        elif fn and ("registers" in ln or "spill" in ln):
            report.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return report


def inputs(D, B=8, H=12, S=1024, seed=0):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda",
                                                                                torch.bfloat16)

    q, k, v, do = (randn(B * H, S, D) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, 1.0 / np.sqrt(D), True, heads=H, kv_heads=H)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, do, lse, delta, H


def runner(lib, q, k, v, do, lse, delta, H):
    """A callable that launches the library's dq then dkv into fixed outputs."""
    BH, S, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    st = torch.cuda.current_stream().cuda_stream
    common = (BH, S, S, D, H, H, float(1.0 / np.sqrt(D)), 1, 0, 0, 1, 0, st)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None)

    def dq_call():
        _build.check(lib.apex_flash_dq(*ptrs, dq.data_ptr(), *common), "apex_flash_dq")

    def dkv_call():
        _build.check(lib.apex_flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *common),
                     "apex_flash_dkv")

    return dq_call, dkv_call, (dq, dk, dv)


def event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_tiles: no CUDA device")
    libs = build_all()
    names = list(libs)
    for D in (64, 128):
        data = inputs(D)
        runs = {n: runner(libs[n][0], *data) for n in names}
        times = {n: {"dq": [], "dkv": []} for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                times[n]["dq"].append(event_ms(runs[n][0], args.iters))
                times[n]["dkv"].append(event_ms(runs[n][1], args.iters))
        ref = runs["landed"][2]
        for n in names:
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(runs[n][2], ref))
            print(json.dumps({
                "variant": n, "D": D, "changes": {f"{s}::{c}": v for (s, c), v in
                                                 VARIANTS.get(n, {}).items()},
                "dq_ms": statistics.median(times[n]["dq"]),
                "dkv_ms": statistics.median(times[n]["dkv"]),
                "turns": times[n], "max_abs_diff_from_landed": diff,
                "ptxas": {f: r for f, r in libs[n][1].items() if f"<{D}>" in f}}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
