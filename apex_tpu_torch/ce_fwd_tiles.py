"""Time the fused-CE forward's tile choices on one GPU.

    python -m apex_tpu_torch.ce_fwd_tiles [--iters 10] [--rounds 2]

Builds ``csrc/fused_ce.cu`` as it stands and once for each variant in
:data:`VARIANTS` -- the same source with the rows, vocab rows, chunk,
ring stages, warps or blocks an SM of its ``FwdTiles`` plan replaced
(through :func:`apex_tpu_torch.flash_bwd_tiles.variant_source`) --, each
rewrite in :data:`REWRITES` (the same statistics computed another way)
and each ablation in :data:`ABLATIONS` (the landed source with the next
chunk's copies, the products, the mma alone or the softmax epilogue taken
out; their outputs are wrong by construction), each by its own
``nvcc``, all started together, into its own library under
``build/apex_tpu_torch/variants/``.  Then it times ``apex_ce_fwd`` (the
bf16 copy of the fp32 embed included, as the wrapper runs it; each
library's scratch sized by its own ``apex_ce_fwd_plan``) at GPT-124M's
training shape (N = 8192, V = 50304, bf16 x, fp32 embed) at H = 768 for
every library and at H = 1024 for the landed one, and the dense bf16
head (``torch.matmul`` + ``F.cross_entropy``) in the same turns, with
CUDA events around ``--iters`` back-to-back calls, the libraries in turns
(a, b, ..., b, a, for ``--rounds`` rounds).  Prints one JSON line per
library and width (the median time of its turns, every turn, the largest
difference of its m, lse and tgt from the landed ones, ptxas' register
and spill lines for its forward kernel), then the card's ``nvidia-smi``
name and power limit.  Needs a CUDA device and ``nvcc``; the variants
are measurement only, nothing else loads them.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from apex_tpu_torch.ce_bwd_tiles import ablated_source, build_libs
from apex_tpu_torch.flash_bwd_tiles import event_ms, variant_source
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import fused_ce_kernels as K

#: FwdTiles constant -> the key of ``K.FWD_TILES`` it sets
CONSTANTS = {"kRows": "rows", "kCols": "cols", "kChunk": "chunk", "kStages": "stages",
             "kWarpsM": "warps_m", "kWarpsN": "warps_n", "kBlocksPerSm": "blocks_per_sm"}

#: name -> the FwdTiles constants it changes: ring depth and chunk width,
#: a warp's piece of s (64 x 64 landed; 64 x 32 and 32 x 64), a narrower
#: block tile two of which share an SM, and 64 x rows
_CHANGES = {
    "stages3": {"kStages": 3},
    "stages4": {"kStages": 4},
    "chunk32_stages3": {"kChunk": 32, "kStages": 3},
    "chunk32_stages6": {"kChunk": 32, "kStages": 6},
    "cols128_warps4_2bps": {"kCols": 128, "kWarpsN": 2, "kBlocksPerSm": 2},
    "warp64x32": {"kCols": 128},
    "warp32x64": {"kWarpsM": 4},
    "rows64_warps4_2bps": {"kRows": 64, "kWarpsM": 1, "kBlocksPerSm": 2},
}


def tiles_of(changes):
    """``K.FWD_TILES`` with ``changes`` ({constant: value}) applied."""
    return {**K.FWD_TILES, **{CONSTANTS[c]: v for c, v in changes.items()}}


def valid_fwd_tiles(t):
    """Whether the kernel's static_asserts take the tiles (whole 16 x 16
    pieces of s a warp, a stage split evenly over the threads, the lanes'
    merge inside the ring) and ``blocks_per_sm`` blocks fit an SM's
    shared memory (228 KB, 1 KB of it reserved a block)."""
    wm, wn = t["warps_m"], t["warps_n"]
    threads = 32 * wm * wn
    if t["rows"] % (16 * wm) or t["cols"] % (16 * wn) or t["chunk"] % 16 or t["stages"] < 2:
        return False
    if (t["rows"] + t["cols"]) * t["chunk"] // 8 % threads:
        return False
    ring = t["stages"] * (t["rows"] + t["cols"]) * (t["chunk"] + 8) * 2
    if 3 * t["rows"] * 4 * wn * 4 > ring:
        return False
    smem = K.fwd_smem_bytes(t["rows"], t["cols"], t["chunk"], t["stages"])
    return smem <= K.SMEM_LIMIT and t["blocks_per_sm"] * (smem + 1024) <= 228 * 1024


VARIANTS = {n: {("FwdTiles", c): str(v) for c, v in ch.items()} for n, ch in _CHANGES.items()}

#: name -> the (text, replacement) pairs that take one part of the
#: forward's walk out of the landed source (the softmax is skipped on a
#: test of s that real data never passes, so the products stay live)
_NO_SCORE = ("    for (int kk = 0; kk < BK; kk += 16) {\n",
             "    for (int kk = 0; kk < 0; kk += 16) {\n")
_NO_SOFTMAX = ("    if (kc == KC - 1) {  // the tile's s is whole",
               "    if (kc == KC - 1 && acc[0][0][0] == kMasked) {  // the tile's s is whole")
ABLATIONS = {
    "no_fetch": (("    issue(c + STAGES - 1);\n", ""),),
    "no_score": (_NO_SCORE,),
    "no_mma": (("          mma16816(acc[i][2 * p], a[i], b[0], b[1]);\n"
                "          mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);\n", ""),),
    "no_softmax": (_NO_SOFTMAX,),
    "no_score_no_softmax": (_NO_SCORE, _NO_SOFTMAX),
}


#: name -> the (text, replacement) pairs of a rewrite of the landed
#: source that computes the same statistics another way
REWRITES = {
    "precise_exp2": (("  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n",
                      "  y = exp2f(x);\n"),),
}


def sources():
    """{name: source} of the landed kernels, each variant, each rewrite
    and each ablation."""
    src = (_build.CSRC_DIR / "fused_ce.cu").read_text()
    return {"landed": src, **{n: variant_source(src, v) for n, v in VARIANTS.items()},
            **{n: ablated_source(src, a) for n, a in REWRITES.items()},
            **{n: ablated_source(src, a) for n, a in ABLATIONS.items()}}


def inputs(H, N=8192, V=50304, seed=0):
    """x (N, H) bf16, the fp32 embed (std 0.02) and t, on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to("cuda",
                                                                            torch.bfloat16)
    e = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32)).to("cuda")
    t = torch.from_numpy(rng.integers(0, V, size=N).astype(np.int32)).to("cuda")
    return x, e, t


def runner(lib, x, e, t):
    """A callable that launches the library's forward (the embed's bf16
    copy first, into scratch its own plan sizes) into fixed outputs."""
    (N, H), V = x.shape, e.shape[0]
    plan = (ctypes.c_int64 * 8)()
    _build.check(lib.apex_ce_fwd_plan(N, H, V, 1, 0, ctypes.addressof(plan)), "apex_ce_fwd_plan")
    scratch = torch.empty(plan[7], dtype=torch.uint8, device="cuda")
    out = [torch.empty(N, dtype=torch.float32, device="cuda") for _ in range(3)]
    st = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(lib.apex_ce_fwd(x.data_ptr(), e.data_ptr(), t.data_ptr(),
                                     scratch.data_ptr(), *(o.data_ptr() for o in out), N, H, V,
                                     1, 0, st), "apex_ce_fwd")

    return call, out, tuple(plan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_fwd_tiles: no CUDA device")
    libs = build_libs(sources(), "cefwd", ("apex_ce_fwd", "apex_ce_fwd_plan"), "ce_fwd_kernel")
    F = torch.nn.functional
    for H in (768, 1024):
        names = list(libs) if H == 768 else ["landed"]
        x, e, t = inputs(H)
        runs = {n: runner(libs[n][0], x, e, t) for n in names}
        tl = t.long()
        eb = e.to(torch.bfloat16)
        runs["dense_bf16_head"] = (
            lambda: F.cross_entropy(torch.matmul(x, eb.T).float(), tl), None, None)
        order = list(runs)
        times = {n: [] for n in order}
        for _ in range(args.rounds):
            for n in order + order[::-1]:
                times[n].append(event_ms(runs[n][0], args.iters))
        m0, l0, g0 = runs["landed"][1]
        for n in order:
            line = {"variant": n, "H": H, "ablation": n in ABLATIONS,
                    "ms": statistics.median(times[n]), "turns": times[n]}
            if n in libs:
                m, l, g = runs[n][1]
                line["plan"] = dict(zip(K.CeFwdPlan._fields, runs[n][2]))
                line["max_abs_diff_from_landed"] = {
                    "m": float((m - m0).abs().max()),
                    "lse": float(((m + torch.log(l)) - (m0 + torch.log(l0))).abs().max()),
                    "tgt": float((g - g0).abs().max())}
                line["ptxas"] = libs[n][1]
            print(json.dumps(line), flush=True)
        del runs, x, e, t, eb
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
