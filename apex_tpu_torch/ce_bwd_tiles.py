"""Time the fused-CE backward's tile choices on one GPU.

    python -m apex_tpu_torch.ce_bwd_tiles [--iters 10] [--rounds 2]

Builds ``csrc/fused_ce.cu`` as it stands and once for each variant in
:data:`VARIANTS` -- the same source with the K groups, streamed rows or
warps of its ``BwdH768`` or ``BwdH1024`` tile plan replaced (through
:func:`apex_tpu_torch.flash_bwd_tiles.variant_source`) -- each by its
own ``nvcc``, all started together, into its own library under
``build/apex_tpu_torch/variants/``.  Then it times ``apex_ce_dx`` and
``apex_ce_dembed`` (the bf16 copy of the fp32 embed included, as the
wrapper runs them) of the landed library and of the variants of each
width, at GPT-124M's training shape (N = 8192, V = 50304, bf16 x, fp32
embed) at H = 768 and 1024, with CUDA events around ``--iters``
back-to-back calls, the libraries in turns (a, b, ..., b, a, for
``--rounds`` rounds), and holds each variant's outputs against the
landed kernels' (the split over H moves the last bits of s, so they
differ by roundings).  At H = 768 it also times the ablations in
:data:`ABLATIONS`: the landed source with the next tile's copies, the
score product, the accumulation or both taken out, which say where a
tile's time goes (their outputs are wrong by construction).  Prints one
JSON line per library and width (the
median time of its turns, every turn, the largest difference from the
landed outputs against the landed outputs' largest magnitude, ptxas'
register and spill lines for its backward kernels), then the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device and ``nvcc``;
the variants are measurement only, nothing else loads them.
"""

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from apex_tpu_torch.flash_bwd_tiles import event_ms, variant_source
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import fused_ce_kernels as K

#: width -> the struct of csrc/fused_ce.cu that holds its tile plan
STRUCTS = {768: "BwdH768", 1024: "BwdH1024"}
#: the K groups, streamed rows a tile and warps a block tried at each
#: width, each through the two-stage ring (64 streamed rows leave no room
#: for a second stage); other warp counts only at the landed streamed rows
GROUPS = (1, 2, 3, 4, 6)
STREAM_ROWS = (32, 16)
WARPS = (8, 12, 16)


def valid_plan(H, rows, sr, kg, warps):
    """Whether the kernel's static_asserts take the plan (the warps' pieces
    of s, MI x NJ fragment tiles each, tile the rows x sr block) and it
    fits a block's shared memory."""
    if warps % kg or rows * sr % (warps // kg):
        return False
    e = rows * sr // (warps // kg)  # elements of s a warp holds
    mi = 2 if e >= 512 and rows >= 32 else 1
    nj = e // (128 * mi)
    if e < 128 or e % (128 * mi) or (nj != 1 and nj % 2) or rows % (16 * mi) or sr % (8 * nj):
        return False
    if (rows // (16 * mi)) * (sr // (8 * nj)) != warps // kg:
        return False
    return max(K.bwd_smem_bytes(w, H, rows, sr, kg) for w in (1, 2)) <= K.SMEM_LIMIT


def _variants():
    """{name: {(struct, constant): value}}: every valid (K groups,
    streamed rows) pair of each width at its landed warps, and every
    valid K groups at the other warp counts, but the landed plan."""
    out = {}
    for H, struct in STRUCTS.items():
        rows, sr0, kg0, w0 = K.BWD_TILES[H]
        for w in WARPS:
            for kg in GROUPS:
                for sr in STREAM_ROWS if w == w0 else (sr0,):
                    if (w, kg, sr) == (w0, kg0, sr0) or not valid_plan(H, rows, sr, kg, w):
                        continue
                    out[f"h{H}_w{w}_g{kg}_sr{sr}"] = {
                        (struct, "kGroups"): str(kg), (struct, "kStream"): str(sr),
                        (struct, "kWarps"): str(w)}
    return out


VARIANTS = _variants()

#: name -> the (text, replacement) pairs that take one part of the
#: backward's tile loop out of the landed source
_NO_SCORE = ("    auto score_step = [&](int ks) {\n", "    auto score_step = [&](int ks) {\n      return;\n")
_NO_ACC = ("    accumulate<MT, NP, SR, W>(acc, sD, Y, ld, H, warp, lane);\n", "")
ABLATIONS = {
    "no_fetch": (("    if (it + 1 < n_tiles) issue(it + 1);\n", ""),),
    "no_score": (_NO_SCORE,),
    "no_accumulate": (_NO_ACC,),
    "no_score_no_accumulate": (_NO_SCORE, _NO_ACC),
}

VARIANT_DIR = _build.BUILD_DIR / "variants"


def _width(name):
    return int(name.split("_")[0][1:])


def ablated_source(text, pairs):
    """``text`` with each (old, new) of ``pairs`` replaced; each old
    text must occur exactly once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text


def sources():
    """{name: source} of the landed kernels, each variant and each ablation."""
    src = (_build.CSRC_DIR / "fused_ce.cu").read_text()
    return {"landed": src, **{n: variant_source(src, v) for n, v in VARIANTS.items()},
            **{n: ablated_source(src, a) for n, a in ABLATIONS.items()}}


def build_all():
    """{name: (CDLL, ptxas lines)} for every source of :func:`sources`."""
    return build_libs(sources(), "ce", ("apex_ce_dx", "apex_ce_dembed"), "ce_bwd_kernel")


def build_libs(texts, prefix, entries, kernel):
    """{name: (CDLL, ptxas lines of ``kernel``'s instantiations)}: each
    source of ``texts`` built by its own ``nvcc``, all started together,
    into ``VARIANT_DIR/<prefix>_<name>.so``, with ``entries`` bound."""
    nvcc = _build.find_nvcc()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        cu = VARIANT_DIR / f"{prefix}_{name}.cu"
        cu.write_text(text)
        lib = VARIANT_DIR / f"{prefix}_{name}.so"
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
        for entry in entries:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build.SIGNATURES[entry]
        libs[name] = (lib, ptxas_report(out, kernel))
    return libs


def _of_width(kernel, H):
    """Whether a backward kernel's name (demangled or not) is an
    instantiation for width H: its own rows (the first integer template
    argument) are the width's."""
    m = re.search(r"ce_bwd_kernel<[^,]+, [^,]+, (\d+),", kernel) or re.search(r"Li(\d+)E", kernel)
    return bool(m) and int(m.group(1)) == K.BWD_TILES[768 if H <= 768 else 1024][0]


def _demangle(names):
    filt = shutil.which("c++filt")
    if not filt or not names:
        return dict(zip(names, names))
    out = subprocess.run([filt, "-p"], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else dict(zip(names, names))


def ptxas_report(log, kernel="ce_bwd_kernel"):
    """{"<kernel><...>": [ptxas' register and spill lines], ...} for the
    instantiations of ``kernel``, from ``nvcc -Xptxas -v`` output."""
    report, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
        elif fn and ("registers" in ln or "spill" in ln):
            report.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    names = _demangle(list(report))
    short = {k: re.search(kernel + r"<[^()]*>", v) for k, v in names.items()}
    return {short[k].group(0) if short[k] else k: v for k, v in report.items()}


def inputs(H, N=8192, V=50304, seed=0):
    """x (N, H) bf16, the fp32 embed (std 0.02), t, lse (of the plain
    bf16-dot forward) and g = 1 / N, on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to("cuda",
                                                                            torch.bfloat16)
    e = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32)).to("cuda")
    t = torch.from_numpy(rng.integers(0, V, size=N).astype(np.int32)).to("cuda")
    m, l, _ = K.ce_fwd_plain(x, e, t, dot_dtype=torch.bfloat16)
    return x, e, t, m + torch.log(l), torch.full((N,), 1.0 / N, device="cuda")


def runner(lib, x, e, t, lse, g):
    """Callables that launch the library's dx and dembed (the embed's
    bf16 copy first, into a fixed scratch) into fixed outputs."""
    (N, H), V = x.shape, e.shape[0]
    dx = torch.empty_like(x)
    de = torch.empty(e.shape, dtype=torch.float32, device="cuda")
    scratch = torch.empty(e.shape, dtype=torch.bfloat16, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), e.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr())

    def dx_call():
        _build.check(lib.apex_ce_dx(*ptrs, dx.data_ptr(), scratch.data_ptr(), N, H, V, 1, 0, st),
                     "apex_ce_dx")

    def dembed_call():
        _build.check(lib.apex_ce_dembed(*ptrs, de.data_ptr(), None, N, H, V, 1, 0, st),
                     "apex_ce_dembed")

    return dx_call, dembed_call, (dx, de)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_bwd_tiles: no CUDA device")
    libs = build_all()
    for H in STRUCTS:
        names = ["landed", *(n for n in VARIANTS if _width(n) == H),
                 *(ABLATIONS if H == 768 else ())]
        data = inputs(H)
        runs = {n: runner(libs[n][0], *data) for n in names}
        times = {n: {"dx": [], "dembed": []} for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                times[n]["dx"].append(event_ms(runs[n][0], args.iters))
                times[n]["dembed"].append(event_ms(runs[n][1], args.iters))
        ref = runs["landed"][2]
        rows, sr, kg, warps = K.BWD_TILES[H]
        for n in names:
            diff = {k: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for k, a, b in zip(("dx", "dembed"), runs[n][2], ref)}
            plan = VARIANTS.get(n, {(STRUCTS[H], "kGroups"): str(kg),
                                    (STRUCTS[H], "kStream"): str(sr),
                                    (STRUCTS[H], "kWarps"): str(warps)})
            print(json.dumps({
                "variant": n, "H": H, "own_rows": rows, "ablation": n in ABLATIONS,
                "plan": {f"{s}::{c}": v for (s, c), v in plan.items()},
                "dx_ms": statistics.median(times[n]["dx"]),
                "dembed_ms": statistics.median(times[n]["dembed"]),
                "turns": times[n], "max_abs_diff_from_landed_over_max_abs": diff,
                "ptxas": {f: r for f, r in libs[n][1].items() if _of_width(f, H)}}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
