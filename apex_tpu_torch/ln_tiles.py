"""Time the LayerNorm kernels' tile choices on one GPU.

    python -m apex_tpu_torch.ln_tiles [--iters 50] [--rounds 3]

Builds ``csrc/layer_norm.cu`` as it stands and once for each variant in
:data:`VARIANTS` -- the same source with a constant of its
``LnFwdTiles`` or ``LnBwdTiles`` plan replaced (through
:func:`apex_tpu_torch.flash_bwd_tiles.variant_source`): warps a block,
rows a backward block walks for each warp, the next row's prefetch, the
register cap -- and once for each
ablation in :data:`ABLATIONS` (the backward without its dw/db partials,
or without stage 2), each by its own ``nvcc``, all started together,
into its own library under ``build/apex_tpu_torch/variants/``.  Then it
times ``apex_layer_norm_fwd`` and ``apex_layer_norm_bwd`` (affine with
bias, the partials sized by each library's own ``apex_layer_norm_plan``)
of every library at R = 8192 rows for H = 768, 1024 and 4096 in bf16
(:data:`SHAPES`), with CUDA events around
``--iters`` back-to-back calls, the libraries in turns (a, b, ..., b,
a, for ``--rounds`` rounds), beside ``F.layer_norm`` and its autograd
backward in the same turns; and holds each library's outputs against
the landed kernels' (y and dx bitwise where the row's sums keep their
order; dw and db move by roundings where G changes).  Prints one JSON
line per library and shape (the median time of its turns, every turn,
the largest differences from the landed outputs, ptxas' register and
spill lines for its LayerNorm kernels: every instantiation for the
landed library, those of the timed widths for the others), then the
card's ``nvidia-smi`` name and power limit.  Needs a CUDA device and
``nvcc``; the variants are measurement only, nothing else loads them.
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

from apex_tpu_torch.ce_bwd_tiles import _demangle, ablated_source
from apex_tpu_torch.flash_bwd_tiles import event_ms, variant_source
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops import layer_norm as L


def _variants():
    """{name: {(struct, constant): value}}: the forward at 4 and 16 warps
    a block; the backward at every (warps a block, rows a warp) of
    {2, 4, 8, 16} x {2, 4, 8, 16} but the landed one, without the next
    row's prefetch, and with 2, 3 or 4 blocks an SM asked of ptxas (a
    register cap)."""
    out = {f"fwd_w{w}": {("LnFwdTiles", "kWarps"): str(w)} for w in (4, 8, 16)
           if w != L.FWD_WARPS}
    for w in (2, 4, 8, 16):
        for rw in (2, 4, 8, 16):
            if (w, rw) != (L.BWD_WARPS, L.BWD_ROWS_WARP):
                out[f"bwd_w{w}_r{rw}"] = {("LnBwdTiles", "kWarps"): str(w),
                                          ("LnBwdTiles", "kRowsWarp"): str(rw)}
    out["bwd_no_prefetch"] = {("LnBwdTiles", "kPrefetch"): "false"}
    for mb in (2, 3, 4):
        out[f"bwd_min_blocks{mb}"] = {("LnBwdTiles", "kMinBlocks"): str(mb)}
    return out


VARIANTS = _variants()

#: name -> the (text, replacement) pairs that take one part of the
#: backward out of the landed source (its dw and db are wrong by
#: construction): stage 1 without the dw/db partials (no accumulation,
#: no partial rows written; stage 2 still runs), and stage 1 alone
ABLATIONS = {
    "bwd_no_partials": (
        ("          pw[k][e] += g[e] * xhat;\n          pb[k][e] += g[e];\n", ""),
        ("  if (!part_w) return;  // no affine: no partials (uniform over the block)\n",
         "  return;\n")),
    "bwd_stage1_only": (
        ("    ln_bwd_reduce_vec<<<(hidden + 15) / 16, 4 * kReduceLanes, 0, st>>>(\n"
         "        (const float*)part_w, (const float*)part_b, (float*)dw, (float*)db, "
         "p.bwd_blocks,\n        hidden);\n", ""),),
}

#: (R, H) shapes timed, bf16, affine with bias: the train step's rows at
#: GPT-124M's and GPT-345M's widths and bench.py's fused_ln
SHAPES = ((8192, 768), (8192, 1024), (8192, 4096))

VARIANT_DIR = _build.BUILD_DIR / "variants"
_ENTRIES = ("apex_layer_norm_fwd", "apex_layer_norm_bwd", "apex_layer_norm_plan")


def sources():
    """{name: source} of the landed kernels, each variant and each ablation."""
    src = (_build.CSRC_DIR / "layer_norm.cu").read_text()
    return {"landed": src, **{n: variant_source(src, v) for n, v in VARIANTS.items()},
            **{n: ablated_source(src, a) for n, a in ABLATIONS.items()}}


def build_all():
    """{name: (CDLL, ptxas lines)} for every source of :func:`sources`."""
    nvcc = _build.find_nvcc()
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources().items():
        cu = VARIANT_DIR / f"ln_{name}.cu"
        cu.write_text(text)
        lib = VARIANT_DIR / f"ln_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{out}")
        lib = ctypes.CDLL(str(path))
        for entry in _ENTRIES:
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = _build.SIGNATURES[entry]
        libs[name] = (lib, ptxas_report(out))
    return libs


def ptxas_report(log):
    """{"ln_bwd_warp<__nv_bfloat16, 1, 3, 768>": [ptxas' register and
    spill lines], ...} for every LayerNorm kernel, from ``nvcc -Xptxas
    -v`` output."""
    report, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            fn = m.group(1) if "ln_" in m.group(1) else None
        elif fn and ("registers" in ln or "spill" in ln):
            report.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    names = _demangle(list(report))
    short = {k: re.search(r"ln_\w+(<[^()]*>)?", v) for k, v in names.items()}
    return {short[k].group(0) if short[k] else k: v for k, v in report.items()}


def _of_widths(kernel):
    """Whether a kernel is one the timed shapes run: the bf16
    instantiation each width of :data:`SHAPES` takes (at its
    compile-time width or the runtime one), or stage 2."""
    for R, H in SHAPES:
        plan = L.ln_plan(R, H, torch.bfloat16, True)
        if re.search(r"ln_\w+_warp<__nv_bfloat16, %d, %d, (0|%d)>" % (
                plan.warps_row, plan.vectors_lane, H), kernel):
            return True
    return "reduce_vec" in kernel


def inputs(R, H, seed=0):
    """x and dy (R, H) bf16, the fp32 weight and bias, and the plain
    forward's mean and rstd, on the card."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale + shift)

    x = randn(R, H, scale=2.0, shift=0.5).to("cuda", torch.bfloat16)
    dy = randn(R, H).to("cuda", torch.bfloat16)
    w = randn(H, scale=0.1, shift=1.0).to("cuda")
    b = randn(H, scale=0.1).to("cuda")
    _, mean, rstd = L.layer_norm_fwd_plain(x, w, b, 1e-5)
    return x, dy, w, b, mean, rstd


def runner(lib, x, dy, w, b, mean, rstd):
    """Callables that launch the library's forward and backward into
    fixed outputs, the partials sized by the library's own plan."""
    R, H = x.shape
    y, dx = torch.empty_like(x), torch.empty_like(x)
    m, rs = torch.empty_like(mean), torch.empty_like(rstd)
    plan = (ctypes.c_int64 * len(L.LnPlan._fields))()
    _build.check(lib.apex_layer_norm_plan(R, H, 1, 1, ctypes.addressof(plan)), "plan")
    G = plan[L.LnPlan._fields.index("bwd_blocks")]
    pw = torch.empty((G, H), dtype=torch.float32, device="cuda")
    pb = torch.empty_like(pw)
    dw = torch.empty(H, dtype=torch.float32, device="cuda")
    db = torch.empty_like(dw)
    st = torch.cuda.current_stream().cuda_stream

    def fwd():
        _build.check(lib.apex_layer_norm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                             y.data_ptr(), m.data_ptr(), rs.data_ptr(), R, H,
                                             1e-5, 0, 1, st), "apex_layer_norm_fwd")

    def bwd():
        _build.check(lib.apex_layer_norm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), pw.data_ptr(), pb.data_ptr(), dw.data_ptr(), db.data_ptr(), R, H, 0,
            1, st), "apex_layer_norm_bwd")

    return fwd, bwd, {"y": y, "dx": dx, "dw": dw, "db": db}, G


def library(x, dy, w, b):
    """``F.layer_norm`` on the same inputs (params in x's dtype) and its
    autograd backward: the PyTorch calls computing the same functions."""
    F = torch.nn.functional
    H = x.shape[1]
    wl, bl = w.to(x.dtype).requires_grad_(), b.to(x.dtype).requires_grad_()
    xl = x.detach().requires_grad_()
    yl = F.layer_norm(xl, (H,), wl, bl, 1e-5)

    def fwd():
        F.layer_norm(x, (H,), wl, bl, 1e-5)

    def bwd():
        torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True)

    return fwd, bwd


def _diff(a, b):
    a, b = a.float(), b.float()
    return {"bitwise_equal": bool(torch.equal(a, b)),
            "max_abs_diff_over_max_abs": float((a - b).abs().max() / b.abs().max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ln_tiles: no CUDA device")
    libs = build_all()
    names = list(libs)
    for R, H in SHAPES:
        data = inputs(R, H)
        runs = {n: runner(libs[n][0], *data) for n in names}
        runs["library"] = (*library(*data[:4]), None, None)
        order = names + ["library"]
        times = {n: {"fwd": [], "bwd": []} for n in order}
        for _ in range(args.rounds):
            for n in order + order[::-1]:
                times[n]["fwd"].append(event_ms(runs[n][0], args.iters))
                times[n]["bwd"].append(event_ms(runs[n][1], args.iters))
        torch.cuda.synchronize()
        ref = runs["landed"][2]
        for n in order:
            line = {"variant": n, "R": R, "H": H, "dtype": "bfloat16",
                    "ablation": n in ABLATIONS,
                    "changes": {f"{s}::{c}": v for (s, c), v in VARIANTS.get(n, {}).items()},
                    "fwd_ms": statistics.median(times[n]["fwd"]),
                    "bwd_ms": statistics.median(times[n]["bwd"]), "turns": times[n]}
            if n != "library":
                outs = runs[n][2]
                line["G"] = runs[n][3]
                line["diff_from_landed"] = {k: _diff(outs[k], ref[k]) for k in outs}
                line["ptxas"] = {f: r for f, r in libs[n][1].items()
                                 if n == "landed" or _of_widths(f)}
            print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
