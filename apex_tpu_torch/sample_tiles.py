"""Time the sampling head's tile choices on one GPU.

    python -m apex_tpu_torch.sample_tiles [--iters 20] [--rounds 2]

Builds ``csrc/decode_sampling.cu`` as it stands and once for each variant
in :data:`VARIANTS` -- the same source with the vocab rows a tile,
chunk, ring stages or blocks an SM of its ``SampleTiles`` plan replaced
(through :func:`apex_tpu_torch.flash_bwd_tiles.variant_source`), and
again without its products (``<variant>_stream``) --, each rewrite in
:data:`REWRITES` (the same tokens computed another way) and each
ablation in :data:`ABLATIONS` (the landed source with the next chunk's
copies, the products or the Gumbel noise taken out; their tokens are
wrong by construction), each by its own ``nvcc``, all started
together, into its own library under ``build/apex_tpu_torch/variants/``.
Then it times ``apex_fused_sample`` of every library (blocks from its own
``apex_sample_plan`` for the card's SMs) on the GPT-124M head (H = 768,
V = 50304, fp32 embed, bf16 rows) at the rows of :data:`CASES`, beside
the plain version and, at T = 0, the greedy head as two PyTorch calls
(``torch.argmax(torch.matmul(x.float(), embed.T))``), with CUDA events
around ``--iters`` back-to-back calls, in turns (a, b, ..., b, a, for
``--rounds`` rounds).  Prints one JSON line per library and case (the
median time of its turns, every turn, whether its tokens equal the
landed library's, ptxas' register and spill lines for its score
kernels), then the card's ``nvidia-smi`` name and power limit.  Needs a
CUDA device and ``nvcc``; the variants are measurement only, nothing
else loads them.
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
from apex_tpu_torch.ops import decode_sampling as S

#: SampleTiles constant -> the key of ``S.SAMPLE_TILES`` it sets
CONSTANTS = {"kVocabTile": "vocab_tile", "kChunk": "chunk", "kStages": "stages",
             "kBlocksPerSm": "blocks_per_sm", "kRowCap": "row_cap"}

#: name -> the SampleTiles constants it changes: vocab rows a tile (so
#: warps a block), chunk width (the bytes of each embed row a stage
#: brings), ring depth and blocks an SM
_CHANGES = {
    "tile64": {"kVocabTile": 64},
    "chunk16": {"kChunk": 16},
    "chunk64": {"kChunk": 64},
    "stages3": {"kStages": 3},
    "blocks_per_sm2": {"kBlocksPerSm": 2},
}

#: (rows, temperature, top_k) timed: the decode step, the verify step at
#: T = 1 and T = 0, the chunked prefill's one row, a full pass, top-k
CASES = ((8, 1.0, 0), (40, 1.0, 0), (40, 0.0, 0), (1, 1.0, 0), (64, 1.0, 0), (8, 1.0, 50))


def tiles_of(changes):
    """``S.SAMPLE_TILES`` with ``changes`` ({constant: value}) applied."""
    return {**S.SAMPLE_TILES, **{CONSTANTS[c]: v for c, v in changes.items()}}


def valid_sample_tiles(t, smem_limit=232448):
    """Whether the kernel takes the tiles (whole 16-row warp slices a
    tile, at most 8 warps, whole m16n8k8 steps a chunk, two ring stages or
    more) and a block of a full pass (64 x rows) fits a block's shared
    memory."""
    return (t["vocab_tile"] % 16 == 0 and t["vocab_tile"] <= 128 and t["chunk"] % 8 == 0
            and t["stages"] >= 2 and S.sample_smem_bytes(t["row_cap"], t) <= smem_limit)


VARIANTS = {n: {("SampleTiles", c): str(v) for c, v in ch.items()}
            for n, ch in _CHANGES.items()}

#: name -> the (text, replacement) pairs that take one part of the score
#: kernel's walk out of the landed source
ABLATIONS = {
    "no_fetch": (("    issue(c + T::kStages - 1);\n", ""),),
    "no_products": (("  asm volatile(\n      \"mma.sync.aligned.m16n8k8",
                     "  if (false) asm volatile(\n      \"mma.sync.aligned.m16n8k8"),),
    "no_noise": (("noisy(s, temperature, sd, (uint32_t)v)", "s / temperature"),),
}

#: name -> the (text, replacement) pairs of a rewrite of the landed
#: source that computes the same tokens another way
REWRITES = {
    "noise_out_of_line": (("__device__ __forceinline__ float noisy(",
                           "__device__ __noinline__ float noisy("),),
    "three_blocks_at_every_n_tiles": (
        ("__launch_bounds__(32 * SampleTiles::kVocabTile / 16, NT <= 5 ? 3 : 2)",
         "__launch_bounds__(32 * SampleTiles::kVocabTile / 16, 3)"),),
}


def sources():
    """{name: source} of the landed kernel, each variant, each rewrite,
    each ablation, and each variant without its products
    (``<variant>_stream``: the stream of the embed alone at that chunk
    shape)."""
    src = (_build.CSRC_DIR / "decode_sampling.cu").read_text()
    variants = {n: variant_source(src, v) for n, v in VARIANTS.items()}
    return {"landed": src, **variants,
            **{n: ablated_source(src, a) for n, a in REWRITES.items()},
            **{n: ablated_source(src, a) for n, a in ABLATIONS.items()},
            **{f"{n}_stream": ablated_source(v, ABLATIONS["no_products"])
               for n, v in variants.items()}}


def runner(lib, x, embed, seeds, temperature, top_k):
    """A callable that launches the library's head into fixed outputs,
    with the blocks of its own plan."""
    (N, H), V = x.shape, embed.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (ctypes.c_int64 * len(S.SamplePlan._fields))()
    _build.check(lib.apex_sample_plan(N, H, V, sms, ctypes.addressof(plan)), "apex_sample_plan")
    nblocks = plan[S.SamplePlan._fields.index("blocks")]
    tokens = torch.empty(N, dtype=torch.int32, device="cuda")
    part_v = torch.empty((nblocks, N), dtype=torch.float32, device="cuda")
    part_i = torch.empty((nblocks, N), dtype=torch.int32, device="cuda")
    logits = torch.empty((N, V), dtype=torch.float32, device="cuda") if top_k else None
    tau = torch.empty(N, dtype=torch.float32, device="cuda") if top_k else None
    st = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(lib.apex_fused_sample(
            x.data_ptr(), embed.data_ptr(), seeds.data_ptr(), tokens.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), None if logits is None else logits.data_ptr(),
            None if tau is None else tau.data_ptr(), N, H, V, nblocks, temperature, top_k,
            _build.DTYPE_CODES[x.dtype], st), "apex_fused_sample")

    return call, tokens, tuple(plan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sample_tiles: no CUDA device")
    libs = build_libs(sources(), "sample", ("apex_fused_sample", "apex_sample_plan"),
                      "score_kernel")
    H, V = 768, 50304
    rng = np.random.default_rng(0)
    embed = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32)).to("cuda")
    for N, temperature, top_k in CASES:
        x = torch.from_numpy(rng.standard_normal((N, H), dtype=np.float32)).to("cuda",
                                                                                torch.bfloat16)
        seeds = torch.from_numpy(rng.integers(0, 2 ** 32, size=N, dtype=np.uint64)
                                 .astype(np.int64)).to("cuda")
        runs = {n: runner(libs[n][0], x, embed, seeds, temperature, top_k) for n in libs}
        runs["plain"] = (lambda: S.fused_sample_plain(x, embed, seeds, temperature, top_k),
                         None, None)
        if temperature == 0:
            runs["library_argmax_matmul"] = (
                lambda: torch.argmax(torch.matmul(x.float(), embed.T), dim=-1), None, None)
        order = list(runs)
        times = {n: [] for n in order}
        for _ in range(args.rounds):
            for n in order + order[::-1]:
                times[n].append(event_ms(runs[n][0], args.iters))
        landed = runs["landed"][1]
        for n in order:
            line = {"variant": n, "N": N, "H": H, "temperature": temperature, "top_k": top_k,
                    "ablation": n in ABLATIONS, "ms": statistics.median(times[n]),
                    "turns": times[n]}
            if n in libs:
                line["plan"] = dict(zip(S.SamplePlan._fields, runs[n][2]))
                line["tokens_equal_landed"] = bool(torch.equal(runs[n][1], landed))
                line["ptxas"] = libs[n][1]
            print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
