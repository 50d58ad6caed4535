"""Fused sampling head: hidden state -> sampled token, the CUDA kernel and
its plain PyTorch version.

Counterpart of :mod:`apex_tpu.ops.decode_sampling_pallas`.  The LM head,
temperature, optional top-k restriction and the categorical draw are
one kernel (``csrc/decode_sampling.cu``): the head streams the fp32
embedding once for every row of a call (up to 64 rows a pass) and never
writes the (N, V) logits unless top-k needs them.  :func:`sample_plan`
states its launch plan, a pure function of the shapes and the card's SM
count that the CPU tests check; ``chip_smoke.py`` holds it against
``apex_sample_plan``, what the C side launches with.  Sampling is the Gumbel-max trick, ``argmax_v(logits_v / T +
g_v)``, with ``g_v`` from a counter hash of (row seed, vocab column) —
the same uint32 arithmetic as ``_hash_u32``/``gumbel_from_seed`` in the
JAX package, so both packages and both versions here draw the same
token from the same seed.  ``temperature == 0`` is greedy argmax;
``top_k > 0`` keeps the columns whose logit is at least the k-th
largest (ties at the k-th value kept).  On equal values the lower
index wins, as ``argmax``'s first hit.

The plain version does the uint32 hash in int64, masking to 32 bits
after each multiply: PyTorch on the CPU has no full uint32 arithmetic,
and a wrapped int64 product still holds the right low 32 bits.

Seeds are int64 tensors holding uint32 values.  Tokens come back as
int32, as in the JAX package.
"""

from typing import NamedTuple

import torch

from apex_tpu_torch.ops import _build

#: launches of the sampling head by :func:`fused_sample` (one per call:
#: the head is a score kernel and a reduce kernel, plus a logits store
#: and a k-th-value pass under top-k)
LAUNCHES = 0

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
#: the widest hidden state taken: the kernel brings x and the embed in
#: chunks of H, so shared memory does not bound it; this keeps a pass's
#: x offsets (64 rows x H) and the plan's checks in range
MAX_HIDDEN = 65536

#: the score kernel's tiles (csrc SampleTiles): vocab rows a tile,
#: columns of H a ring stage, ring stages, blocks an SM, x rows a pass
SAMPLE_TILES = {"vocab_tile": 128, "chunk": 32, "stages": 2, "blocks_per_sm": 3, "row_cap": 64}


class SamplePlan(NamedTuple):
    passes: int         # launches of the score kernel, each of up to row_cap x rows
    row_cap: int        # x rows a pass
    n_tiles: int        # n-tiles of 8 x rows of the first pass
    warps: int          # warps a block, 16 vocab rows each
    vocab_tile: int     # vocab rows a tile
    chunk: int          # columns of H a ring stage holds
    stages: int         # chunks of the cp.async ring
    blocks: int         # blocks (one vocab tile or more each), about blocks_per_sm an SM
    smem_bytes: int     # dynamic shared memory of a block of the first pass


def sample_smem_bytes(rows, tiles=None):
    """Shared memory of one score block of ``rows`` x rows, a multiple of
    8 (``csrc`` ``sample_smem``): the ring, each stage the vocab tile's
    chunk and the x rows' chunk in fp32 (row stride chunk + 4) and a bf16
    x chunk's landing area; then each warp's best (value, index) of every
    row of a pass."""
    t = SAMPLE_TILES if tiles is None else tiles
    ring = t["stages"] * ((t["vocab_tile"] + rows) * (t["chunk"] + 4) + rows * t["chunk"] // 2)
    return ring * 4 + t["vocab_tile"] // 16 * t["row_cap"] * 8


def sample_plan(N, H, V, sm_count):
    """The score kernel's launch plan, as ``csrc/decode_sampling.cu``
    launches it for N rows of width H over V vocab rows on a card of
    ``sm_count`` SMs: passes of at most ``row_cap`` rows, each reading the
    embed once; the first pass's n-tiles of 8 rows; a warp for each 16
    vocab rows of a tile; blocks: one for each vocab tile, at most
    ``blocks_per_sm`` an SM (a block takes tiles b, b + blocks, ...).  H
    does not change it."""
    if N <= 0 or V <= 0 or H <= 0 or H % 4 or sm_count <= 0:
        raise ValueError(f"no plan for N={N}, H={H}, V={V}, sm_count={sm_count}")
    t = SAMPLE_TILES
    nt = -(-min(N, t["row_cap"]) // 8)
    blocks = min(-(-V // t["vocab_tile"]), t["blocks_per_sm"] * sm_count)
    return SamplePlan(-(-N // t["row_cap"]), t["row_cap"], nt, t["vocab_tile"] // 16,
                      t["vocab_tile"], t["chunk"], t["stages"], blocks,
                      sample_smem_bytes(8 * nt))


def hash_u32(z):
    """``_hash_u32`` on int64 tensors holding uint32 values."""
    z = (z * 2654435761) & _MASK32
    z = z ^ (z >> 16)
    z = (z * 0x45D9F3B) & _MASK32
    z = z ^ (z >> 16)
    z = (z * 0x45D9F3B) & _MASK32
    z = z ^ (z >> 16)
    return z


def gumbel_from_seed(seeds, cols):
    """Standard Gumbel noise for (row seed, vocab column) pairs —
    ``gumbel_from_seed`` of the JAX package.  ``seeds`` and ``cols``
    are integer tensors that broadcast; returns float32."""
    seeds = seeds.long() & _MASK32
    cols = (cols.long() * 0x9E3779B9) & _MASK32
    z = hash_u32(seeds ^ cols)
    u = ((z >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def fused_sample_plain(x2, embed, seeds, temperature=1.0, top_k=0):
    """The numerics specification (``fused_sample_xla``): materializes
    the fp32 logits.  ``x2`` (N, H), ``embed`` (V, H), ``seeds`` (N,)
    integers holding uint32 values.  Returns (N,) int32 tokens."""
    logits = torch.matmul(x2.float(), embed.float().T)
    N, V = logits.shape
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    cand = logits / temperature
    cols = torch.arange(V, device=logits.device)
    cand = cand + gumbel_from_seed(seeds.to(logits.device)[:, None], cols[None, :])
    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        cand = torch.where(logits >= kth, cand, torch.full_like(cand, NEG_INF))
    return torch.argmax(cand, dim=-1).to(torch.int32)


def _problem(x2, embed, seeds):
    """What the kernel cannot take about these arguments, or None (the
    message is built only on failure: this runs on every launch)."""
    if x2.device.type != "cuda":
        return f"tensors on {x2.device} are not supported"
    return _shape_problem(x2, embed, seeds)


def _shape_problem(x2, embed, seeds):
    """What the kernel cannot take about these arguments' shapes, dtypes,
    layout and alignment, whatever their device, or None."""
    if x2.dim() != 2 or embed.dim() != 2 or x2.shape[1] != embed.shape[1]:
        return (f"x {tuple(x2.shape)} and embed {tuple(embed.shape)} must be "
                f"(N, H) and (V, H)")
    N, H = x2.shape
    if x2.dtype not in _build.FP32_BF16:
        return f"x dtype {x2.dtype} is not float32/bfloat16"
    if embed.dtype != torch.float32 or embed.data_ptr() % 16:
        return "embed must be float32 and 16-byte aligned"
    if x2.data_ptr() % (4 * x2.element_size()):
        return "x must be aligned to 4 of its elements (the kernel's copies)"
    if seeds.dtype != torch.int64 or seeds.shape != (N,):
        return "seeds must be an int64 (N,) tensor"
    if H % 4 or not 0 < H <= MAX_HIDDEN:
        return f"H={H} must be a multiple of 4 in (0, {MAX_HIDDEN}]"
    if not 0 < embed.shape[0] < 2 ** 31:
        return f"vocab {embed.shape[0]} out of range"
    for name, t in (("x", x2), ("embed", embed), ("seeds", seeds)):
        if t.device != x2.device or not t.is_contiguous():
            return f"{name} must be contiguous and on {x2.device}"
    return None


def fused_sample(x2, embed, seeds, temperature=1.0, top_k=0):
    """hidden (N, H) -> token ids (N,) int32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel: ``x2`` float32/bfloat16,
    ``embed`` float32 (V, H) with H % 4 == 0 (up to ``MAX_HIDDEN``),
    ``seeds`` int64, all contiguous on one device, the embed 16-byte
    aligned and x aligned to 4 of its elements."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0 (got {temperature})")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (got {top_k})")
    if x2.device.type == "cpu":
        return fused_sample_plain(x2, embed, seeds, temperature, top_k)
    problem = _problem(x2, embed, seeds)
    if problem:
        raise ValueError(f"fused_sample: {problem}")
    N, H = x2.shape
    V = embed.shape[0]
    tokens = torch.empty(N, dtype=torch.int32, device=x2.device)
    if N == 0:
        return tokens
    dev = x2.device
    nblocks = sample_plan(N, H, V,
                          torch.cuda.get_device_properties(dev).multi_processor_count).blocks
    part_v = torch.empty((nblocks, N), dtype=torch.float32, device=dev)
    part_i = torch.empty((nblocks, N), dtype=torch.int32, device=dev)
    logits = tau = None
    if temperature > 0.0 and 0 < top_k < V:
        logits = torch.empty((N, V), dtype=torch.float32, device=dev)
        tau = torch.empty(N, dtype=torch.float32, device=dev)
    lib, stream = _build.prepare(dev)
    _build.check(lib.apex_fused_sample(
        x2.data_ptr(), embed.data_ptr(), seeds.data_ptr(), tokens.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(),
        None if logits is None else logits.data_ptr(),
        None if tau is None else tau.data_ptr(),
        N, H, V, nblocks, float(temperature), int(top_k),
        _build.DTYPE_CODES[x2.dtype], stream), "fused_sample")
    global LAUNCHES
    LAUNCHES += 1
    return tokens
