"""Fused sampling head: hidden state -> sampled token, the CUDA kernel and
its plain PyTorch version.

Counterpart of :mod:`apex_tpu.ops.decode_sampling_pallas`.  The LM head,
temperature, optional top-k restriction and the categorical draw are
one kernel (``csrc/decode_sampling.cu``): the head streams the fp32
embedding once and never writes the (N, V) logits unless top-k needs
them.  Sampling is the Gumbel-max trick, ``argmax_v(logits_v / T +
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

import torch

from apex_tpu_torch.ops import _build

#: launches of the sampling head by :func:`fused_sample` (one per call:
#: the head is a score kernel and a reduce kernel, plus a logits store
#: and a k-th-value pass under top-k)
LAUNCHES = 0

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
#: the score kernel keeps 8 x rows (fp32) in the default 48 KB of shared
#: memory a block may use, less 1 KB for its static candidate buffers
MAX_HIDDEN = 47 * 1024 // (8 * 4)


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
    if x2.dim() != 2 or embed.dim() != 2 or x2.shape[1] != embed.shape[1]:
        return (f"x {tuple(x2.shape)} and embed {tuple(embed.shape)} must be "
                f"(N, H) and (V, H)")
    N, H = x2.shape
    if x2.dtype not in _build.DTYPE_CODES:
        return f"x dtype {x2.dtype} is not float32/bfloat16"
    if embed.dtype != torch.float32 or embed.data_ptr() % 16:
        return "embed must be float32 and 16-byte aligned"
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
    ``embed`` float32 (V, H) with H % 4 == 0, ``seeds`` int64, all
    contiguous on one device."""
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
    nblocks = min(-(-V // 8), 4 * torch.cuda.get_device_properties(dev).multi_processor_count)
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
