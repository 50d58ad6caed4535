// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/flash_attention_pallas.py:
//   flash_fwd_mma, flash_fwd_f32 <- `_fwd_kernel` (launcher `flash_fwd_pallas`)
//   flash_dq_mma,  flash_dq_f32  <- `_dq_kernel`  (launcher `flash_bwd_pallas`)
//   flash_dkv_mma, flash_dkv_f32 <- `_dkv_kernel` (launcher `flash_bwd_pallas`)
// with the kernels' whole signature: causal or not, grouped-query
// attention (each q head reads its group's k/v rows, and dk/dv sum the
// group inside the dkv block), q_offset/k_offset placing the blocks in a
// global sequence, and an optional per-key additive bias (B, Sk).
//
// Layouts: q, out, do (B*H, Sq, D); k, v, dk, dv (B*H_kv, Sk, D); lse and
// delta (B*H, Sq) fp32; bias (B, Sk) fp32.  dtype float32, bfloat16 or
// float16, one for q, k, v, do and the outputs.  D % 16 == 0, D <= 128.
//   The ring-chunk mode (`ring`, bfloat16 only: the RING instantiations
// of the mma kernels) is what ring attention asks of each chunk pair, as
// it asks `flash_fwd_pallas(..., out_dtype=float32)` and
// `flash_bwd_pallas` with an fp32 cotangent and `out_dtype=float32`
// there: out, dq, dk and dv are written in fp32 from the accumulators,
// and do is fp32.  The Pallas kernels widen v to fp32 rather than round
// do, so dp = do.v^T and dv += p^T.do run on fp32 operands; here each
// fp32 operand is split into bf16 hi + lo (hi = bf16(x), lo = bf16(x -
// hi), the rest under 2^-16 of x) and the products summed: dp = do_hi.v
// + do_lo.v, dv += p_hi.do_hi + p_hi.do_lo + p_lo.do_hi (fp32-grade; one
// TF32 pass, 2^-11, would not be).  ds is rounded to bf16 for ds.k and
// ds^T.q and p for p.v, as there.  dq splits its do rows once a block;
// dkv carries the fp32 do through its cp.async ring and splits each
// stage into one stage of hi and lo tiles behind a second barrier.
//
// Numerics, as the Pallas kernels: s = (q . k) * scale (+ bias); causal
// entries with q_offset + row < k_offset + col are set to NEG_INF =
// -1e30; fp32 online softmax (running max m, sum l, accumulator); p is
// re-masked to 0 where s <= NEG_INF / 2 when causal or biased, so a
// fully masked row gives l = 0, out = 0 (l clamped at 1e-30) and
// lse = m + log(l), never NaN.  The dot inputs round where the Pallas
// kernels round them: p to v's dtype before p.v, ds to k's/q's dtype
// before ds.k and ds^T.q, p to do's dtype before p^T.do.  delta =
// rowsum(do * out) comes from the caller, as XLA computes it there.
// Keys past Sk and rows past Sq (a ragged last tile) weigh exactly 0.
// The bf16 dq and dk sum their tiles' products unscaled and multiply by
// scale once (the Pallas kernels scale each tile's product): the same
// rounding for a power-of-two scale (D = 16, 64), within the bf16 band
// otherwise.
//   float16 is the mma kernels' other element type (a template parameter
// T: `mma.sync ... f32.f16.f16.f32`, `pack2<T>` rounding to fp16, fp16
// stores; the b16 ldmatrix, the cp.async ring and the shared-memory
// plan are the bf16 kernels' own).  The reference has no fp16 Pallas
// kernel: at fp16 it runs the fp32 scan (apex_tpu/ops/attention.py
// `_attend_fwd_scan`, `flash_bwd_from_lse`) and casts only its outputs.
// These kernels round p and ds to fp16 where the bf16 ones round to
// bf16: 2^-11 relative against bf16's 2^-8, inside fp16's range.  ds =
// p (dp - delta) is rounded to fp16 as it is.  Under a loss scale S the
// do, dp and delta it comes from are S times the unscaled ones, and ds
// past 65504 becomes inf where the reference keeps it in fp32: the step's
// gradients are then not finite, and the loss scaler skips the step and
// backs the scale off.  dq and dk (ds . k and ds^T . q times 1/8 at D =
// 64) and dv meet fp16's range at their own stores in both.
//
// Bound on the H100, at GPT-124M training shapes (B*H = 96, S = 1024,
// D = 64, causal, bf16): the forward by bytes (50.7 MB, 15.1 us, beside
// 12.9 GFLOP, 13.0 us at 989 TFLOP/s), dq and dkv by tensor-core
// operations (19.3 and 25.8 GFLOP).  Short of those bounds, the kernels
// are held back by instruction issue: one or two blocks of 4 or 8 warps
// an SM (the forward and dq about 250 registers a thread at 4 warps),
// which interleave mma.sync, ldmatrix and the exp2f of the softmax with
// no overlap of tensor and CUDA-core work beyond what the other warps
// give.  The split backward recomputes q.k^T and do.v^T in both dq and
// dkv: seven products a tile pair against a fused backward's five.
//
// Design.  Each output tile is summed by one block in a fixed order: no
// atomics, and the backward is bitwise reproducible.  Causal tiles wholly
// above the diagonal are skipped, and the heaviest blocks of a causal
// grid are dispatched first, so the grid does not end on a tail of long
// blocks.  Every bf16 kernel streams its tiles through a two-stage
// cp.async ring (the next tile in flight while the current one is
// scored, one barrier a tile), reads its fragments by ldmatrix (.trans
// for a B operand whose depth runs down a row-major tile), keeps scores,
// p and ds in registers in mma.sync.m16n8k16's fragment layout, works in
// base 2 (scale * log2(e) folded into one multiply, lse turned to base 2
// once a row, exp2f), and masks only a tile that is ragged, biased or
// crosses the warp's causal diagonal; a warp skips tiles wholly above
// its diagonal.
//   bf16 forward (`flash_fwd_mma`): a block owns a 128-row q tile (4
// warps of 32 rows for D <= 64, so each fragment of k or v read from
// shared memory feeds two products; 8 warps of 16 rows above) and walks
// 64-key k/v tiles.  lse is written back in natural log.
//   bf16 dq (`flash_dq_mma`): the forward's q tiling and k/v ring; q.k^T
// and do.v^T give s and dp, ds = p (dp - delta) stays in registers as
// the A operand of ds.k, whose k fragments come by ldmatrix .trans.  The
// q and do fragments stay in registers at D <= 32 and D > 64 (1 block an
// SM); at D = 48, 64 they are read again each tile, so that two blocks
// of 4 warps fit an SM's registers.  Grid (B*H, q tiles), the q tiles
// reversed when causal.
//   bf16 dk, dv (`flash_dkv_mma`): a block owns 64 key rows of a kv
// head, 4 warps of 16 rows, two blocks an SM (128 rows, 8 warps, one
// block an SM, was slower: `Dkv`), with k and v fragments in registers
// at D <= 64 (read from shared memory above, so the two accumulators
// fit).  It walks the 64-row q tiles of every q head of its GQA group
// from the first on or below the diagonal, q, do, lse and delta through
// the ring (lse and delta by 4-byte cp.async).  k.q^T and v.do^T give
// s^T and dp^T; p^T.do and ds^T.q take their q/do fragments by ldmatrix
// .trans.  Grid (B*H_kv, key tiles): the first key tiles, the heaviest,
// first.
//   fp32 (`*_f32`, for fp32 parity runs): the same loops with every
// product written to fp32 tiles in shared memory by a 4x4
// register-blocked FMA loop, one warp per row for the softmax, and
// tiles loaded synchronously by `load_tile` (used by these kernels only).
//   Not used: wgmma.  A forward with two consumer warpgroups, Q.K^T as
// wgmma m64n64k16 from shared memory and P.V as m64n16k16 with P in
// registers (core-matrix tiles, no swizzle), gave the same outputs bit
// for bit and was slower on the card at D = 64 and 128 (timed in turns
// against this forward): issuing a product
// and waiting on it within the warpgroup leaves the tensor cores idle
// through the softmax.  wgmma pays off with producer and consumer
// warpgroups that overlap one tile's softmax with the next tile's
// products (FlashAttention-3's ping-pong), which is later work; PERF.md
// keeps what that attempt settled (its descriptors and fragment
// layouts).
// TMA: the tiles are contiguous rows that 16-byte cp.async copies
// already move without a tensor map built on the host per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 64;  // rows of the fp32 kernels' q and k tiles
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory plan of the fp32 kernels, the same on host and device.
// Row strides are padded (by 8 and 4 floats) against bank conflicts;
// every region is 128-byte aligned (16-byte vector copies need 16).
struct Plan {
  int ldt;  // q/k/v/do tiles
  int ldp;  // p/ds tiles
  int ldf;  // score-sized and accumulator tiles
  size_t tile_t, tile_p, tile_f, vec;
  __host__ __device__ static size_t rup(size_t b) { return (b + 127) & ~(size_t)127; }
  __host__ __device__ explicit Plan(int D) {
    ldt = D + 8;
    ldp = kTile + 8;
    ldf = (D > kTile ? D : kTile) + 4;
    tile_t = rup((size_t)kTile * ldt * sizeof(float));
    tile_p = rup((size_t)kTile * ldp * sizeof(float));
    tile_f = rup((size_t)kTile * ldf * sizeof(float));
    vec = rup(kTile * sizeof(float));
  }
  // which: 0 = fwd, 1 = dq, 2 = dkv
  __host__ __device__ size_t bytes(int which) const {
    if (which == 0) return 3 * tile_t + 2 * tile_f + tile_p + 3 * vec;
    if (which == 1) return 4 * tile_t + 3 * tile_f + tile_p + 2 * vec;
    return 4 * tile_t + 4 * tile_f + tile_p + 2 * vec;  // dkv
  }
};

__device__ __forceinline__ char* carve(char*& p, size_t bytes) {
  char* r = p;
  p += bytes;
  return r;
}

// C (M x N, row stride ldc) = A (M x K) . B (K x N), fp32, all in shared
// memory.  A(m, k) = A_COL ? A[k * lda + m] : A[m * lda + k];
// B(k, n) = B_COL ? B[n * ldb + k] : B[k * ldb + n].  M and N are
// multiples of 4.  Every thread of the block calls it.
template <bool A_COL, bool B_COL>
__device__ void mm(float* C, int ldc, const float* A, int lda, const float* B,
                   int ldb, int M, int N, int K) {
  const int tn = N / 4, tiles = (M / 4) * tn;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int m0 = (t / tn) * 4, n0 = (t % tn) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = A_COL ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
        b[i] = B_COL ? B[(n0 + i) * ldb + k] : B[k * ldb + n0 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(m0 + i) * ldc + n0 + j] = acc[i][j];
  }
}

// dst (kTile x D, row stride ld) <- the first `rows` rows of src (row
// stride D); rows past `rows` are zero.  16-byte copies.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = D / kVec;
  for (int c = threadIdx.x; c < kTile * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + (int64_t)r * D + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = v;
  }
}

__device__ void fill(float* dst, int n, float v) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = v;
}

// dst[r, :D] += scale * src[r, :D] over kTile rows (scale 1: a plain add).
__device__ void accumulate(float* dst, const float* src, int ld, int D, float scale) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int o = (i / D) * ld + i % D;
    dst[o] += scale * src[o];
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* bias;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, D, heads, kv_heads;
  float scale;
  int causal, q_offset, k_offset;
};

// The score of (q row r of the tile at q0, key column c of the tile at
// k0) from the raw dot, as the Pallas kernels form it.  Keys past Sk get
// -inf, so they weigh 0 in any softmax.
__device__ __forceinline__ float score(const Args& a, const float* bias, float dot,
                                       int q0, int r, int k0, int c) {
  if (k0 + c >= a.Sk) return -INFINITY;
  float s = dot * a.scale;
  if (bias) s += bias[k0 + c];
  if (a.causal && a.q_offset + q0 + r < a.k_offset + k0 + c) s = kNegInf;
  return s;
}

// Whether the tile pair has any entry on or below the causal diagonal
// (the Pallas kernels' `diag_ok`).
__device__ __forceinline__ bool diag_ok(const Args& a, int q0, int k0) {
  return !a.causal || a.q_offset + q0 + kTile - 1 >= a.k_offset + k0;
}

__device__ __forceinline__ int kv_row(const Args& a, int b) {
  return (b / a.heads) * a.kv_heads + (b % a.heads) / (a.heads / a.kv_heads);
}

// ------------------------------------------------------------- fp32: forward
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  extern __shared__ __align__(128) char smem[];
  const int D = a.D;
  const Plan pl(D);
  char* p = smem;
  float* sQ = (float*)carve(p, pl.tile_t);
  float* sK = (float*)carve(p, pl.tile_t);
  float* sV = (float*)carve(p, pl.tile_t);
  float* sS = (float*)carve(p, pl.tile_f);  // scores, then p.v
  float* sP = (float*)carve(p, pl.tile_p);
  float* sAcc = (float*)carve(p, pl.tile_f);
  float* sM = (float*)carve(p, pl.vec);
  float* sL = (float*)carve(p, pl.vec);
  float* sC = (float*)carve(p, pl.vec);

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const float* k = (const float*)a.k + (int64_t)kvb * a.Sk * D;
  const float* v = (const float*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(sQ, pl.ldt, (const float*)a.q + ((int64_t)b * a.Sq + q0) * D, rows, D);
  fill(sAcc, kTile * pl.ldf, 0.f);
  if (threadIdx.x < kTile) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }
  for (int k0 = 0; k0 < a.Sk && diag_ok(a, q0, k0); k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    const int krows = min(kTile, a.Sk - k0);
    load_tile(sK, pl.ldt, k + (int64_t)k0 * D, krows, D);
    load_tile(sV, pl.ldt, v + (int64_t)k0 * D, krows, D);
    __syncthreads();
    mm<false, true>(sS, pl.ldf, sQ, pl.ldt, sK, pl.ldt, kTile, kTile, D);
    __syncthreads();
    for (int r = warp; r < kTile; r += kWarps) {
      float s[2], mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        s[h] = score(a, bias, sS[r * pl.ldf + c], q0, r, k0, c);
        mx = fmaxf(mx, s[h]);
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float e = expf(s[h] - m_new);
        if (remask && !(s[h] > kNegInf * 0.5f)) e = 0.f;
        sum += e;
        sP[r * pl.ldp + lane + 32 * h] = (e);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    mm<false, false>(sS, pl.ldf, sP, pl.ldp, sV, pl.ldt, kTile, D, kTile);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, o = r * pl.ldf + i % D;
      sAcc[o] = sAcc[o] * sC[r] + sS[o];
    }
  }
  __syncthreads();
  float* out = (float*)a.out + ((int64_t)b * a.Sq + q0) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    out[i] = (sAcc[r * pl.ldf + i % D] / fmaxf(sL[r], 1e-30f));
  }
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    a.lse_out[(int64_t)b * a.Sq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

// ------------------------------------------------------------------ fp32: dq
__global__ void __launch_bounds__(kThreads) flash_dq_f32(Args a) {
  extern __shared__ __align__(128) char smem[];
  const int D = a.D;
  const Plan pl(D);
  char* p = smem;
  float* sQ = (float*)carve(p, pl.tile_t);
  float* sDO = (float*)carve(p, pl.tile_t);
  float* sK = (float*)carve(p, pl.tile_t);
  float* sV = (float*)carve(p, pl.tile_t);
  float* sS = (float*)carve(p, pl.tile_f);   // scores, then ds . k
  float* sDP = (float*)carve(p, pl.tile_f);  // do . v^float
  float* sDS = (float*)carve(p, pl.tile_p);
  float* sAcc = (float*)carve(p, pl.tile_f);
  float* sLse = (float*)carve(p, pl.vec);
  float* sDelta = (float*)carve(p, pl.vec);

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const float* k = (const float*)a.k + (int64_t)kvb * a.Sk * D;
  const float* v = (const float*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t row0 = (int64_t)b * a.Sq + q0;

  load_tile(sQ, pl.ldt, (const float*)a.q + row0 * D, rows, D);
  load_tile(sDO, pl.ldt, (const float*)a.dout + row0 * D, rows, D);
  fill(sAcc, kTile * pl.ldf, 0.f);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    sLse[r] = r < rows ? a.lse_in[row0 + r] : 0.f;
    sDelta[r] = r < rows ? a.delta[row0 + r] : 0.f;
  }
  for (int k0 = 0; k0 < a.Sk && diag_ok(a, q0, k0); k0 += kTile) {
    __syncthreads();
    const int krows = min(kTile, a.Sk - k0);
    load_tile(sK, pl.ldt, k + (int64_t)k0 * D, krows, D);
    load_tile(sV, pl.ldt, v + (int64_t)k0 * D, krows, D);
    __syncthreads();
    mm<false, true>(sS, pl.ldf, sQ, pl.ldt, sK, pl.ldt, kTile, kTile, D);
    mm<false, true>(sDP, pl.ldf, sDO, pl.ldt, sV, pl.ldt, kTile, kTile, D);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const float s = score(a, bias, sS[r * pl.ldf + c], q0, r, k0, c);
      float pr = expf(s - sLse[r]);
      if ((remask && !(s > kNegInf * 0.5f)) || k0 + c >= a.Sk) pr = 0.f;
      sDS[r * pl.ldp + c] = (pr * (sDP[r * pl.ldf + c] - sDelta[r]));
    }
    __syncthreads();
    mm<false, false>(sS, pl.ldf, sDS, pl.ldp, sK, pl.ldt, kTile, D, kTile);
    __syncthreads();
    accumulate(sAcc, sS, pl.ldf, D, a.scale);
  }
  __syncthreads();
  float* dq = (float*)a.dq + row0 * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads)
    dq[i] = (sAcc[(i / D) * pl.ldf + i % D]);
}

// -------------------------------------------------------------- fp32: dk, dv
__global__ void __launch_bounds__(kThreads) flash_dkv_f32(Args a) {
  extern __shared__ __align__(128) char smem[];
  const int D = a.D;
  const Plan pl(D);
  char* p = smem;
  float* sK = (float*)carve(p, pl.tile_t);
  float* sV = (float*)carve(p, pl.tile_t);
  float* sQ = (float*)carve(p, pl.tile_t);
  float* sDO = (float*)carve(p, pl.tile_t);
  float* sS = (float*)carve(p, pl.tile_f);   // scores, then p (fp32)
  float* sP = (float*)carve(p, pl.tile_p);           // p, then ds, in float
  float* sT = (float*)carve(p, pl.tile_f);   // p^float . do, do . v^float, ds^float . q
  float* sDK = (float*)carve(p, pl.tile_f);
  float* sDV = (float*)carve(p, pl.tile_f);
  float* sLse = (float*)carve(p, pl.vec);
  float* sDelta = (float*)carve(p, pl.vec);

  const int bkv = blockIdx.y, k0 = blockIdx.x * kTile;
  const int krows = min(kTile, a.Sk - k0);
  const int group = a.heads / a.kv_heads;
  const int batch = bkv / a.kv_heads;
  const float* bias = a.bias ? a.bias + (int64_t)batch * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t krow0 = (int64_t)bkv * a.Sk + k0;

  load_tile(sK, pl.ldt, (const float*)a.k + krow0 * D, krows, D);
  load_tile(sV, pl.ldt, (const float*)a.v + krow0 * D, krows, D);
  fill(sDK, kTile * pl.ldf, 0.f);
  fill(sDV, kTile * pl.ldf, 0.f);
  for (int g = 0; g < group; ++g) {
    const int b = batch * a.heads + (bkv % a.kv_heads) * group + g;
    for (int q0 = 0; q0 < a.Sq; q0 += kTile) {
      if (!diag_ok(a, q0, k0)) continue;
      const int rows = min(kTile, a.Sq - q0);
      const int64_t row0 = (int64_t)b * a.Sq + q0;
      __syncthreads();
      load_tile(sQ, pl.ldt, (const float*)a.q + row0 * D, rows, D);
      load_tile(sDO, pl.ldt, (const float*)a.dout + row0 * D, rows, D);
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x;
        sLse[r] = r < rows ? a.lse_in[row0 + r] : 0.f;
        sDelta[r] = r < rows ? a.delta[row0 + r] : 0.f;
      }
      __syncthreads();
      mm<false, true>(sS, pl.ldf, sQ, pl.ldt, sK, pl.ldt, kTile, kTile, D);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
        const int r = i / kTile, c = i % kTile, o = r * pl.ldf + c;
        const float s = score(a, bias, sS[o], q0, r, k0, c);
        float pr = expf(s - sLse[r]);
        if ((remask && !(s > kNegInf * 0.5f)) || k0 + c >= a.Sk || r >= rows) pr = 0.f;
        sS[o] = pr;
        sP[r * pl.ldp + c] = (pr);
      }
      __syncthreads();
      mm<true, false>(sT, pl.ldf, sP, pl.ldp, sDO, pl.ldt, kTile, D, kTile);
      __syncthreads();
      accumulate(sDV, sT, pl.ldf, D, 1.f);
      __syncthreads();
      mm<false, true>(sT, pl.ldf, sDO, pl.ldt, sV, pl.ldt, kTile, kTile, D);
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
        const int r = i / kTile, c = i % kTile, o = r * pl.ldf + c;
        sP[r * pl.ldp + c] = (sS[o] * (sT[o] - sDelta[r]));
      }
      __syncthreads();
      mm<true, false>(sT, pl.ldf, sP, pl.ldp, sQ, pl.ldt, kTile, D, kTile);
      __syncthreads();
      accumulate(sDK, sT, pl.ldf, D, a.scale);
    }
  }
  __syncthreads();
  float* dk = (float*)a.dk + krow0 * D;
  float* dv = (float*)a.dv + krow0 * D;
  for (int i = threadIdx.x; i < krows * D; i += kThreads) {
    const int o = (i / D) * pl.ldf + i % D;
    dk[i] = (sDK[o]);
    dv[i] = (sDV[o]);
  }
}

// ---------------------------------- bf16 and fp16: mma.sync kernels
// Templates on the element type T (bf16 or fp16); the comments say bf16
// for both.  One warp owns 16 rows of the block's tile (32 in the
// forward and dq at D <= 64, as two 16-row halves) and keeps its scores,
// probabilities and accumulators in registers, in the fragment layout of
// mma.sync.m16n8k16 (T in, fp32 accumulate): lane = 4 * g + t holds
// rows g and g + 8 of each 16 x 8 accumulator tile, columns 2t and
// 2t + 1.  Scores of two neighbouring 8-column tiles are, once rounded
// to T, exactly the A operand of the next product, so p and ds never
// leave registers.  Only the streamed operand tiles live in shared
// memory.
using apex_mma::bf16;
using apex_mma::mma16816;
using apex_mma::pack2;
using apex_mma::cp_async16;
using apex_mma::cp_async4;
using apex_mma::cp_async_commit;
using apex_mma::cp_async_wait;
using apex_mma::quad_max;
using apex_mma::quad_sum;

// Row `h` (0: g, 1: g + 8) and column of accumulator element e of tile j.
__device__ __forceinline__ int frag_col(int j, int e, int t) { return 8 * j + 2 * t + (e & 1); }

// Stores rows r0 and r0 + 8 (of `rows` valid) of acc * mul as O: bf16 (or
// fp16), rounded, or fp32 as it is (the ring-chunk mode's outputs).
template <typename O, int D>
__device__ __forceinline__ void store_rows(O* dst, const float (&acc)[D / 8][4], int r0,
                                           int rows, float mul0, float mul1, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      O* p = dst + (int64_t)r * D + 8 * dn + 2 * t;
      if constexpr (std::is_same<O, float>::value)
        *reinterpret_cast<float2*>(p) = make_float2(acc[dn][2 * h] * mul, acc[dn][2 * h + 1] * mul);
      else
        *reinterpret_cast<uint32_t*>(p) = pack2<O>(acc[dn][2 * h] * mul, acc[dn][2 * h + 1] * mul);
    }
  }
}

// The ring-chunk mode's split of an fp32 operand into two bf16 ones:
// x = hi + lo + r with hi = bf16(x), lo = bf16(x - hi) and |r| <= 2^-16 |x|,
// two values a register as an mma.sync operand wants them (lo element in
// the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// rows [0, nrows) of an fp32 (nrows x D) tile (row stride D) from src,
// rows past `valid` zero, by 16-byte cp.async copies.
template <int D, int THREADS>
__device__ __forceinline__ void issue_rows_f32(float* dst, const float* src, int nrows,
                                               int valid) {
  constexpr int cpr = D / 4;
  for (int c = threadIdx.x; c < nrows * cpr; c += THREADS) {
    const int r = c / cpr, col = (c % cpr) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * D + col, src + (ok ? (int64_t)r * D + col : 0), ok ? 16 : 0);
  }
}

// hi (row stride D + 8) and lo tiles of the fp32 (nrows x D) tile f (row
// stride D, or `ld`), by split2; every thread of the block calls it.
template <int D, int THREADS>
__device__ __forceinline__ void split_tile(bf16* hi, bf16* lo, const float* f, int64_t ld,
                                           int nrows, int valid) {
  constexpr int cpr = D / 4;
  for (int c = threadIdx.x; c < nrows * cpr; c += THREADS) {
    const int r = c / cpr, col = (c % cpr) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(f + r * ld + col);
    uint32_t h0, l0, h1, l1;
    split2(x.x, x.y, h0, l0);
    split2(x.z, x.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + r * (D + 8) + col) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * (D + 8) + col) = make_uint2(l0, l1);
  }
}

// rows [0, nrows) of a tile (row stride D + 8) from src (row stride D),
// rows past `valid` zero, by 16-byte cp.async copies.
template <int D, int THREADS, typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* src, int nrows, int valid) {
  constexpr int cpr = D / 8;
  for (int c = threadIdx.x; c < nrows * cpr; c += THREADS) {
    const int r = c / cpr, col = (c % cpr) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 8) + col, src + (ok ? (int64_t)r * D + col : 0), ok ? 16 : 0);
  }
}

// acc[i][dn] (16 x 8, dn = 0..D/8-1) += P_i (16 x 64, the fp32 tiles
// s[i] rounded to bf16) . X, with X a row-major (64 x D) tile in shared
// memory (row stride D + 8): the products p.v, ds.k, p^T.do and
// ds^T.q, X's fragments by ldmatrix .trans, each feeding MI products.
template <typename T, int D, int MI>
__device__ __forceinline__ void mm_px(float (&acc)[MI][D / 8][4], const float (&s)[MI][8][4],
                                      const T* X, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      pa[i][0] = pack2<T>(s[i][2 * kk][0], s[i][2 * kk][1]);
      pa[i][1] = pack2<T>(s[i][2 * kk][2], s[i][2 * kk][3]);
      pa[i][2] = pack2<T>(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
      pa[i][3] = pack2<T>(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dn2 = 0; dn2 < D / 16; ++dn2) {
      uint32_t bx[4];
      apex_mma::ld_b_kn(bx, X, D + 8, 16 * dn2, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma16816<T>(acc[i][2 * dn2], pa[i], bx[0], bx[1]);
        mma16816<T>(acc[i][2 * dn2 + 1], pa[i], bx[2], bx[3]);
      }
    }
  }
}

// The ring-chunk mode's acc += P . X at fp32 grade: P (the fp32 tiles s)
// and X (hi + lo, two row-major (64 x D) bf16 tiles) are each split in
// two, and the three products hi.hi + hi.lo + lo.hi are summed (lo.lo,
// under 2^-16 of the whole, is left out).
template <int D, int MI>
__device__ __forceinline__ void mm_px_split(float (&acc)[MI][D / 8][4],
                                            const float (&s)[MI][8][4], const bf16* Xh,
                                            const bf16* Xl, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ph[MI][4], pl[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      split2(s[i][2 * kk][0], s[i][2 * kk][1], ph[i][0], pl[i][0]);
      split2(s[i][2 * kk][2], s[i][2 * kk][3], ph[i][1], pl[i][1]);
      split2(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1], ph[i][2], pl[i][2]);
      split2(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3], ph[i][3], pl[i][3]);
    }
#pragma unroll
    for (int dn2 = 0; dn2 < D / 16; ++dn2) {
      uint32_t bh[4], bl[4];
      apex_mma::ld_b_kn(bh, Xh, D + 8, 16 * dn2, 16 * kk, lane);
      apex_mma::ld_b_kn(bl, Xl, D + 8, 16 * dn2, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma16816<bf16>(acc[i][2 * dn2 + n], ph[i], bh[2 * n], bh[2 * n + 1]);
          mma16816<bf16>(acc[i][2 * dn2 + n], ph[i], bl[2 * n], bl[2 * n + 1]);
          mma16816<bf16>(acc[i][2 * dn2 + n], pl[i], bh[2 * n], bh[2 * n + 1]);
        }
    }
  }
}

// The bf16 forward.  A block owns 128 q rows: 4 warps of 32 rows (two
// m16 tiles, so each k/v fragment read from shared memory feeds two
// products) for D <= 64; 8 warps of 16 rows for D > 64, whose
// accumulators would not fit twice.  K/V tiles of 64 keys come through
// a two-stage cp.async ring: tile i + 1 is in flight while tile i is
// scored, at one barrier a tile.  Fragments come by ldmatrix.  Scores are
// kept in the base-2 domain (scale * log2(e) folded into one multiply,
// exp2f), and only a tile that is ragged, biased or crosses the warp's
// causal diagonal is masked; tiles wholly above a warp's diagonal are
// skipped by that warp.
template <int D>
struct Fwd {
  static constexpr int kMi = D <= 64 ? 2 : 1;  // m16 tiles of a warp
  static constexpr int kWarps = D <= 64 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kMi * kWarps;  // 128
  static constexpr int kN = 64;                    // keys of a k/v tile
  static constexpr int kLd = D + 8;
  // D > 64: q fragments are read again for each tile, so that two
  // blocks fit an SM's registers
  static constexpr bool kQInRegs = D <= 64;
  static constexpr int kMinBlocks = 2;
};

// Shared memory of the bf16 forward: the q tile and two stages of k and v.
__host__ __device__ constexpr size_t fwd_mma_smem(int D) {
  return (size_t)(128 + 4 * 64) * (D + 8) * sizeof(bf16);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMask2 = kNegInf * kLog2e;  // NEG_INF in the base-2 domain

// RING (bf16 only): the ring-chunk mode, out written in fp32 from the
// accumulator (never rounded to bf16), as `flash_fwd_pallas(...,
// out_dtype=float32)` writes it for ring attention.
template <typename T, int D, bool RING>
__global__ void __launch_bounds__(Fwd<D>::kThreads, Fwd<D>::kMinBlocks) flash_fwd_mma(Args a) {
  using F = Fwd<D>;
  using O = typename std::conditional<RING, float, T>::type;
  static_assert(!RING || std::is_same<T, bf16>::value, "the ring-chunk mode is bf16's");
  constexpr int MI = F::kMi, LD = F::kLd, N = F::kN;
  static_assert(F::kRows == 128 && N == 64, "fwd_mma_smem's plan");
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK0 = sQ + F::kRows * LD;  // stage i: k at sK0 + i * kStride, v N rows after
  constexpr int kStride = 2 * N * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  // causal: the heaviest q tiles are launched first
  const int q0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * F::kRows;
  const int rows = min(F::kRows, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const T* k = (const T*)a.k + (int64_t)kvb * a.Sk * D;
  const T* v = (const T*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int wr = warp * 16 * MI;  // the warp's first row of the tile
  // keys [0, kend) are visible to some row of the block, [0, wkend) to
  // some row of the warp (the Pallas kernel's `diag_ok`, by rows)
  int kend = a.Sk, wkend = a.Sk;
  if (a.causal) {
    kend = min(a.Sk, max(0, a.q_offset + q0 + F::kRows - a.k_offset));
    wkend = min(a.Sk, max(0, a.q_offset + q0 + wr + 16 * MI - a.k_offset));
  }
  const int n_tiles = (kend + N - 1) / N;
  const float sl2 = a.scale * kLog2e;

  if (n_tiles > 0) {  // the q tile (rows past Sq zero) and the first k/v tile
    issue_rows<D, F::kThreads>(sQ, (const T*)a.q + ((int64_t)b * a.Sq + q0) * D, F::kRows,
                               rows);
    issue_rows<D, F::kThreads>(sK0, k, N, a.Sk);
    issue_rows<D, F::kThreads>(sK0 + N * LD, v, N, a.Sk);
    cp_async_commit();
  }
  uint32_t qf[MI][F::kQInRegs ? D / 16 : 1][4];
  float acc[MI][D / 8][4] = {};
  float m[MI][2], l[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) m[i][0] = m[i][1] = kMask2, l[i][0] = l[i][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    const int k0 = it * N;
    if (it + 1 < n_tiles) {
      T* nk = sK0 + ((it + 1) & 1) * kStride;
      issue_rows<D, F::kThreads>(nk, k + (int64_t)(k0 + N) * D, N, a.Sk - k0 - N);
      issue_rows<D, F::kThreads>(nk + N * LD, v + (int64_t)(k0 + N) * D, N, a.Sk - k0 - N);
      cp_async_commit();
    }
    if (F::kQInRegs && it == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) apex_mma::ld_a(qf[i][kk], sQ, LD, wr + 16 * i, 16 * kk, lane);
    }
    if (k0 >= wkend) continue;  // the tile is above the diagonal for every row of the warp
    const T* Ks = sK0 + (it & 1) * kStride;
    const T* Vs = Ks + N * LD;
    float s[MI][8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (!F::kQInRegs) {
#pragma unroll
        for (int i = 0; i < MI; ++i) apex_mma::ld_a(qf[i][0], sQ, LD, wr + 16 * i, 16 * kk, lane);
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bk[4];
        apex_mma::ld_b_nk(bk, Ks, LD, 16 * j2, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const uint32_t(&qa)[4] = qf[i][F::kQInRegs ? kk : 0];
          mma16816<T>(s[i][2 * j2], qa, bk[0], bk[1]);
          mma16816<T>(s[i][2 * j2 + 1], qa, bk[2], bk[3]);
        }
      }
    }
    // ragged, biased, or crossing the diagonal of the warp's rows
    const bool masked = k0 + N > a.Sk || bias != nullptr ||
                        (a.causal && a.q_offset + q0 + wr < a.k_offset + k0 + N - 1);
    if (masked) {
      // the bias of this thread's 16 columns, -inf past Sk (weight 0 in any softmax)
      float cb[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + frag_col(j, c, t);
          cb[j][c] = col >= a.Sk ? -INFINITY : bias ? bias[col] * kLog2e : 0.f;
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + wr + 16 * i + g + 8 * (e >> 1), col = k0 + frag_col(j, e, t);
            float x = s[i][j][e] * sl2 + cb[j][e & 1];
            if (a.causal && a.q_offset + row < a.k_offset + col) x = kMask2;
            s[i][j][e] = x;
          }
    } else {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] *= sl2;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][j][e]);
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[i][h], quad_max(mx[h]));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sc = s[i][j][e];
          float pr = exp2f(sc - m_new[e >> 1]);
          if (masked && remask && !(sc > kMask2 * 0.5f)) pr = 0.f;
          s[i][j][e] = pr;
          sum[e >> 1] += pr;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float corr = exp2f(m[i][h] - m_new[h]);
        l[i][h] = l[i][h] * corr + quad_sum(sum[h]);
        m[i][h] = m_new[h];
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[i][dn][2 * h] *= corr;
          acc[i][dn][2 * h + 1] *= corr;
        }
      }
    }
    mm_px<T, D, MI>(acc, s, Vs, lane);  // acc += P . V, P rounded to bf16
  }
  O* out = (O*)a.out + ((int64_t)b * a.Sq + q0) * D;
  float* lse = a.lse_out + (int64_t)b * a.Sq + q0;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r0 = wr + 16 * i + g;
    const float l0 = fmaxf(l[i][0], 1e-30f), l1 = fmaxf(l[i][1], 1e-30f);
    store_rows<O, D>(out, acc[i], r0, rows, 1.f / l0, 1.f / l1, t);
    if (t == 0) {  // natural-log lse; a row that saw no key keeps NEG_INF
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mm = m[i][h] > kMask2 * 0.5f ? m[i][h] * kLn2 : kNegInf;
        if (r0 + 8 * h < rows) lse[r0 + 8 * h] = mm + logf(h ? l1 : l0);
      }
    }
  }
}

// The bf16 dq.  A block owns 128 q rows: 4 warps of 32 rows (two m16
// tiles, so each k or v fragment read from shared memory feeds two
// products) for D <= 64, 8 warps of 16 rows above.  The q and do
// fragments stay in registers where they fit beside the 32-row warp's
// scores, dp and accumulator (D <= 32, and at 16 rows a warp); else they
// are read again from shared memory for each tile.  K/V tiles of 64 keys
// come through a two-stage cp.async ring at one barrier a tile.  Scores
// in base 2 as the forward's; ds stays in registers as ds.k's A operand.
template <int D>
struct Dq {
  static constexpr int kMi = D <= 64 ? 2 : 1;
  static constexpr int kWarps = D <= 64 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kMi * kWarps;  // 128
  static constexpr int kN = 64;                    // keys of a k/v tile
  static constexpr int kLd = D + 8;
  static constexpr bool kRegs = D <= 32 || D > 64;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

// The bf16 dk, dv.  A block owns 64 key rows of a kv head, 4 warps of
// 16, two blocks an SM (8 warps of 128 rows, one block an SM, ran 9 %
// slower at D = 64 and 128: `python -m apex_tpu_torch.flash_bwd_tiles`),
// with their k and v fragments in registers for D <= 64 (read again from
// shared memory for each q tile above, so the accumulators fit).  It walks the q tiles of every q head of the GQA group, from the
// first on or below the causal diagonal, 64 q rows with their do, lse
// and delta through a two-stage cp.async ring.  S^T = K.Q^T and
// dP^T = V.dO^T take their B fragments by ldmatrix, p^T.do and ds^T.q
// by ldmatrix .trans.
template <int D>
struct Dkv {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // key rows of a block
  static constexpr int kN = 64;              // q rows of a q tile
  static constexpr int kLd = D + 8;
  static constexpr bool kRegs = D <= 64;
  static constexpr int kMinBlocks = 2;
};

// Shared memory of the bf16 backward.  dq: the q and do tiles and two
// stages of k and v; dkv: the k and v tiles, two stages of q and do, and
// two of lse and delta (fp32).
// The ring-chunk mode (`ring`) adds, for dq, the lo tile of do (its hi
// tile is the do tile); for dkv, the fp32 do in place of the bf16 one in
// each ring stage and one stage of its hi and lo tiles.
__host__ __device__ constexpr size_t dq_mma_smem(int D, bool ring) {
  return (size_t)(2 * Dq<16>::kRows + 4 * 64 + (ring ? Dq<16>::kRows : 0)) * (D + 8) *
         sizeof(bf16);
}
__host__ __device__ constexpr size_t dkv_mma_smem(int D, bool ring) {
  return (size_t)(2 * Dkv<16>::kRows + 4 * 64) * (D + 8) * sizeof(bf16) + 4 * 64 * sizeof(float) +
         (ring ? 2 * 64 * D * sizeof(float) : 0);
}

// RING (bf16 only): the ring-chunk mode.  do is fp32 (the ring's
// cotangent, never rounded to bf16): the block splits its rows once into
// hi (sDO) and lo (sDOl) bf16 tiles, and dp = do.v^T is the sum of the
// two products, at fp32 grade as the Pallas kernel's widened v gives it;
// ds is rounded to bf16 for ds.k as there; dq is written in fp32.
template <typename T, int D, bool RING>
__global__ void __launch_bounds__(Dq<D>::kThreads, Dq<D>::kMinBlocks) flash_dq_mma(Args a) {
  using F = Dq<D>;
  using O = typename std::conditional<RING, float, T>::type;
  static_assert(!RING || std::is_same<T, bf16>::value, "the ring-chunk mode is bf16's");
  constexpr int MI = F::kMi, LD = F::kLd, N = F::kN, R = F::kRows;
  constexpr int kStride = 2 * N * LD;  // a ring stage: k, then v
  // q and do fragments held in registers (never in the ring-chunk mode,
  // whose do has two)
  constexpr bool REGS = F::kRegs && !RING;
  static_assert(R == Dq<16>::kRows, "dq_mma_smem's plan");
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + R * LD;
  T* sK0 = sDO + R * LD;
  T* sDOl = sK0 + 2 * kStride;  // RING: do's lo tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x;
  // causal: the heaviest q tiles are launched first
  const int q0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * R;
  const int rows = min(R, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const T* k = (const T*)a.k + (int64_t)kvb * a.Sk * D;
  const T* v = (const T*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t row0 = (int64_t)b * a.Sq + q0;
  const int wr = warp * 16 * MI;  // the warp's first row of the tile
  // keys [0, kend) are visible to some row (below Sq) of the block,
  // [0, wkend) to some row of the warp
  int kend = a.Sk, wkend = wr < rows ? a.Sk : 0;
  if (a.causal) {
    kend = min(a.Sk, max(0, a.q_offset + q0 + rows - a.k_offset));
    if (wr < rows)
      wkend = min(a.Sk, max(0, a.q_offset + q0 + min(rows, wr + 16 * MI) - a.k_offset));
  }
  const int n_tiles = (kend + N - 1) / N;
  const float sl2 = a.scale * kLog2e;

  if (n_tiles > 0) {  // the q and do tiles (rows past Sq zero) and the first k/v tile
    issue_rows<D, F::kThreads>(sQ, (const T*)a.q + row0 * D, R, rows);
    if constexpr (!RING) issue_rows<D, F::kThreads>(sDO, (const T*)a.dout + row0 * D, R, rows);
    issue_rows<D, F::kThreads>(sK0, k, N, a.Sk);
    issue_rows<D, F::kThreads>(sK0 + N * LD, v, N, a.Sk);
    cp_async_commit();
    // RING: the fp32 do rows split into their hi and lo tiles once, by
    // plain loads (the first tile's barrier publishes them)
    if constexpr (RING)
      split_tile<D, F::kThreads>(sDO, sDOl, (const float*)a.dout + row0 * D, D, R, rows);
  }
  float lse[MI][2], delta[MI][2];  // lse in base 2
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + 16 * i + g + 8 * h;
      lse[i][h] = r < rows ? a.lse_in[row0 + r] * kLog2e : 0.f;
      delta[i][h] = r < rows ? a.delta[row0 + r] : 0.f;
    }
  uint32_t qf[MI][REGS ? D / 16 : 1][4], df[MI][REGS ? D / 16 : 1][4];
  uint32_t dl[MI][4];  // RING: do's lo fragments
  float acc[MI][D / 8][4] = {};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    const int k0 = it * N;
    if (it + 1 < n_tiles) {
      T* nk = sK0 + ((it + 1) & 1) * kStride;
      issue_rows<D, F::kThreads>(nk, k + (int64_t)(k0 + N) * D, N, a.Sk - k0 - N);
      issue_rows<D, F::kThreads>(nk + N * LD, v + (int64_t)(k0 + N) * D, N, a.Sk - k0 - N);
      cp_async_commit();
    }
    if (REGS && it == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          apex_mma::ld_a(qf[i][kk], sQ, LD, wr + 16 * i, 16 * kk, lane);
          apex_mma::ld_a(df[i][kk], sDO, LD, wr + 16 * i, 16 * kk, lane);
        }
    }
    if (k0 >= wkend) continue;  // the tile is above the diagonal for every row of the warp
    const T* Ks = sK0 + (it & 1) * kStride;
    const T* Vs = Ks + N * LD;
    // s = q.k^T and dp = do.v^T, 64 keys
    float s[MI][8][4] = {}, dp[MI][8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (!REGS) {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          apex_mma::ld_a(qf[i][0], sQ, LD, wr + 16 * i, 16 * kk, lane);
          apex_mma::ld_a(df[i][0], sDO, LD, wr + 16 * i, 16 * kk, lane);
          if constexpr (RING) apex_mma::ld_a(dl[i], sDOl, LD, wr + 16 * i, 16 * kk, lane);
        }
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bk[4], bv[4];
        apex_mma::ld_b_nk(bk, Ks, LD, 16 * j2, 16 * kk, lane);
        apex_mma::ld_b_nk(bv, Vs, LD, 16 * j2, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const uint32_t(&qa)[4] = qf[i][REGS ? kk : 0];
          const uint32_t(&da)[4] = df[i][REGS ? kk : 0];
          mma16816<T>(s[i][2 * j2], qa, bk[0], bk[1]);
          mma16816<T>(s[i][2 * j2 + 1], qa, bk[2], bk[3]);
          mma16816<T>(dp[i][2 * j2], da, bv[0], bv[1]);
          mma16816<T>(dp[i][2 * j2 + 1], da, bv[2], bv[3]);
          if constexpr (RING) {  // dp += do_lo . v^T
            mma16816<T>(dp[i][2 * j2], dl[i], bv[0], bv[1]);
            mma16816<T>(dp[i][2 * j2 + 1], dl[i], bv[2], bv[3]);
          }
        }
      }
    }
    // p = exp2(s * scale * log2(e) - lse), then ds = p * (dp - delta), in s;
    // masked only where the tile is ragged, biased or crosses the diagonal
    // of the warp's rows
    const bool masked = k0 + N > a.Sk || bias != nullptr ||
                        (a.causal && a.q_offset + q0 + wr < a.k_offset + k0 + N - 1);
    if (masked) {
      float cb[8][2];  // the bias of this thread's columns, -inf past Sk
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + frag_col(j, c, t);
          cb[j][c] = col >= a.Sk ? -INFINITY : bias ? bias[col] * kLog2e : 0.f;
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int row = q0 + wr + 16 * i + g + 8 * h, col = k0 + frag_col(j, e, t);
            float x = s[i][j][e] * sl2 + cb[j][e & 1];
            if (a.causal && a.q_offset + row < a.k_offset + col) x = kMask2;
            float pr = exp2f(x - lse[i][h]);
            if (remask && !(x > kMask2 * 0.5f)) pr = 0.f;
            s[i][j][e] = pr * (dp[i][j][e] - delta[i][h]);
          }
    } else {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            s[i][j][e] = exp2f(s[i][j][e] * sl2 - lse[i][h]) * (dp[i][j][e] - delta[i][h]);
          }
    }
    mm_px<T, D, MI>(acc, s, Ks, lane);  // acc += ds . k, ds rounded to bf16
  }
  // the sum over key tiles is scaled once at the end (the Pallas kernel
  // scales each tile's product: the same rounding for a power-of-two
  // scale, e.g. D = 16, 64; within the band otherwise)
#pragma unroll
  for (int i = 0; i < MI; ++i)
    store_rows<O, D>((O*)a.dq + row0 * D, acc[i], wr + 16 * i + g, rows, a.scale, a.scale, t);
}

// RING (bf16 only): the ring-chunk mode.  do is fp32: each ring stage
// carries it as it is, and after the stage lands the block splits it into
// one stage of hi and lo bf16 tiles (a second barrier); dp^T = v.do^T is
// the sum of two products and dv += p^T.do the sum of three
// (`mm_px_split`: p split too), both at fp32 grade as the Pallas kernel's
// fp32 operands give them; ds is rounded to bf16 for ds^T.q as there; dk
// and dv are written in fp32.
template <typename T, int D, bool RING>
__global__ void __launch_bounds__(Dkv<D>::kThreads, Dkv<D>::kMinBlocks) flash_dkv_mma(Args a) {
  using F = Dkv<D>;
  using O = typename std::conditional<RING, float, T>::type;
  static_assert(!RING || std::is_same<T, bf16>::value, "the ring-chunk mode is bf16's");
  constexpr int LD = F::kLd, N = F::kN, R = F::kRows;
  // a ring stage: q, then do (bf16, or fp32 in the ring-chunk mode)
  constexpr int kStageBytes = N * LD * (int)sizeof(T) + (RING ? N * D * 4 : N * LD * (int)sizeof(T));
  static_assert(R == Dkv<16>::kRows, "dkv_mma_smem's plan");
  extern __shared__ __align__(128) char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + R * LD;
  char* ring0 = reinterpret_cast<char*>(sV + R * LD);
  float* sL0 = reinterpret_cast<float*>(ring0 + 2 * kStageBytes);  // stage i: lse, then delta
  T* sDh = reinterpret_cast<T*>(sL0 + 4 * N);  // RING: do's hi and lo tiles
  T* sDl = sDh + N * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x;
  // causal: the heaviest key tiles (lowest k0) are launched first
  const int k0 = blockIdx.y * R;
  const int krows = min(R, a.Sk - k0);
  const int group = a.heads / a.kv_heads;
  const int batch = bkv / a.kv_heads;
  const float* bias = a.bias ? a.bias + (int64_t)batch * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t krow0 = (int64_t)bkv * a.Sk + k0;
  const int wk = warp * 16;  // the warp's first key row of the tile
  // the q tiles from the first with a row that sees key k0
  int qfirst = a.causal ? max(0, a.k_offset + k0 - a.q_offset) : 0;
  const int n_q = qfirst < a.Sq ? (a.Sq - qfirst / N * N + N - 1) / N : 0;
  qfirst = qfirst / N * N;
  const int total = group * n_q;  // (q head, q tile) steps
  const float sl2 = a.scale * kLog2e;

  // q, do, lse and delta of step `it` into ring stage it & 1 (rows past Sq zero)
  auto issue = [&](int it) {
    const int b = batch * a.heads + (bkv % a.kv_heads) * group + it / n_q;
    const int q0 = qfirst + (it % n_q) * N;
    const int64_t row0 = (int64_t)b * a.Sq + q0;
    const int valid = a.Sq - q0;
    T* sq = reinterpret_cast<T*>(ring0 + (it & 1) * kStageBytes);
    issue_rows<D, F::kThreads>(sq, (const T*)a.q + row0 * D, N, valid);
    if constexpr (RING)
      issue_rows_f32<D, F::kThreads>(reinterpret_cast<float*>(sq + N * LD),
                                     (const float*)a.dout + row0 * D, N, valid);
    else
      issue_rows<D, F::kThreads>(sq + N * LD, (const T*)a.dout + row0 * D, N, valid);
    float* sl = sL0 + (it & 1) * 2 * N;
    for (int c = threadIdx.x; c < 2 * N; c += F::kThreads) {
      const int r = c % N;
      const bool ok = r < valid;
      cp_async4(sl + c, (c < N ? a.lse_in : a.delta) + (ok ? row0 + r : 0), ok ? 4 : 0);
    }
  };
  if (total > 0) {  // the k and v tiles (rows past Sk zero) and the first step
    issue_rows<D, F::kThreads>(sK, (const T*)a.k + krow0 * D, R, krows);
    issue_rows<D, F::kThreads>(sV, (const T*)a.v + krow0 * D, R, krows);
    issue(0);
    cp_async_commit();
  }
  uint32_t kf[F::kRegs ? D / 16 : 1][4], vf[F::kRegs ? D / 16 : 1][4];
  float dk[1][D / 8][4] = {}, dv[1][D / 8][4] = {};

  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // step it landed; every warp is done with step it - 1
    if (it + 1 < total) {
      issue(it + 1);
      cp_async_commit();
    }
    if (F::kRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        apex_mma::ld_a(kf[kk], sK, LD, wk, 16 * kk, lane);
        apex_mma::ld_a(vf[kk], sV, LD, wk, 16 * kk, lane);
      }
    }
    const T* Qs = reinterpret_cast<const T*>(ring0 + (it & 1) * kStageBytes);
    if constexpr (RING) {  // the fp32 do of this stage into its hi and lo tiles
      split_tile<D, F::kThreads>(sDh, sDl, reinterpret_cast<const float*>(Qs + N * LD), D, N, N);
      __syncthreads();
    }
    const int q0 = qfirst + (it % n_q) * N;
    // the warp's keys are past Sk, or above the diagonal for every q row
    // of the tile
    if (k0 + wk >= a.Sk ||
        (a.causal && a.q_offset + min(a.Sq, q0 + N) - 1 < a.k_offset + k0 + wk))
      continue;
    const T* DOs = RING ? sDh : Qs + N * LD;
    const float* Ls = sL0 + (it & 1) * 2 * N;
    const float* Ds = Ls + N;
    // s^T = k.q^T and dp^T = v.do^T: the warp's 16 keys x the tile's 64 q rows
    float st[1][8][4] = {}, dpt[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (!F::kRegs) {
        apex_mma::ld_a(kf[0], sK, LD, wk, 16 * kk, lane);
        apex_mma::ld_a(vf[0], sV, LD, wk, 16 * kk, lane);
      }
      const uint32_t(&ka)[4] = kf[F::kRegs ? kk : 0];
      const uint32_t(&va)[4] = vf[F::kRegs ? kk : 0];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bq[4], bd[4];
        apex_mma::ld_b_nk(bq, Qs, LD, 16 * j2, 16 * kk, lane);
        apex_mma::ld_b_nk(bd, DOs, LD, 16 * j2, 16 * kk, lane);
        mma16816<T>(st[0][2 * j2], ka, bq[0], bq[1]);
        mma16816<T>(st[0][2 * j2 + 1], ka, bq[2], bq[3]);
        mma16816<T>(dpt[2 * j2], va, bd[0], bd[1]);
        mma16816<T>(dpt[2 * j2 + 1], va, bd[2], bd[3]);
        if constexpr (RING) {  // dp^T += v . do_lo^T
          apex_mma::ld_b_nk(bd, sDl, LD, 16 * j2, 16 * kk, lane);
          mma16816<T>(dpt[2 * j2], va, bd[0], bd[1]);
          mma16816<T>(dpt[2 * j2 + 1], va, bd[2], bd[3]);
        }
      }
    }
    // p^T = exp2(s^T * scale * log2(e) - lse), masked only where the tile
    // is ragged (keys or q rows), biased or crosses the warp's diagonal
    const bool masked = k0 + wk + 16 > a.Sk || q0 + N > a.Sq || bias != nullptr ||
                        (a.causal && a.q_offset + q0 < a.k_offset + k0 + wk + 15);
    if (masked) {
      float kb[2];  // the bias of this thread's two keys, -inf past Sk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + wk + g + 8 * h;
        kb[h] = key >= a.Sk ? -INFINITY : bias ? bias[key] * kLog2e : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = frag_col(j, e, t);
          const int key = k0 + wk + g + 8 * h, row = q0 + c;
          float x = st[0][j][e] * sl2 + kb[h];
          if (a.causal && a.q_offset + row < a.k_offset + key) x = kMask2;
          float pr = exp2f(x - Ls[c] * kLog2e);
          if ((remask && !(x > kMask2 * 0.5f)) || row >= a.Sq) pr = 0.f;
          st[0][j][e] = pr;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[0][j][e] = exp2f(st[0][j][e] * sl2 - Ls[frag_col(j, e, t)] * kLog2e);
    }
    if constexpr (RING)
      mm_px_split<D, 1>(dv, st, sDh, sDl, lane);  // dv += p^T . do at fp32 grade
    else
      mm_px<T, D, 1>(dv, st, DOs, lane);  // dv += p^T . do, p rounded to bf16
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[0][j][e] *= dpt[j][e] - Ds[frag_col(j, e, t)];  // ds^T
    mm_px<T, D, 1>(dk, st, Qs, lane);  // dk += ds^T . q (scaled at the end, as dq)
  }
  store_rows<O, D>((O*)a.dk + krow0 * D, dk[0], wk + g, krows, a.scale, a.scale, t);
  store_rows<O, D>((O*)a.dv + krow0 * D, dv[0], wk + g, krows, 1.f, 1.f, t);
}

// Shared memory of the mma kernels (which: 0 = fwd, 1 = dq, 2 = dkv;
// ring: the ring-chunk mode).
__host__ __device__ inline size_t mma_smem(int which, int D, bool ring) {
  return which == 0 ? fwd_mma_smem(D) : which == 1 ? dq_mma_smem(D, ring) : dkv_mma_smem(D, ring);
}

cudaError_t launch(void (*kernel)(Args), size_t smem, const Args& a, dim3 grid, int threads,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// rows: B*H for fwd and dq, B*H_kv for dkv.  The fp32 kernels take grid
// (64-row tiles, rows); the bf16 kernels (rows, tiles), so that a
// causal grid's heaviest tiles (reversed q tiles, the first key tiles)
// are dispatched first.
template <typename T, int D, bool RING>
cudaError_t launch_mma(int which, const Args& a, int rows, cudaStream_t st) {
  if (which == 0)
    return launch(&flash_fwd_mma<T, D, RING>, mma_smem(0, D, RING), a,
                  dim3(rows, (a.Sq + Fwd<D>::kRows - 1) / Fwd<D>::kRows), Fwd<D>::kThreads, st);
  if (which == 1)
    return launch(&flash_dq_mma<T, D, RING>, mma_smem(1, D, RING), a,
                  dim3(rows, (a.Sq + Dq<D>::kRows - 1) / Dq<D>::kRows), Dq<D>::kThreads, st);
  return launch(&flash_dkv_mma<T, D, RING>, mma_smem(2, D, RING), a,
                dim3(rows, (a.Sk + Dkv<D>::kRows - 1) / Dkv<D>::kRows), Dkv<D>::kThreads, st);
}

// The mma kernels at the head dim a.D, elements of type T.
template <typename T, bool RING = false>
cudaError_t launch_mma_d(int which, const Args& a, int rows, cudaStream_t st) {
  switch (a.D) {
    case 16: return launch_mma<T, 16, RING>(which, a, rows, st);
    case 32: return launch_mma<T, 32, RING>(which, a, rows, st);
    case 48: return launch_mma<T, 48, RING>(which, a, rows, st);
    case 64: return launch_mma<T, 64, RING>(which, a, rows, st);
    case 80: return launch_mma<T, 80, RING>(which, a, rows, st);
    case 96: return launch_mma<T, 96, RING>(which, a, rows, st);
    case 112: return launch_mma<T, 112, RING>(which, a, rows, st);
    default: return launch_mma<T, 128, RING>(which, a, rows, st);
  }
}

// dtype: 0 = float32 (the *_f32 kernels), 1 = bfloat16, 2 = float16 (the
// mma kernels); ring: the bf16 kernels' ring-chunk mode (fp32 do and
// outputs), bfloat16 only.
int dispatch(int which, const Args& a, int rows, int dtype, int ring, void* stream) {
  if (a.D % 16 != 0 || a.D <= 0 || a.D > 128 || a.heads % a.kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ring) return dtype == 1 ? (int)launch_mma_d<bf16, true>(which, a, rows, st)
                              : (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    void (*kernel)(Args) = which == 0   ? &flash_fwd_f32
                           : which == 1 ? &flash_dq_f32
                                        : &flash_dkv_f32;
    const int tiles = ((which == 2 ? a.Sk : a.Sq) + kTile - 1) / kTile;
    return (int)launch(kernel, Plan(a.D).bytes(which), a, dim3(tiles, rows), kThreads, st);
  }
  if (dtype == 1) return (int)launch_mma_d<bf16>(which, a, rows, st);
  if (dtype == 2) return (int)launch_mma_d<apex_mma::f16>(which, a, rows, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, int Sq,
               int Sk, int D, int heads, int kv_heads, float scale, int causal,
               int q_offset, int k_offset) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = (const float*)bias;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  return a;
}

}  // namespace

// Shared memory of one block (bytes): which 0 = fwd, 1 = dq, 2 = dkv;
// dtype 0 = float32, 1 = bfloat16, 2 = float16 (the same plan as bf16);
// ring: the bf16 ring-chunk mode.
extern "C" int apex_flash_smem(int which, int D, int dtype, int ring) {
  return (int)(dtype == 0 && !ring ? Plan(D).bytes(which) : mma_smem(which, D, ring != 0));
}

// out (BH, Sq, D), lse (BH, Sq).  bias may be null.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse, int BH, int Sq,
                              int Sk, int D, int heads, int kv_heads, float scale,
                              int causal, int q_offset, int k_offset, int dtype, int ring,
                              void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.out = out;
  a.lse_out = (float*)lse;
  return dispatch(0, a, BH, dtype, ring, stream);
}

// dq (BH, Sq, D) from q, k, v, do, lse and delta = rowsum(do * out).
extern "C" int apex_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* bias, void* dq, int BH, int Sq, int Sk, int D,
                             int heads, int kv_heads, float scale, int causal,
                             int q_offset, int k_offset, int dtype, int ring,
                             void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.dout = dout;
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  return dispatch(1, a, BH, dtype, ring, stream);
}

// dk, dv (BKV, Sk, D), each summed over the q heads of its GQA group.
extern "C" int apex_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              const void* bias, void* dk, void* dv, int BKV, int Sq,
                              int Sk, int D, int heads, int kv_heads, float scale,
                              int causal, int q_offset, int k_offset, int dtype, int ring,
                              void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.dout = dout;
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch(2, a, BKV, dtype, ring, stream);
}
