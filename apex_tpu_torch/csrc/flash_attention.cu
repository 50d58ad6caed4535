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
// delta (B*H, Sq) fp32; bias (B, Sk) fp32.  dtype float32 or bfloat16,
// one for q, k, v, do and the outputs.  D % 16 == 0, D <= 128.
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
//
// Bound on the H100, at GPT-124M training shapes (B*H = 96, S = 1024,
// D = 64, causal, bf16): the forward by bytes (50.7 MB, 15.1 us), dq and
// dkv by tensor-core operations (19.3 and 25.8 GFLOP at 989 TFLOP/s).
//
// Design (no wgmma, TMA or double buffering yet: later work).  Blocks
// of 128 threads (4 warps) own one 64-row tile: a q tile for fwd and dq
// (the k tiles are the loop inside the block, in place of the TPU's
// sequential grid axis), a k tile for dkv (the loop walks every q head
// of the GQA group, then the q tiles).  So each output tile is summed by
// one block in a fixed order: no atomics, and the backward is bitwise
// reproducible.  Causal tiles wholly above the diagonal are skipped (fwd
// and dq stop at the diagonal, dkv starts at it).
//   bf16, the training path (`*_mma`): mma.sync.m16n8k16 tensor-core
// products; each warp keeps its 16 rows' scores, probabilities and
// accumulators in registers, and only the streamed operand tiles pass
// through shared memory.
//   fp32 (`*_f32`, for fp32 parity runs): the same loops with every
// product written to fp32 tiles in shared memory by a 4x4
// register-blocked FMA loop, and one warp per row for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 64;  // rows of a q tile and of a k tile
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

// ------------------------------------------------ bf16: mma.sync kernels
// One warp owns 16 rows of the block's 64-row tile and keeps its scores,
// probabilities and accumulators in registers, in the fragment layout of
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate): lane = 4 * g + t holds
// rows g and g + 8 of each 16 x 8 accumulator tile, columns 2t and
// 2t + 1.  Scores of two neighbouring 8-column tiles are, once rounded
// to bf16, exactly the A operand of the next product, so p and ds never
// leave registers.  Only the streamed operand tiles live in shared
// memory.
using apex_mma::bf16;
using apex_mma::mma16816;
using apex_mma::pack2;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// {p[0], p[ld]}: two elements of one column, for a B operand whose k
// runs down the rows of a row-major tile.
__device__ __forceinline__ uint32_t ld_col2(const bf16* p, int ld) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(p) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(p + ld) << 16);
}

// A fragment (16 x 16) at (m0, k0) of row-major X.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X, int ld, int m0,
                                       int k0, int g, int t) {
  const bf16* p = X + (m0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// acc[j] (16 x 8, j = 0..7) += A (16 x D, fragments af) . X^T, with X a
// row-major (64 x D) tile: the 16 x 64 product of a warp's rows with the
// tile's 64 rows.
template <int D>
__device__ __forceinline__ void mm_xt(float (&acc)[8][4], uint32_t (&af)[D / 16][4],
                                      const bf16* X, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* p = X + (8 * j + g) * LD + 16 * kk + 2 * t;
      mma16816(acc[j], af[kk], ld32(p), ld32(p + 8));
    }
  }
}

// acc[dn] (16 x 8, dn = 0..D/8-1) += P (16 x 64, the fp32 tiles s
// rounded to bf16) . X, with X a row-major (64 x D) tile.
template <int D>
__device__ __forceinline__ void mm_px(float (&acc)[D / 8][4], const float (&s)[8][4],
                                      const bf16* X, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                            pack2(s[2 * kk][2], s[2 * kk][3]),
                            pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const bf16* p = X + (16 * kk + 2 * t) * LD + 8 * dn + g;
      mma16816(acc[dn], pa, ld_col2(p, LD), ld_col2(p + 8 * LD, LD));
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row `h` (0: g, 1: g + 8) and column of accumulator element e of tile j.
__device__ __forceinline__ int frag_col(int j, int e, int t) { return 8 * j + 2 * t + (e & 1); }

// Stores rows r0 and r0 + 8 (of `rows` valid) of acc * mul as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int r0,
                                           int rows, float mul0, float mul1, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)r * D + 8 * dn + 2 * t) =
          pack2(acc[dn][2 * h] * mul, acc[dn][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * LD;
  bf16* sV = sK + kTile * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const bf16* k = (const bf16*)a.k + (int64_t)kvb * a.Sk * D;
  const bf16* v = (const bf16*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int r0 = warp * 16 + g;  // this thread's tile rows: r0, r0 + 8

  load_tile(sQ, LD, (const bf16*)a.q + ((int64_t)b * a.Sq + q0) * D, rows, D);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sQ, LD, warp * 16, 16 * kk, g, t);
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < a.Sk && diag_ok(a, q0, k0); k0 += kTile) {
    __syncthreads();
    const int krows = min(kTile, a.Sk - k0);
    load_tile(sK, LD, k + (int64_t)k0 * D, krows, D);
    load_tile(sV, LD, v + (int64_t)k0 * D, krows, D);
    __syncthreads();
    float s[8][4] = {};
    mm_xt<D>(s, qf, sK, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = score(a, bias, s[j][e], q0, r0 + 8 * (e >> 1), k0, frag_col(j, e, t));
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(mx[h]));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = s[j][e];
        float pr = expf(sc - m_new[e >> 1]);
        if (remask && !(sc > kNegInf * 0.5f)) pr = 0.f;
        s[j][e] = pr;
        sum[e >> 1] += pr;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float corr = expf(m[h] - m_new[h]);
      l[h] = l[h] * corr + quad_sum(sum[h]);
      m[h] = m_new[h];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * h] *= corr;
        acc[dn][2 * h + 1] *= corr;
      }
    }
    mm_px<D>(acc, s, sV, g, t);
  }
  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  store_rows<D>((bf16*)a.out + ((int64_t)b * a.Sq + q0) * D, acc, r0, rows, 1.f / l0,
                1.f / l1, t);
  if (t == 0) {
    float* lse = a.lse_out + (int64_t)b * a.Sq + q0;
    if (r0 < rows) lse[r0] = m[0] + logf(l0);
    if (r0 + 8 < rows) lse[r0 + 8] = m[1] + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_mma(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kTile * LD;
  bf16* sK = sDO + kTile * LD;
  bf16* sV = sK + kTile * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.Sq - q0);
  const int kvb = kv_row(a, b);
  const bf16* k = (const bf16*)a.k + (int64_t)kvb * a.Sk * D;
  const bf16* v = (const bf16*)a.v + (int64_t)kvb * a.Sk * D;
  const float* bias = a.bias ? a.bias + (int64_t)(b / a.heads) * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t row0 = (int64_t)b * a.Sq + q0;
  const int r0 = warp * 16 + g;

  load_tile(sQ, LD, (const bf16*)a.q + row0 * D, rows, D);
  load_tile(sDO, LD, (const bf16*)a.dout + row0 * D, rows, D);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], sQ, LD, warp * 16, 16 * kk, g, t);
    load_a(df[kk], sDO, LD, warp * 16, 16 * kk, g, t);
  }
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    lse[h] = r < rows ? a.lse_in[row0 + r] : 0.f;
    delta[h] = r < rows ? a.delta[row0 + r] : 0.f;
  }
  float acc[D / 8][4] = {};
  for (int k0 = 0; k0 < a.Sk && diag_ok(a, q0, k0); k0 += kTile) {
    __syncthreads();
    const int krows = min(kTile, a.Sk - k0);
    load_tile(sK, LD, k + (int64_t)k0 * D, krows, D);
    load_tile(sV, LD, v + (int64_t)k0 * D, krows, D);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mm_xt<D>(s, qf, sK, g, t);
    mm_xt<D>(dp, df, sV, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = frag_col(j, e, t);
        const float sc = score(a, bias, s[j][e], q0, r0 + 8 * h, k0, c);
        float pr = expf(sc - lse[h]);
        if ((remask && !(sc > kNegInf * 0.5f)) || k0 + c >= a.Sk) pr = 0.f;
        s[j][e] = pr * (dp[j][e] - delta[h]);  // ds
      }
    mm_px<D>(acc, s, sK, g, t);
  }
  // the sum over key tiles is scaled once at the end (the Pallas kernel
  // scales each tile's product: the same rounding for a power-of-two
  // scale, e.g. D = 16, 64; within the band otherwise)
  store_rows<D>((bf16*)a.dq + row0 * D, acc, r0, rows, a.scale, a.scale, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;
  bf16* sDO = sQ + kTile * LD;
  float* sLse = reinterpret_cast<float*>(sDO + kTile * LD);
  float* sDelta = sLse + kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.y, k0 = blockIdx.x * kTile;
  const int krows = min(kTile, a.Sk - k0);
  const int group = a.heads / a.kv_heads;
  const int batch = bkv / a.kv_heads;
  const float* bias = a.bias ? a.bias + (int64_t)batch * a.Sk : nullptr;
  const bool remask = a.causal || bias;
  const int64_t krow0 = (int64_t)bkv * a.Sk + k0;
  const int r0 = warp * 16 + g;  // this thread's key rows: r0, r0 + 8

  load_tile(sK, LD, (const bf16*)a.k + krow0 * D, krows, D);
  load_tile(sV, LD, (const bf16*)a.v + krow0 * D, krows, D);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(kf[kk], sK, LD, warp * 16, 16 * kk, g, t);
    load_a(vf[kk], sV, LD, warp * 16, 16 * kk, g, t);
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int gi = 0; gi < group; ++gi) {
    const int b = batch * a.heads + (bkv % a.kv_heads) * group + gi;
    for (int q0 = 0; q0 < a.Sq; q0 += kTile) {
      if (!diag_ok(a, q0, k0)) continue;
      const int rows = min(kTile, a.Sq - q0);
      const int64_t row0 = (int64_t)b * a.Sq + q0;
      __syncthreads();
      load_tile(sQ, LD, (const bf16*)a.q + row0 * D, rows, D);
      load_tile(sDO, LD, (const bf16*)a.dout + row0 * D, rows, D);
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x;
        sLse[r] = r < rows ? a.lse_in[row0 + r] : 0.f;
        sDelta[r] = r < rows ? a.delta[row0 + r] : 0.f;
      }
      __syncthreads();
      // s^T (this warp's 16 keys x the tile's 64 queries), then p^T
      float st[8][4] = {};
      mm_xt<D>(st, kf, sQ, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + 8 * (e >> 1), qc = frag_col(j, e, t);
          const float sc = score(a, bias, st[j][e], q0, qc, k0, kr);
          float pr = expf(sc - sLse[qc]);
          if ((remask && !(sc > kNegInf * 0.5f)) || k0 + kr >= a.Sk || qc >= rows) pr = 0.f;
          st[j][e] = pr;
        }
      mm_px<D>(dv, st, sDO, g, t);  // dv += p^T . do
      float dpt[8][4] = {};
      mm_xt<D>(dpt, vf, sDO, g, t);  // dp^T = v . do^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[j][e] *= dpt[j][e] - sDelta[frag_col(j, e, t)];  // ds^T
      mm_px<D>(dk, st, sQ, g, t);  // dk += ds^T . q (scaled at the end, as dq)
    }
  }
  store_rows<D>((bf16*)a.dk + krow0 * D, dk, r0, krows, a.scale, a.scale, t);
  store_rows<D>((bf16*)a.dv + krow0 * D, dv, r0, krows, 1.f, 1.f, t);
}

// Shared memory of the mma kernels: 3 (fwd) or 4 bf16 tiles, plus lse
// and delta for dkv.
__host__ __device__ inline size_t mma_smem(int which, int D) {
  const size_t tile = (size_t)kTile * (D + 8) * sizeof(bf16);
  return which == 0 ? 3 * tile : which == 1 ? 4 * tile : 4 * tile + 2 * kTile * sizeof(float);
}

cudaError_t launch(void (*kernel)(Args), size_t smem, const Args& a, int grid_x,
                   int grid_y, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(grid_x, grid_y), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(int which, const Args& a, int grid_x, int grid_y, cudaStream_t st) {
  void (*kernel)(Args) = which == 0   ? &flash_fwd_mma<D>
                         : which == 1 ? &flash_dq_mma<D>
                                      : &flash_dkv_mma<D>;
  return launch(kernel, mma_smem(which, D), a, grid_x, grid_y, st);
}

int dispatch(int which, const Args& a, int grid_x, int grid_y, int dtype, void* stream) {
  if (a.D % 16 != 0 || a.D <= 0 || a.D > 128 || a.heads % a.kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    void (*kernel)(Args) = which == 0   ? &flash_fwd_f32
                           : which == 1 ? &flash_dq_f32
                                        : &flash_dkv_f32;
    return (int)launch(kernel, Plan(a.D).bytes(which), a, grid_x, grid_y, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 16: return (int)launch_mma<16>(which, a, grid_x, grid_y, st);
    case 32: return (int)launch_mma<32>(which, a, grid_x, grid_y, st);
    case 48: return (int)launch_mma<48>(which, a, grid_x, grid_y, st);
    case 64: return (int)launch_mma<64>(which, a, grid_x, grid_y, st);
    case 80: return (int)launch_mma<80>(which, a, grid_x, grid_y, st);
    case 96: return (int)launch_mma<96>(which, a, grid_x, grid_y, st);
    case 112: return (int)launch_mma<112>(which, a, grid_x, grid_y, st);
    default: return (int)launch_mma<128>(which, a, grid_x, grid_y, st);
  }
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
// dtype 0 = float32, 1 = bfloat16.
extern "C" int apex_flash_smem(int which, int D, int dtype) {
  return (int)(dtype == 1 ? mma_smem(which, D) : Plan(D).bytes(which));
}

// out (BH, Sq, D), lse (BH, Sq).  bias may be null.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse, int BH, int Sq,
                              int Sk, int D, int heads, int kv_heads, float scale,
                              int causal, int q_offset, int k_offset, int dtype,
                              void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.out = out;
  a.lse_out = (float*)lse;
  return dispatch(0, a, (Sq + kTile - 1) / kTile, BH, dtype, stream);
}

// dq (BH, Sq, D) from q, k, v, do, lse and delta = rowsum(do * out).
extern "C" int apex_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* bias, void* dq, int BH, int Sq, int Sk, int D,
                             int heads, int kv_heads, float scale, int causal,
                             int q_offset, int k_offset, int dtype, void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.dout = dout;
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  return dispatch(1, a, (Sq + kTile - 1) / kTile, BH, dtype, stream);
}

// dk, dv (BKV, Sk, D), each summed over the q heads of its GQA group.
extern "C" int apex_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              const void* bias, void* dk, void* dv, int BKV, int Sq,
                              int Sk, int D, int heads, int kv_heads, float scale,
                              int causal, int q_offset, int k_offset, int dtype,
                              void* stream) {
  Args a = make_args(q, k, v, bias, Sq, Sk, D, heads, kv_heads, scale, causal,
                     q_offset, k_offset);
  a.dout = dout;
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch(2, a, (Sk + kTile - 1) / kTile, BKV, dtype, stream);
}
