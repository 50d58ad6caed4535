// Fused LM-head cross entropy for Hopper (sm_90a): forward, dx, dembed.
//
// Replaces apex_tpu/ops/fused_ce_pallas.py:
//   ce_fwd_kernel (+ ce_fwd_combine) <- `_fwd_kernel`    (launcher `fused_ce_fwd_pallas`)
//   ce_bwd_kernel<..., false> (dx)   <- `_dx_kernel`     (launcher `fused_ce_bwd_pallas`)
//   ce_bwd_kernel<..., true> (dembed) <- `_dembed_kernel` (launcher `fused_ce_bwd_pallas`)
//
// Inputs: x (N, H) fp32 or bf16, embed (V, H) fp32 or bf16, t (N,) int32
// target ids, lse and g (N,) fp32.  Outputs: m, l, tgt (N,) fp32 (the
// row max of the logits, the sum of exp at that max, the raw target
// logit), dx (N, H) in x's dtype, dembed (V, H) fp32.  H % 16 == 0,
// H <= 1024.
//
// Numerics, as the Pallas kernels with their default bf16 dot dtype:
// x and embed are rounded to bf16 as their tiles are loaded (embed stays
// fp32 in device memory; no bf16 copy of the table exists), s = x . e^T
// accumulates in fp32 on the tensor cores (mma.sync.m16n8k16).  Columns
// past V weigh 0 and a target hit counts only on a valid column.
// Forward, per 64-column tile: m_new = max(m, max s), l = l * exp(m -
// m_new) + sum exp(s - m_new), tgt += s[t].  Backward: p = exp(s - lse),
// d = (p - onehot(t)) * g in fp32, d rounded to bf16 before d . e (dx)
// and d^T . x (dembed); rows past N and V are zeroed in the tiles and in
// d before any product (0 * garbage = NaN otherwise).
//
// Bound on the H100 at GPT-124M training shapes (N = 8192, H = 768,
// V = 50304): tensor-core operations.  The forward is 2 N V H = 0.633
// TFLOP (0.64 ms at 989 TFLOP/s); dx and dembed recompute s and do one
// more product each, 1.27 TFLOP (1.28 ms) each.  The bytes that must
// move (x, the fp32 embed once, the outputs) are 167 MB forward.
//
// Design.  A block owns ROWS rows of one operand (x rows for the
// forward and dx, embed rows for dembed), converted to bf16 once into
// shared memory, and streams the other operand through shared memory in
// chunks of 64 rows x 64 columns of H: the TPU's sequential grid axis is
// the loop in the block.  s is computed over H by ldmatrix-fed
// mma.sync, one 16-row strip per warp.
//   Forward: ROWS = 128 (64 when H > 768), 8 (4) warps, each warp owns
// 16 rows x the 64 columns of the tile, so the online max / sum-exp runs
// in registers (quad shuffles).  Each chunk is loaded into registers
// (16-byte loads) one step ahead and converted to bf16 into one of two
// chunk buffers.  N / 128 = 64 row blocks do not fill 132 SMs, so the
// vocab is split across gridDim.y (about 128 blocks in all); each split
// writes its partial (m, l, tgt) and `ce_fwd_combine` merges them in a
// fixed order with the tp formula of ops/fused_ce.py (m = max m_s, l =
// sum l_s exp(m_s - m), tgt = sum tgt_s).  One apex_ce_fwd call is one
// launch in the counter of the wrapper.
//   dx and dembed: one kernel template, 8 warps, ROWS own rows, SR
// streamed rows a tile (bwd_h: 64 x 32 for dx, 64 x 64 for dembed at
// H <= 768).  The streamed tile (SR x H) is kept whole in shared
// memory, since both products read it: s = own . tile^T, then d (ROWS
// x SR, bf16) is staged in shared memory and acc (ROWS x H fp32) += d .
// tile.  Chunks arrive by cp.async into a ring of NS raw staging slots,
// NS - P chunks ahead, and each thread converts the vectors it copied;
// P chunks share one barrier.  The accumulator lives in registers, each
// warp owning the 16-column groups warp, warp + 8, ... of H (192
// registers a thread at ROWS = 64, H = 768; about 250 in all, no
// spills), which caps ROWS at 64.  Each output element is summed by one
// block in a fixed order (no atomics, no split reductions), so two
// backward passes give bitwise-equal dx and dembed.  Each block reads
// the whole streamed operand from L2 (fp32 embed: N / 64 x 154.5 MB =
// 19.8 GB for dx; bf16 x: V / 64 x 12.6 MB = 9.9 GB for dembed), and
// every step costs a block-wide barrier; wgmma, TMA multicast across a
// cluster and an accumulator split across warpgroups are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using apex_mma::bf16;
using apex_mma::cp_async16;
using apex_mma::cp_async_commit;
using apex_mma::cp_async_wait;
using apex_mma::ld_a;
using apex_mma::ld_b_kn;
using apex_mma::ld_b_nk;
using apex_mma::mma16816;
using apex_mma::pack2;
using apex_mma::quad_max;
using apex_mma::quad_sum;

constexpr int kChunk = 64;          // rows and columns of a streamed chunk
constexpr int kLdC = kChunk + 8;    // row stride of a chunk buffer / the staged d
constexpr int kBwdThreads = 256;
constexpr int kMaxHidden = 1024;
constexpr int kTargetBlocks = 128;  // forward blocks aimed at (132 SMs, one block each)
constexpr float kNegInf = -1e30f;

// H rounded up to a multiple of w (whole steps of chunks); tiles are
// zero past H.
__host__ __device__ inline int padded(int H, int w = kChunk) { return (H + w - 1) / w * w; }

// CR rows x 64 columns (from column k0) of a row-major (rows, H) source,
// held in registers by THREADS threads as 16-byte vectors, stored to
// shared memory as bf16.  Rows past `valid` and columns past H are zero.
template <typename T, int THREADS, int CR>
struct Chunk {
  static constexpr int kPerRow = kChunk * (int)sizeof(T) / 16;  // vectors a row
  static constexpr int kElems = 16 / (int)sizeof(T);            // elements a vector
  static constexpr int kPer = CR * kPerRow / THREADS;          // vectors a thread
  static_assert(CR * kPerRow % THREADS == 0, "chunk does not split evenly");
  uint4 v[kPer];

  __device__ __forceinline__ void load(const T* src, int valid, int H, int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / kPerRow, c = k0 + (idx % kPerRow) * kElems;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < H) v[i] = *reinterpret_cast<const uint4*>(src + (int64_t)r * H + c);
    }
  }

  // into dst (row stride ld) at columns k0.. of the tile
  __device__ __forceinline__ void store(bf16* dst, int ld, int k0) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      bf16* p = dst + (idx / kPerRow) * ld + k0 + (idx % kPerRow) * kElems;
      if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(&v[i]);
        *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f.x, f.y), pack2(f.z, f.w));
      } else {
        *reinterpret_cast<uint4*>(p) = v[i];
      }
    }
  }
};

// The first `valid` rows of src (row stride H) into a ROWS x width bf16
// tile (row stride ld); everything else zero.
template <typename T, int THREADS, int ROWS>
__device__ void load_own(bf16* dst, int ld, const T* src, int valid, int H, int width) {
  for (int k0 = 0; k0 < width; k0 += kChunk) {
    Chunk<T, THREADS, ROWS> c;
    c.load(src, valid, H, k0);
    c.store(dst, ld, k0);
  }
}


// An SR x 64 chunk (from column k0) of a row-major (rows, H) source,
// copied raw into a shared-memory staging slot (SR x 64 T) by cp.async,
// then converted to bf16 into a tile.  Each thread converts exactly the
// vectors it copied, so its own cp.async.wait_group suffices before the
// conversion.  Rows past `valid` and columns past H copy as zero.
template <typename T, int THREADS, int SR>
struct Staged {
  static constexpr int kPerRow = kChunk * (int)sizeof(T) / 16;
  static constexpr int kElems = 16 / (int)sizeof(T);
  static constexpr int kPer = SR * kPerRow / THREADS;
  static constexpr int kSlot = SR * kChunk;  // elements of a slot
  static_assert(SR * kPerRow % THREADS == 0, "chunk does not split evenly");

  static __device__ __forceinline__ void fetch(T* slot, const T* src, int valid, int H, int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / kPerRow, cc = (idx % kPerRow) * kElems;
      const bool ok = r < valid && k0 + cc < H;
      cp_async16(slot + r * kChunk + cc, ok ? src + (int64_t)r * H + k0 + cc : src, ok ? 16 : 0);
    }
  }

  static __device__ __forceinline__ void convert(bf16* dst, int ld, int k0, const T* slot) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / kPerRow, cc = (idx % kPerRow) * kElems;
      const uint4 v = *reinterpret_cast<const uint4*>(slot + r * kChunk + cc);
      bf16* p = dst + r * ld + k0 + cc;
      if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(&v);
        *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f.x, f.y), pack2(f.z, f.w));
      } else {
        *reinterpret_cast<uint4*>(p) = v;
      }
    }
  }
};

// acc (16 x 8 NT) += A[m0..m0+15, ak0..ak0+63] . B[n0..n0+8NT-1, bk0..bk0+63]^T
template <int NT>
__device__ __forceinline__ void score_chunk(float (&acc)[NT][4], const bf16* A, int lda, int m0,
                                            int ak0, const bf16* B, int ldb, int n0, int bk0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 16) {
    uint32_t a[4];
    ld_a(a, A, lda, m0, ak0 + kk, lane);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      ld_b_nk(b, B, ldb, n0 + 16 * p, bk0 + kk, lane);
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// ------------------------------------------------------------------ forward
// Block (row tile blockIdx.x, vocab split blockIdx.y): partial (m, l,
// tgt) of its rows over vocab tiles [y * tps, (y + 1) * tps) into
// part[(k * S + y) * N + n], k = 0 (m), 1 (l), 2 (tgt), S = gridDim.y.
template <typename TX, typename TE, int ROWS>
__global__ void __launch_bounds__(2 * ROWS, 1)
ce_fwd_kernel(const TX* __restrict__ x, const TE* __restrict__ e, const int* __restrict__ tid,
              float* __restrict__ part, int N, int H, int V, int tps) {
  constexpr int kThreads = 2 * ROWS;  // one warp a 16-row strip
  extern __shared__ __align__(128) char smem[];
  const int ldx = padded(H) + 8, KC = padded(H) / kChunk;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sC = sX + ROWS * ldx;  // two chunk buffers, kChunk x kLdC each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t n0 = (int64_t)blockIdx.x * ROWS;
  const int rows = N - n0 < ROWS ? (int)(N - n0) : ROWS;
  const int nv = (V + kChunk - 1) / kChunk;
  const int vt0 = blockIdx.y * tps, vt1 = min(nv, vt0 + tps);
  const int steps = (vt1 - vt0) * KC;

  load_own<TX, kThreads, ROWS>(sX, ldx, x + n0 * H, rows, H, padded(H));
  const int r0 = warp * 16 + g;  // this thread's rows: r0, r0 + 8
  int target[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) target[h] = r0 + 8 * h < rows ? tid[n0 + r0 + 8 * h] : -1;

  Chunk<TE, kThreads, kChunk> next;
  if (steps > 0) {
    next.load(e + (int64_t)vt0 * kChunk * H, min(kChunk, V - vt0 * kChunk), H, 0);
    next.store(sC, kLdC, 0);
  }
  __syncthreads();
  float s[8][4];
  for (int step = 0; step < steps; ++step) {
    const int vt = vt0 + step / KC, kc = step % KC;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
    }
    const bool more = step + 1 < steps;
    if (more) {  // the next chunk, in flight while this one is multiplied
      const int vn = vt0 + (step + 1) / KC;
      next.load(e + (int64_t)vn * kChunk * H, min(kChunk, V - vn * kChunk), H,
                (step + 1) % KC * kChunk);
    }
    score_chunk<8>(s, sX, ldx, warp * 16, kc * kChunk, sC + (step & 1) * kChunk * kLdC, kLdC,
                   0, 0, lane);
    if (kc == KC - 1) {  // the tile's online max / sum-exp, in registers
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (vt * kChunk + 8 * j + 2 * t + (q & 1) >= V) s[j][q] = kNegInf;
          mx[q >> 1] = fmaxf(mx[q >> 1], s[j][q]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        float sum = 0.f, hit = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 2 * h; q < 2 * h + 2; ++q) {
            const int col = vt * kChunk + 8 * j + 2 * t + (q & 1);
            sum += expf(s[j][q] - m_new);
            if (col < V && col == target[h]) hit += s[j][q];
          }
        l[h] = l[h] * expf(m[h] - m_new) + quad_sum(sum);
        m[h] = m_new;
        tg[h] += quad_sum(hit);
      }
    }
    if (more) next.store(sC + ((step + 1) & 1) * kChunk * kLdC, kLdC, 0);
    __syncthreads();
  }
  if (t == 0) {
    const int64_t S = gridDim.y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= rows) continue;
      part[(0 * S + blockIdx.y) * N + n0 + r] = m[h];
      part[(1 * S + blockIdx.y) * N + n0 + r] = l[h];
      part[(2 * S + blockIdx.y) * N + n0 + r] = tg[h];
    }
  }
}

// The S vocab splits' partials of each row, merged in split order.
__global__ void __launch_bounds__(256)
ce_fwd_combine(const float* __restrict__ part, int S, int N, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ tgt_out) {
  const int64_t n = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float m = kNegInf, l = 0.f, tg = 0.f;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part[(int64_t)s * N + n]);
  for (int s = 0; s < S; ++s) {
    l += part[(int64_t)(S + s) * N + n] * expf(part[(int64_t)s * N + n] - m);
    tg += part[(int64_t)(2 * S + s) * N + n];
  }
  m_out[n] = m;
  l_out[n] = l;
  tgt_out[n] = tg;
}

// ------------------------------------------------------------ dx, dembed
// acc[m][2i + j] += D[16m.., :SR] . Y[:SR, cols] for this warp's column
// groups n0 = 16 (warp + 8i) < H (j: their two 8-column halves); D the
// staged d (16 MT x SR, stride SR + 8), Y the streamed tile (SR x H).
template <int MT, int NP, int SR>
__device__ __forceinline__ void accumulate(float (&acc)[MT][2 * NP][4], const bf16* D,
                                           const bf16* Y, int ld, int H, int warp, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < SR; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ld_a(a[m], D, SR + 8, 16 * m, k0, lane);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n0 = 16 * (warp + 8 * i);
      if (n0 < H) {  // warp-uniform
        uint32_t b[4];
        ld_b_kn(b, Y, ld, n0, k0, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16816(acc[m][2 * i], a[m], b[0], b[1]);
          mma16816(acc[m][2 * i + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

// DEMBED false: own = x (N rows), streamed = embed (V rows), out = dx.
// DEMBED true: own = embed (V rows), streamed = x (N rows), out = dembed.
// d[own r][streamed c] = (exp(s - lse[n]) - (v == t[n])) * g[n], with n
// the x row and v the vocab row of the pair; 0 past N or V.  Streamed
// tiles have SR rows; their chunks run through NS staging slots, and
// each step converts P chunks behind one barrier, with NS - P chunks in
// flight ahead.
template <typename TOWN, typename TSTR, typename TOUT, int ROWS, int SR, int NP, int NS, int P,
          bool DEMBED>
__global__ void __launch_bounds__(kBwdThreads, 1)
ce_bwd_kernel(const TOWN* __restrict__ own, const TSTR* __restrict__ str,
              const int* __restrict__ tid, const float* __restrict__ lse,
              const float* __restrict__ gr, TOUT* __restrict__ out, int n_own, int n_str,
              int H) {
  constexpr int MT = ROWS / 16, WN = 8 / MT, NT = SR / WN / 8, LDD = SR + 8;
  static_assert(NS >= P, "a step needs P staging slots");
  static_assert(NT % 2 == 0, "s pieces are pairs of 8-column tiles");
  using Stage = Staged<TSTR, kBwdThreads, SR>;
  extern __shared__ __align__(128) char smem[];
  const int width = padded(H, P * kChunk), ld = width + 8, KC = width / kChunk;
  bf16* sO = reinterpret_cast<bf16*>(smem);
  bf16* sS = sO + ROWS * ld;
  bf16* sD = sS + SR * ld;
  float* sRow = reinterpret_cast<float*>(sD + ROWS * LDD);  // dembed: lse, g, t of the tile
  TSTR* slots = reinterpret_cast<TSTR*>(sRow + 3 * SR);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rb = 16 * (warp % MT), cb = 8 * NT * (warp / MT);  // this warp's piece of s
  const int64_t o0 = (int64_t)blockIdx.x * ROWS;
  const int orows = n_own - o0 < ROWS ? (int)(n_own - o0) : ROWS;
  const int total = (n_str + SR - 1) / SR * KC;  // chunks streamed, in order

  // chunk c = (streamed tile c / KC, columns (c % KC) * 64) into slot c % NS
  auto fetch = [&](int c) {
    if (c < total) {
      const int s0 = c / KC * SR;
      Stage::fetch(slots + (c % NS) * Stage::kSlot, str + (int64_t)s0 * H, min(SR, n_str - s0),
                   H, c % KC * kChunk);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int c = 0; c < NS - P; ++c) fetch(c);
  load_own<TOWN, kBwdThreads, ROWS>(sO, ld, own + o0 * H, orows, H, width);
  // dx: the own rows' lse, g, t (rows past N: g = 0, so d = 0)
  float o_lse[2] = {0.f, 0.f}, o_g[2] = {0.f, 0.f};
  int o_t[2] = {-1, -1};
  if (!DEMBED) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + g + 8 * h;
      if (r < orows) {
        o_lse[h] = lse[o0 + r];
        o_g[h] = gr[o0 + r];
        o_t[h] = tid[o0 + r];
      }
    }
  }
  float acc[MT][2 * NP][4] = {};
  for (int s0 = 0, c = 0; s0 < n_str; s0 += SR) {
    float s[NT][4] = {};
    if (DEMBED && threadIdx.x < SR) {  // read after this tile's syncs
      const int n = s0 + threadIdx.x;
      sRow[threadIdx.x] = n < n_str ? lse[n] : 0.f;
      sRow[SR + threadIdx.x] = n < n_str ? gr[n] : 0.f;
      reinterpret_cast<int*>(sRow)[2 * SR + threadIdx.x] = n < n_str ? tid[n] : -1;
    }
    for (int kc = 0; kc < KC; kc += P, c += P) {
#pragma unroll
      for (int q = 0; q < P; ++q) fetch(c + NS - P + q);
      cp_async_wait<NS - P>();  // chunks c .. c + P - 1 have landed (this thread's part)
#pragma unroll
      for (int q = 0; q < P; ++q)
        Stage::convert(sS, ld, (kc + q) * kChunk, slots + (c + q) % NS * Stage::kSlot);
      __syncthreads();  // the chunks visible to all; no warp reads their columns before
#pragma unroll
      for (int q = 0; q < P; ++q)
        score_chunk<NT>(s, sO, ld, rb, (kc + q) * kChunk, sS, ld, cb, (kc + q) * kChunk, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rb + g + 8 * h, c2 = cb + 8 * j + 2 * t;
        float d[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float sv = s[j][2 * h + q];
          d[q] = 0.f;
          if (!DEMBED) {
            const int v = s0 + c2 + q;
            if (v < n_str) d[q] = (expf(sv - o_lse[h]) - (v == o_t[h] ? 1.f : 0.f)) * o_g[h];
          } else {
            const int n = c2 + q;  // row of the x tile
            const int64_t v = o0 + r;
            if (s0 + n < n_str && v < n_own)
              d[q] = (expf(sv - sRow[n]) -
                      (v == reinterpret_cast<const int*>(sRow)[2 * SR + n] ? 1.f : 0.f)) *
                     sRow[SR + n];
          }
        }
        *reinterpret_cast<uint32_t*>(sD + r * LDD + c2) = pack2(d[0], d[1]);
      }
    __syncthreads();
    accumulate<MT, NP, SR>(acc, sD, sS, ld, H, warp, lane);
    __syncthreads();  // the tile and d are free for the next tile
  }
  cp_async_wait<0>();
  TOUT* dst = out + o0 * H;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n0 = 16 * (warp + 8 * i);
    if (n0 >= H) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + g + 8 * h;
          if (r < orows)
            store2(dst + (int64_t)r * H + n0 + 8 * j + 2 * t, acc[m][2 * i + j][2 * h],
                   acc[m][2 * i + j][2 * h + 1]);
        }
  }
}

// Rows of a forward block: 128, or 64 when the x tile would not fit.
int fwd_rows(int H) { return H <= 768 ? 128 : 64; }

// Vocab splits of the forward: about kTargetBlocks blocks in all.
int fwd_splits(int N, int H, int V) {
  const int row_blocks = (N + fwd_rows(H) - 1) / fwd_rows(H);
  const int nv = (V + kChunk - 1) / kChunk;
  int S = kTargetBlocks / row_blocks;  // row_blocks >= 1: N > 0 here
  S = S < 1 ? 1 : S > nv ? nv : S;
  const int tps = (nv + S - 1) / S;
  return (nv + tps - 1) / tps;  // no split left empty
}

// Shared memory of a backward block: its own (rows) and streamed (sr)
// tiles, d, the tile's row data and ns staging slots of elem-byte values.
size_t bwd_smem(int H, int rows, int sr, int ns, int p, int elem) {
  const size_t ld = (size_t)padded(H, p * kChunk) + 8;
  return ((rows + sr) * ld + rows * (sr + 8)) * sizeof(bf16) + 3 * sr * sizeof(float) +
         (size_t)ns * sr * kChunk * elem;
}

// Shared memory of a forward block: the x tile and two chunk buffers.
size_t fwd_smem(int H) {
  return (fwd_rows(H) * ((size_t)padded(H) + 8) + 2 * kChunk * kLdC) * sizeof(bf16);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Problem {
  const void* x;
  const void* e;
  const int* t;
  int N, H, V;
  cudaStream_t st;
};

template <typename TX, typename TE, int ROWS>
cudaError_t fwd_rows_t(const Problem& p, float* part, float* m, float* l, float* tgt) {
  auto kernel = ce_fwd_kernel<TX, TE, ROWS>;
  const size_t smem = fwd_smem(p.H);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int S = fwd_splits(p.N, p.H, p.V);
  const int nv = (p.V + kChunk - 1) / kChunk, tps = (nv + S - 1) / S;
  kernel<<<dim3((p.N + ROWS - 1) / ROWS, S), 2 * ROWS, smem, p.st>>>(
      (const TX*)p.x, (const TE*)p.e, p.t, part, p.N, p.H, p.V, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(p.N + 255) / 256, 256, 0, p.st>>>(part, S, p.N, m, l, tgt);
  return cudaGetLastError();
}

template <typename TX, typename TE>
cudaError_t fwd(const Problem& p, float* part, float* m, float* l, float* tgt) {
  return fwd_rows(p.H) == 128 ? fwd_rows_t<TX, TE, 128>(p, part, m, l, tgt)
                              : fwd_rows_t<TX, TE, 64>(p, part, m, l, tgt);
}

template <typename TOWN, typename TSTR, typename TOUT, int ROWS, int SR, int NP, int NS, int P,
          bool DEMBED>
cudaError_t bwd_t(const void* own, const void* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
  auto kernel = ce_bwd_kernel<TOWN, TSTR, TOUT, ROWS, SR, NP, NS, P, DEMBED>;
  const size_t smem = bwd_smem(p.H, ROWS, SR, NS, P, sizeof(TSTR));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_own + ROWS - 1) / ROWS, kBwdThreads, smem, p.st>>>(
      (const TOWN*)own, (const TSTR*)str, p.t, lse, g, (TOUT*)out, n_own, n_str, p.H);
  return cudaGetLastError();
}

// The backward's shape: own rows a block (ROWS), streamed rows a tile
// (SR), column groups a warp (NP = 6 covers H <= 768, 8 up to 1024),
// staging slots (NS), chunks a barrier (P).  64 own rows is the most the
// registers hold.  dembed streams bf16 x: 64-row tiles leave shared
// memory for 2 staging slots.  dx streams fp32 embed, whose slots are
// twice the size: 64-row tiles would leave room for 1 slot and no load
// ahead, so it streams 32-row tiles through 4 slots, 2 chunks a barrier
// (as does dembed of fp32 x).  Above H = 768: 32 own rows, 64-row tiles
// and the 1 slot that always fits.  The shapes were chosen by timing
// the variants on the H100; every shape sums each output in the same
// order.
template <typename TOWN, typename TSTR, typename TOUT, bool DEMBED>
cudaError_t bwd_h(const void* own, const void* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
#define APEX_CE_BWD(R, SR, NP, NS, P) \
  bwd_t<TOWN, TSTR, TOUT, R, SR, NP, NS, P, DEMBED>(own, str, p, lse, g, out, n_own, n_str)
  if (p.H > 768) return APEX_CE_BWD(32, 64, 8, 1, 1);
  if constexpr (DEMBED && sizeof(TSTR) == 2) return APEX_CE_BWD(64, 64, 6, 2, 1);
  else return APEX_CE_BWD(64, 32, 6, 4, 2);
#undef APEX_CE_BWD
}

// which: 1 = dx, 2 = dembed.
template <typename TX, typename TE>
cudaError_t bwd(int which, const Problem& p, const float* lse, const float* g, void* out) {
  if (which == 1) return bwd_h<TX, TE, TX, false>(p.x, p.e, p, lse, g, out, p.N, p.V);
  return bwd_h<TE, TX, float, true>(p.e, p.x, p, lse, g, out, p.V, p.N);
}

template <typename TX, typename TE>
cudaError_t run(int which, const Problem& p, const float* lse, const float* g, void* o0,
                void* o1, void* o2, void* o3) {
  if (which == 0) return fwd<TX, TE>(p, (float*)o3, (float*)o0, (float*)o1, (float*)o2);
  return bwd<TX, TE>(which, p, lse, g, o0);
}

// x_dtype, e_dtype: 0 = float32, 1 = bfloat16.
int dispatch(int which, const Problem& p, const float* lse, const float* g, void* o0,
             void* o1, void* o2, void* o3, int x_dtype, int e_dtype) {
  if (p.H <= 0 || p.H % 16 != 0 || p.H > kMaxHidden || p.N < 0 || p.V <= 0 ||
      x_dtype < 0 || x_dtype > 1 || e_dtype < 0 || e_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  cudaError_t err;
  if (x_dtype == 1 && e_dtype == 0)
    err = run<bf16, float>(which, p, lse, g, o0, o1, o2, o3);
  else if (x_dtype == 1)
    err = run<bf16, bf16>(which, p, lse, g, o0, o1, o2, o3);
  else if (e_dtype == 0)
    err = run<float, float>(which, p, lse, g, o0, o1, o2, o3);
  else
    err = run<float, bf16>(which, p, lse, g, o0, o1, o2, o3);
  return (int)err;
}

}  // namespace

// Vocab splits of the forward: the caller's partial buffer is (3, S, N) fp32.
extern "C" int apex_ce_fwd_splits(int N, int hidden, int V) { return fwd_splits(N, hidden, V); }

// m, l, tgt (N,) fp32; part: the (3, S, N) fp32 scratch.  Two launches:
// the split forward and the combine.
extern "C" int apex_ce_fwd(const void* x, const void* e, const void* t, void* part, void* m,
                           void* l, void* tgt, int N, int H, int V, int x_dtype, int e_dtype,
                           void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(0, p, nullptr, nullptr, m, l, tgt, part, x_dtype, e_dtype);
}

// dx (N, H) in x's dtype.
extern "C" int apex_ce_dx(const void* x, const void* e, const void* t, const void* lse,
                          const void* g, void* dx, int N, int H, int V, int x_dtype,
                          int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(1, p, (const float*)lse, (const float*)g, dx, nullptr, nullptr, nullptr,
                  x_dtype, e_dtype);
}

// dembed (V, H) fp32.
extern "C" int apex_ce_dembed(const void* x, const void* e, const void* t, const void* lse,
                              const void* g, void* de, int N, int H, int V, int x_dtype,
                              int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(2, p, (const float*)lse, (const float*)g, de, nullptr, nullptr, nullptr,
                  x_dtype, e_dtype);
}
