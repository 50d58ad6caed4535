// Paged decode attention for Hopper (sm_90a), both layouts.
//
// Replaces: apex_tpu/ops/decode_attention_pallas.py `_decode_attn_kernel`
// (launcher `paged_decode_attention_pallas`), for width = 1 (one query
// per sequence: plain decode) and width = W > 1 (the verify/chunk
// layout: W consecutive query rows per sequence).
//
// Computes, for each query row r and query head h:
//   out[r, h] = softmax(q[r, h] . K_b^T / sqrt(D)) . V_b,   b = r / W
// where K_b, V_b are the first lengths[r] positions of sequence b's
// pages in the pool: one page-table row per sequence, page ids read
// from page_table[b] and clamped into [0, num_pages), each query row
// masked at its own length.  Online softmax in fp32 with a -1e30 mask,
// exp re-masked to 0 for masked positions, probabilities cast to v's
// dtype before P.V, l clamped to >= 1e-30, so a length-0 row gives a
// zero row.  Output in the pool's dtype.
//
// Bound on the H100: never flops.  A launch does 4 * D flops per (query
// head, position) pair against 4 * D bytes of k and v per (kv head,
// position) in bf16: about 1 flop a byte at width 1 (MHA), 64 at the
// 64-row chunk, far below the card's ~295 flops/byte ridge.  At the
// serve shapes a launch reads under 1 MB (verify: 8 sequences x <= 240
// positions; chunk: one sequence, about 0.6 MB), so the time is latency:
// the launch, the dependent page-table and page reads, and the serial
// walk over a sequence's positions.  At long contexts (1024 positions x
// 8 sequences, 25 MB in bf16) it becomes bytes.
//
// Design.  One block per (sequence, kv head, tile of at most 64 query
// rows).  A kv head's query rows are the W * group pairs (w, head of the
// GQA group), row r = w * group + head, tiled in that order, 16 rows (the
// mma tile's M) to a row group: the 64-row chunk (MHA) is one block per
// kv head, so each page is read once per kv head; the verify shape
// (W * group <= 16 rows) and width 1 are one row group.
//   Positions are walked in stages of 64 (kStage), fixed in position:
// stage s holds positions [64 s, 64 s + 64) of the sequence whatever W,
// the tile or the page size.  A stage's k and v rows of this kv head are
// gathered through the page table into shared memory in their own dtype
// by 16-byte cp.async copies from 128 threads (page ids are data, so
// TMA's tiled maps do not fit; each thread reads the ids of its own
// copies a stage ahead), double-buffered: stage s + 1 is in flight while
// stage s is scored, at one __syncthreads a stage.
//   Each stage splits into 4 slices of 16 positions, fixed in position
// too, and each row group has one warp per slice (so a block runs 4
// warps for every 16 rows, 4 to 16).  A warp keeps the online softmax of
// its 16 rows over its slice of every stage (running max, sum and
// accumulator in registers, a row reduced over its quad with shuffles);
// at the end the slices' states are merged into slice 0's in slice
// order, through shared memory.  A launch of up to 16 rows thus has four
// warps' latency chains in flight, not one.
//   q, k and v all bf16 (the serve path): Q.K^T and P.V are
// mma.sync.m16n8k16 with ldmatrix fragments (csrc/mma_bf16.cuh) and fp32
// accumulators; P is rounded to bf16 in registers as the A operand of
// P.V.  Scores are kept in base 2 (log2(e) / sqrt(D) folded into one
// multiply, exp2f).  mma.sync and not wgmma: a verify tile has 5-16
// rows, below wgmma's 64, and flops are not the bound.
//   fp32 or mixed dtypes (the parity runs): the same plan, staging,
// slices and loop; the two products are register-blocked FMA steps on
// CUDA cores (each thread the same 2 rows x 4 positions, and 2 rows x
// D/4 output columns, as its mma fragments), P going through shared
// memory.  TF32 would break the fp32 band.
//
// Bitwise rows across widths.  A row's score at a position is one dot
// product of its own q with the staged k (an mma output element, or a
// fixed-order FMA chain); stage and slice boundaries are fixed in
// position; stages are walked in order and slices merged in order; a
// slice at or past a row's length leaves the row's m, l and acc
// untouched (its corr is 1 and its P is 0, so the mma adds exact zeros).
// So each row takes the same steps with the same operands at every
// width and in every tile: a verify or chunk row is bitwise equal to the
// same query decoded alone.
//
// Later work: splitting long sequences over several blocks
// (flash-decoding: 96 blocks at width 1 fill 132 SMs once, and a long
// context walks its stages serially), and a CUDA graph of the decode
// step, where the launch latency goes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using apex_mma::bf16;
using apex_mma::cp_async16;
using apex_mma::mma16816;
using apex_mma::pack2;
using apex_mma::quad_max;
using apex_mma::quad_sum;

constexpr int kWarpRows = 16;  // query rows of a warp: the mma tile's M
constexpr int kMaxRows = 64;   // query rows of a block
constexpr int kStage = 64;     // positions of a stage, fixed in position
constexpr int kSlice = 16;     // positions of a stage one warp scores
constexpr int kSlices = kStage / kSlice;
constexpr int kLdP = kSlice + 4;                // row stride of the FMA path's P
constexpr int kCopyThreads = 32 * kSlices;      // threads that copy: 128
constexpr int kMaxThreads = kCopyThreads * kMaxRows / kWarpRows;  // 512
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
// round through T and back: the "probabilities cast to v's dtype" step
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four consecutive elements as floats (8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

__host__ __device__ constexpr size_t rup128(size_t b) { return (b + 127) & ~(size_t)127; }

// Shared memory of a block with `rw` row warps (16 query rows each), q
// and the pools of qb and kvb bytes an element (restated by
// `launch_plan` in ops/decode_attention.py for the CPU tests, and held
// against `apex_paged_decode_attention_plan` on the card by
// chip_smoke.py).  Row strides are padded by
// 16 bytes (conflict-free ldmatrix and vector loads); regions are
// 128-byte aligned.  After the stage loop the k/v region holds the
// slices' states while they are merged.
struct Layout {
  int ldq, ldk;
  size_t q, kv, p, lens;
  __host__ __device__ Layout(int rw, int D, int qb, int kvb) {
    const bool mma = qb == 2 && kvb == 2;
    const int rows = kWarpRows * rw;
    ldq = D + (mma ? 8 : 4);  // q: bf16 for the mma path, else fp32
    ldk = D + 16 / kvb;
    q = rup128((size_t)rows * ldq * (mma ? 2 : 4));
    kv = rup128((size_t)kStage * ldk * kvb);  // k or v of one stage
    // the FMA path's fp32 P, one 16 x 16 tile (row stride 20) a warp
    p = mma ? 0 : rup128((size_t)rows * kSlices * kSlice * kLdP * 4 / kWarpRows);
    lens = rup128((size_t)rows * 4);
  }
  __host__ __device__ size_t total() const { return q + 4 * kv + p + lens; }
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths, KT* __restrict__ out, int W,
                         int H, int HKV, int num_pages, int PS, int P, int RT,
                         float scale2) {
  constexpr bool kMma = std::is_same<QT, bf16>::value && std::is_same<KT, bf16>::value;
  constexpr int kVec = 16 / sizeof(KT);  // elements of one 16-byte copy
  constexpr int kCpr = D / kVec;         // copies of one position's row
  constexpr int kPer = kStage * kCpr / kCopyThreads;  // copies of k (and of v) a thread makes a stage
  static_assert(kStage * kCpr % kCopyThreads == 0, "a stage splits evenly over the copy threads");

  const int b = blockIdx.x / HKV;  // sequence: its page-table row
  const int g = blockIdx.x % HKV;
  const int group = H / HKV;
  const int r0 = blockIdx.y * RT;
  const int R = min(RT, W * group - r0);  // rows of this block
  const int rw_n = (RT + kWarpRows - 1) / kWarpRows;
  const int rows_alloc = kWarpRows * rw_n;
  const Layout lay(rw_n, D, sizeof(QT), sizeof(KT));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int sl = warp % kSlices;  // the warp's slice of each stage
  const int wr = kWarpRows * (warp / kSlices);  // and its first row

  extern __shared__ __align__(128) char smem[];
  char* sp = smem;
  char* sQ = sp;
  sp += lay.q;
  char* sKV = sp;  // stage i: k at sKV + 2 i kv bytes, v kv bytes after
  sp += 4 * lay.kv;
  auto stage_k = [&](int i) { return reinterpret_cast<KT*>(sKV + 2 * i * lay.kv); };
  auto stage_v = [&](int i) { return reinterpret_cast<KT*>(sKV + (2 * i + 1) * lay.kv); };
  float* sP = reinterpret_cast<float*>(sp);
  int* lens = reinterpret_cast<int*>(sp + lay.p);

  // row rr of the block is (w, head) = divmod(r0 + rr, group); its q
  // and out row starts at ((b * W + w) * H + g * group + head) * D
  auto row_base = [&](int rr) -> int64_t {
    const int r = r0 + rr, w = r / group, hh = r - w * group;
    return (((int64_t)b * W + w) * H + (int64_t)g * group + hh) * D;
  };

  // lengths, capped at the table: positions past P * PS do not exist
  const int cap = P * PS;
  for (int rr = tid; rr < rows_alloc; rr += nthreads)
    lens[rr] = rr < R ? min(max(lengths[(int64_t)b * W + (r0 + rr) / group], 0), cap) : 0;
  __syncthreads();
  int max_len = 0;
  for (int rr = 0; rr < R; ++rr) max_len = max(max_len, lens[rr]);
  const int n_stages = (max_len + kStage - 1) / kStage;

  // The first kCopyThreads threads copy: each the same (position, 16
  // bytes) slots of every stage.  `off` holds the pool offsets of its
  // slots for the next stage to issue, or -1 past the table (zeros).
  const bool copies = tid < kCopyThreads;
  const int* pt_row = page_table + (int64_t)b * P;
  int64_t off[kPer];
  auto read_ids = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kCopyThreads;
      const int pos = s * kStage + c / kCpr, slot = pos / PS;
      int64_t o = -1;
      if (slot < P) {
        const int page = min(max(pt_row[slot], 0), num_pages - 1);
        o = (((int64_t)page * PS + (pos - slot * PS)) * HKV + g) * D + (c % kCpr) * kVec;
      }
      off[i] = o;
    }
  };
  auto issue = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kCopyThreads;
      const int dst = (c / kCpr) * lay.ldk + (c % kCpr) * kVec;
      const bool ok = off[i] >= 0;
      cp_async16(stage_k(buf) + dst, k_pool + (ok ? off[i] : 0), ok ? 16 : 0);
      cp_async16(stage_v(buf) + dst, v_pool + (ok ? off[i] : 0), ok ? 16 : 0);
    }
  };

  if (n_stages > 0) {
    if (copies) {
      read_ids(0);
      issue(0);
    }
    if constexpr (kMma) {  // q rows as they are, by the same copies
      bf16* qs = reinterpret_cast<bf16*>(sQ);
      for (int c = tid; c < rows_alloc * (D / 8); c += nthreads) {
        const int rr = c / (D / 8), cc = (c % (D / 8)) * 8;
        const bool ok = rr < R;
        cp_async16(qs + rr * lay.ldq + cc, q + (ok ? row_base(rr) + cc : 0), ok ? 16 : 0);
      }
    } else {  // q widened to fp32
      float* qs = reinterpret_cast<float*>(sQ);
      for (int i = tid; i < rows_alloc * D; i += nthreads) {
        const int rr = i / D, d = i - rr * D;
        qs[rr * lay.ldq + d] = rr < R ? to_f32(q[row_base(rr) + d]) : 0.f;
      }
    }
    apex_mma::cp_async_commit();
    if (copies && n_stages > 1) read_ids(1);
  }

  // this thread's rows of the warp's tile: wr + gq and wr + gq + 8
  const bool computes = wr < R;
  const int L[2] = {lens[wr + gq], lens[wr + gq + 8]};
  int warp_len = lens[wr + (lane & 15)];
  for (int o = 8; o > 0; o >>= 1) warp_len = max(warp_len, __shfl_xor_sync(0xffffffffu, warp_len, o));

  uint32_t qf[kMma ? D / 16 : 1][4];
  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int s = 0; s < n_stages; ++s) {
    apex_mma::cp_async_wait<0>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (copies && s + 1 < n_stages) {
      issue((s + 1) & 1);
      if (s + 2 < n_stages) read_ids(s + 2);
    }
    apex_mma::cp_async_commit();
    const int p0 = s * kStage + kSlice * sl;  // the warp's first position
    if (!computes || p0 >= warp_len) continue;  // every row of the warp is done
    const KT* Ks = stage_k(s & 1) + kSlice * sl * lay.ldk;
    const KT* Vs = stage_v(s & 1) + kSlice * sl * lay.ldk;

    // scores: sc[j][e] is row gq + 8 (e >> 1), position p0 + 8 j + 2 t + (e & 1)
    float sc[2][4] = {};
    if constexpr (kMma) {
      const bf16* qs = reinterpret_cast<const bf16*>(sQ);
      if (s == 0) {  // a warp that scores at all scores stage 0 first
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) apex_mma::ld_a(qf[kk], qs, lay.ldq, wr, 16 * kk, lane);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        apex_mma::ld_b_nk(bk, reinterpret_cast<const bf16*>(Ks), lay.ldk, 0, 16 * kk, lane);
        mma16816(sc[0], qf[kk], bk[0], bk[1]);
        mma16816(sc[1], qf[kk], bk[2], bk[3]);
      }
    } else {
      const float* qa = reinterpret_cast<const float*>(sQ) + (wr + gq) * lay.ldq;
      const float* qb = qa + 8 * lay.ldq;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = load4(qa + d), a1 = load4(qb + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kv = load4(Ks + (8 * j + 2 * t + e) * lay.ldk + d);
            float& x0 = sc[j][e];
            float& x1 = sc[j][2 + e];
            x0 = fmaf(a0.x, kv.x, x0); x0 = fmaf(a0.y, kv.y, x0);
            x0 = fmaf(a0.z, kv.z, x0); x0 = fmaf(a0.w, kv.w, x0);
            x1 = fmaf(a1.x, kv.x, x1); x1 = fmaf(a1.y, kv.y, x1);
            x1 = fmaf(a1.z, kv.z, x1); x1 = fmaf(a1.w, kv.w, x1);
          }
      }
    }

    // online softmax in base 2; a row whose length is at or before p0
    // is left as it is
    const bool act[2] = {p0 < L[0], p0 < L[1]};
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, pos = p0 + 8 * j + 2 * t + (e & 1);
        const float v = pos < L[h] ? sc[j][e] * scale2 : kNegInf;
        sc[j][e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float qm = quad_max(mx[h]);
      m_new[h] = act[h] ? fmaxf(m[h], qm) : m[h];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float v = sc[j][e];
        const float pr = act[h] && v > kNegInf / 2 ? exp2f(v - m_new[h]) : 0.f;
        sc[j][e] = pr;
        sum[h] += pr;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float qs = quad_sum(sum[h]);
      if (!act[h]) continue;
      const float corr = exp2f(m[h] - m_new[h]);
      l[h] = l[h] * corr + qs;
      m[h] = m_new[h];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * h] *= corr;
        acc[dn][2 * h + 1] *= corr;
      }
    }

    // acc += P . V over the slice's 16 positions, P rounded to v's dtype first
    if constexpr (kMma) {
      const uint32_t pa[4] = {pack2(sc[0][0], sc[0][1]), pack2(sc[0][2], sc[0][3]),
                              pack2(sc[1][0], sc[1][1]), pack2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dn2 = 0; dn2 < D / 16; ++dn2) {
        uint32_t bv[4];
        apex_mma::ld_b_kn(bv, reinterpret_cast<const bf16*>(Vs), lay.ldk, 16 * dn2, 0, lane);
        mma16816(acc[2 * dn2], pa, bv[0], bv[1]);
        mma16816(acc[2 * dn2 + 1], pa, bv[2], bv[3]);
      }
    } else {
      float* pw = sP + warp * kSlice * kLdP;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(gq + 8 * (e >> 1)) * kLdP + 8 * j + 2 * t + (e & 1)] = round_to<KT>(sc[j][e]);
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kSlice; ++j) {
        const float pr0 = pw[gq * kLdP + j], pr1 = pw[(gq + 8) * kLdP + j];
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const float2 v = load2(Vs + j * lay.ldk + 8 * dn + 2 * t);
          if (act[0]) {
            acc[dn][0] = fmaf(pr0, v.x, acc[dn][0]);
            acc[dn][1] = fmaf(pr0, v.y, acc[dn][1]);
          }
          if (act[1]) {
            acc[dn][2] = fmaf(pr1, v.x, acc[dn][2]);
            acc[dn][3] = fmaf(pr1, v.y, acc[dn][3]);
          }
        }
      }
    }
  }

  // Merge the slices' states into slice 0's, in slice order, through
  // the (now free) k/v region: m, l, then acc of 16 rw_n rows.
  apex_mma::cp_async_wait<0>();
  float* cm = reinterpret_cast<float*>(sKV);
  float* cl = cm + rows_alloc;
  float* ca = cl + rows_alloc;
  constexpr int ldc = D + 4;
  for (int sq = 1; sq < kSlices; ++sq) {
    __syncthreads();
    if (computes && sl == sq) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wr + gq + 8 * h;
        if (t == 0) cm[rr] = m[h], cl[rr] = l[h];
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          store2(ca + rr * ldc + 8 * dn + 2 * t, acc[dn][2 * h], acc[dn][2 * h + 1]);
      }
    }
    __syncthreads();
    if (computes && sl == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wr + gq + 8 * h;
        const float m1 = cm[rr], mn = fmaxf(m[h], m1);
        const float c0 = exp2f(m[h] - mn), c1 = exp2f(m1 - mn);
        l[h] = l[h] * c0 + cl[rr] * c1;
        m[h] = mn;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const float2 a1 = load2(ca + rr * ldc + 8 * dn + 2 * t);
          acc[dn][2 * h] = acc[dn][2 * h] * c0 + a1.x * c1;
          acc[dn][2 * h + 1] = acc[dn][2 * h + 1] * c0 + a1.y * c1;
        }
      }
    }
  }

  if (!computes || sl != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = wr + gq + 8 * h;
    if (rr >= R) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    KT* o = out + row_base(rr);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(o + 8 * dn + 2 * t, acc[dn][2 * h] / lc, acc[dn][2 * h + 1] / lc);
  }
}

struct Launch {
  const void *q, *k, *v;
  const int *pt, *len;
  void* out;
  int B, W, H, HKV, num_pages, PS, P, RT;
  float denom;
  size_t smem;
  cudaStream_t st;
};

template <typename QT, typename KT, int D>
cudaError_t launch(const Launch& a) {
  void (*kernel)(const QT*, const KT*, const KT*, const int*, const int*, KT*, int, int, int,
                 int, int, int, int, float) = &paged_decode_attn_kernel<QT, KT, D>;
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.W * (a.H / a.HKV);
  const dim3 grid(a.B * a.HKV, (rows + a.RT - 1) / a.RT);
  const int threads = kCopyThreads * ((a.RT + kWarpRows - 1) / kWarpRows);
  kernel<<<grid, threads, a.smem, a.st>>>(
      (const QT*)a.q, (const KT*)a.k, (const KT*)a.v, a.pt, a.len, (KT*)a.out, a.W, a.H,
      a.HKV, a.num_pages, a.PS, a.P, a.RT, kLog2e / a.denom);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_d(const Launch& a, int D) {
  switch (D) {
    case 16: return launch<QT, KT, 16>(a);
    case 32: return launch<QT, KT, 32>(a);
    case 48: return launch<QT, KT, 48>(a);
    case 64: return launch<QT, KT, 64>(a);
    case 80: return launch<QT, KT, 80>(a);
    case 96: return launch<QT, KT, 96>(a);
    case 112: return launch<QT, KT, 112>(a);
    case 128: return launch<QT, KT, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The plan of a launch: query rows of a block (at most 64: the
// chunk's 64 rows are one block per kv head), and the shared memory the
// kernel lays out for them.
struct Plan {
  int rows_per_block;
  size_t smem;
};

Plan plan(int W, int group, int D, int q_dtype, int kv_dtype) {
  const int rt = W * group < kMaxRows ? W * group : kMaxRows;
  const Layout lay((rt + kWarpRows - 1) / kWarpRows, D, q_dtype ? 2 : 4, kv_dtype ? 2 : 4);
  return {rt, lay.total()};
}

bool valid(int W, int group, int D, int q_dtype, int kv_dtype) {
  return W >= 1 && group >= 1 && D % 16 == 0 && D >= 16 && D <= 128 &&
         (q_dtype == 0 || q_dtype == 1) && (kv_dtype == 0 || kv_dtype == 1);
}

}  // namespace

// The launch plan at these shapes, for checking its Python statement
// (ops/decode_attention.py `launch_plan`): out[0] query rows of a
// block, out[1] positions of a stage, out[2] shared-memory bytes.
extern "C" int apex_paged_decode_attention_plan(int W, int group, int D, int q_dtype,
                                                int kv_dtype, int* out) {
  if (!valid(W, group, D, q_dtype, kv_dtype)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(W, group, D, q_dtype, kv_dtype);
  out[0] = p.rows_per_block;
  out[1] = kStage;
  out[2] = (int)p.smem;
  return 0;
}

// B is the page table's row count (sequences) and W the width: q and
// out are (B * W, H, D), lengths (B * W,), page_table (B, P), all int32
// where integer.  q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; out
// has the pools' dtype.  D % 16 == 0, D <= 128.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* page_table,
    const void* lengths, void* out, int B, int W, int H, int HKV, int D, int num_pages,
    int PS, int P, float denom, int q_dtype, int kv_dtype, void* stream) {
  if (HKV <= 0 || H % HKV != 0 || !valid(W, H / HKV, D, q_dtype, kv_dtype) || PS < 1 ||
      P < 0 || num_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(W, H / HKV, D, q_dtype, kv_dtype);
  const Launch a = {q, k_pool, v_pool, (const int*)page_table, (const int*)lengths, out,
                    B, W, H, HKV, num_pages, PS, P, p.rows_per_block, denom, p.smem,
                    (cudaStream_t)stream};
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0) e = launch_d<float, float>(a, D);
  else if (q_dtype == 0) e = launch_d<float, bf16>(a, D);
  else if (kv_dtype == 0) e = launch_d<bf16, float>(a, D);
  else e = launch_d<bf16, bf16>(a, D);
  return (int)e;
}
