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
// Bound on the H100: memory bytes.  Per (sequence, kv head) the kernel
// reads the longest row's positions of k and v once per row tile and
// does 4 * D flops per (query head, position) pair: at width 1 about 2
// flops per byte in bf16, at the chunk shape (64 rows of one sequence,
// up to 192 positions, 12 heads) about 64, both far below the card's
// ~295 flops/byte ridge.  At the serve shapes one launch reads under
// 1 MB (verify: 8 sequences x <= 240 positions; chunk: about 0.6 MB),
// so launch latency and the serial page loop dominate.
//
// Design: one block per (sequence, kv head, tile of at most 16 query
// rows).  A kv head's query rows are the W * group pairs (w, head of
// the GQA group), row r = w * group + head, tiled in that order so a
// tile holds consecutive positions and its page loop ends early.  The
// block walks the sequence's pages up to ceil(max length of its rows /
// page_size), loading each page's k and v rows of this kv head once into
// shared memory (widened to fp32), and scores all its rows against that
// one read.  Scores are one warp per (row, position) pair with a shuffle
// reduction over D; the running max, sum and accumulator live in shared
// memory.  A page wholly past a row's own length leaves that row
// untouched, so each row takes exactly the steps, in the same order, as
// a width = 1 launch of that row alone: a verify row is bitwise equal
// to the same query decoded alone.  At width 1 with up to 16 heads per
// group a block is one (sequence, kv head), as before; the 16-row tile
// keeps shared memory at ~17 KB at D = 64 and page 16 whatever W and
// group are.  The 64-row chunk is four or more blocks re-reading the
// same pages; tensor-core scoring (mma.sync / wgmma) for it is later
// work, as is splitting a long sequence over several blocks
// (flash-decoding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 16;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round through T and back: the "probabilities cast to v's dtype" step
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// rows a block holds: kRowTile, or all of a kv head's rows when fewer
__host__ __device__ __forceinline__ int rows_per_block(int W, int group) {
  return W * group < kRowTile ? W * group : kRowTile;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths, KT* __restrict__ out,
                         int W, int H, int HKV, int D, int num_pages, int PS, int P,
                         float denom) {
  const int b = blockIdx.x / HKV;  // sequence: its page-table row
  const int g = blockIdx.x % HKV;
  const int group = H / HKV;
  const int RT = rows_per_block(W, group);
  const int r0 = blockIdx.y * RT;
  const int R = min(RT, W * group - r0);  // rows of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int nwarps = kThreads / 32;

  extern __shared__ float sm[];
  float* qs = sm;                 // RT * D
  float* ks = qs + RT * D;        // PS * D
  float* vs = ks + PS * D;        // PS * D
  float* ps = vs + PS * D;        // RT * PS: scores, then exp
  float* acc = ps + RT * PS;      // RT * D
  float* m = acc + RT * D;        // RT
  float* l = m + RT;              // RT
  float* corr = l + RT;           // RT
  int* lens = (int*)(corr + RT);  // RT

  // row rr of the block is (w, head) = divmod(r0 + rr, group); its q
  // and out row starts at ((b * W + w) * H + g * group + head) * D
  auto row_base = [&](int rr) -> int64_t {
    const int r = r0 + rr, w = r / group, hh = r - w * group;
    return (((int64_t)b * W + w) * H + (int64_t)g * group + hh) * D;
  };

  for (int rr = threadIdx.x; rr < R; rr += kThreads) {
    lens[rr] = lengths[(int64_t)b * W + (r0 + rr) / group];
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    qs[i] = to_f32(q[row_base(rr) + d]);
    acc[i] = 0.f;
  }
  __syncthreads();

  int max_len = 0;
  for (int rr = 0; rr < R; ++rr) max_len = max(max_len, lens[rr]);
  int n_pages = max_len <= 0 ? 0 : (max_len + PS - 1) / PS;
  if (n_pages > P) n_pages = P;

  for (int p = 0; p < n_pages; ++p) {
    int page = page_table[(int64_t)b * P + p];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int64_t base = (int64_t)page * PS * HKV * D;
    for (int i = threadIdx.x; i < PS * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int64_t off = base + ((int64_t)j * HKV + g) * D + d;
      ks[i] = to_f32(k_pool[off]);
      vs[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // scores: one warp per (row, position), lanes over D
    for (int pair = warp; pair < R * PS; pair += nwarps) {
      const int rr = pair / PS, j = pair - rr * PS;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[rr * D + d] * ks[j * D + d];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        s = s / denom;
        ps[pair] = (p * PS + j < lens[rr]) ? s : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per row; a page wholly past the
    // row's length leaves it untouched (as a width = 1 launch never
    // reaches that page)
    for (int rr = threadIdx.x; rr < R; rr += kThreads) {
      if (p * PS >= lens[rr]) continue;
      float mx = kNegInf;
      for (int j = 0; j < PS; ++j) mx = fmaxf(mx, ps[rr * PS + j]);
      const float m_prev = m[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < PS; ++j) {
        const float s = ps[rr * PS + j];
        const float e = s > kNegInf / 2 ? expf(s - m_new) : 0.f;
        ps[rr * PS + j] = e;
        sum += e;
      }
      const float c = expf(m_prev - m_new);
      l[rr] = l[rr] * c + sum;
      m[rr] = m_new;
      corr[rr] = c;
    }
    __syncthreads();

    // acc = acc * corr + P.V, P rounded to v's dtype first
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int rr = i / D, d = i - rr * D;
      if (p * PS >= lens[rr]) continue;
      float pv = 0.f;
      for (int j = 0; j < PS; ++j) pv += round_to<KT>(ps[rr * PS + j]) * vs[j * D + d];
      acc[i] = acc[i] * corr[rr] + pv;
    }
    __syncthreads();  // ks / vs / ps are overwritten by the next page
  }

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    out[row_base(rr) + d] = from_f32<KT>(acc[i] / fmaxf(l[rr], 1e-30f));
  }
}

template <typename QT, typename KT>
void launch(const void* q, const void* k, const void* v, const int* pt,
            const int* len, void* out, int B, int W, int H, int HKV, int D,
            int num_pages, int PS, int P, float denom, size_t smem,
            cudaStream_t st) {
  const int group = H / HKV;
  const int RT = rows_per_block(W, group);
  const dim3 grid(B * HKV, (W * group + RT - 1) / RT);
  paged_decode_attn_kernel<QT, KT><<<grid, kThreads, smem, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, pt, len, (KT*)out, W, H, HKV, D,
      num_pages, PS, P, denom);
}

}  // namespace

// Shared-memory bytes the kernel needs at these sizes (the wrapper
// checks it against the 48 KB default limit).
extern "C" int apex_paged_decode_attention_smem(int group, int W, int D, int PS) {
  const int RT = rows_per_block(W, group);
  return (int)sizeof(float) * (2 * RT * D + 2 * PS * D + RT * PS + 4 * RT);
}

// B is the page table's row count (sequences) and W the width: q and
// out are (B * W, H, D), lengths (B * W,), page_table (B, P), all int32
// where integer.  q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; out
// has the pools' dtype.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int W, int H,
    int HKV, int D, int num_pages, int PS, int P, float denom, int q_dtype,
    int kv_dtype, void* stream) {
  if (HKV <= 0 || H % HKV != 0 || W < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = apex_paged_decode_attention_smem(H / HKV, W, D, PS);
  const int* pt = (const int*)page_table;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) {
    launch<float, float>(q, k_pool, v_pool, pt, len, out, B, W, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    launch<float, __nv_bfloat16>(q, k_pool, v_pool, pt, len, out, B, W, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    launch<__nv_bfloat16, float>(q, k_pool, v_pool, pt, len, out, B, W, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, pt, len, out, B, W, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
