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
// x and embed are rounded to bf16 (nearest even) before x . e^T, which
// accumulates in fp32 on the tensor cores (mma.sync.m16n8k16).  Columns
// past V weigh 0 and a target hit counts only on a valid column.
// Forward, per 64-column tile: m_new = max(m, max s), l = l * exp(m -
// m_new) + sum exp(s - m_new), tgt += s[t].  Backward: p = exp(s - lse)
// (as exp2(s log2 e - lse log2 e)), d = (p - onehot(t)) * g in fp32, d
// rounded to bf16 before d . e (dx) and d^T . x (dembed); rows past N
// and V are zeroed in the tiles and in d before any product (0 * garbage
// = NaN otherwise).
//
// Bound on the H100 at GPT-124M training shapes (N = 8192, H = 768,
// V = 50304): tensor-core operations.  The forward is 2 N V H = 0.633
// TFLOP (0.64 ms at 989 TFLOP/s); dx and dembed recompute s and do one
// more product each, 1.27 TFLOP (1.28 ms) each.  The bytes that must
// move (x, the fp32 embed once, the outputs) are 167 MB forward.
//
// Forward.  A block owns 128 x rows (64 when H > 768), converted to
// bf16 once into shared memory, and streams the embed in chunks of 64
// rows x 64 columns of H: the TPU's sequential grid axis is the loop in
// the block.  8 (4) warps, each owning 16 rows x the 64 columns of the
// tile, so the online max / sum-exp runs in registers (quad shuffles).
// Each chunk is loaded into registers (16-byte loads) one step ahead
// and converted to bf16 into one of two chunk buffers.  N / 128 = 64
// row blocks do not fill 132 SMs, so the vocab is split across
// gridDim.y (about 128 blocks in all); each split writes its partial
// (m, l, tgt) and `ce_fwd_combine` merges them in a fixed order with the
// tp formula of ops/fused_ce.py (m = max m_s, l = sum l_s exp(m_s - m),
// tgt = sum tgt_s).  One apex_ce_fwd call is one launch in the counter
// of the wrapper.
//
// dx and dembed: one kernel template of W warps (BwdH768: 8 warps, 64
// own rows, K = 4; BwdH1024, above H = 768: 12 warps, 32 own rows, K =
// 6).  A block owns ROWS rows of one operand (x for dx, embed for
// dembed), converted to bf16 once as its tile loads, and streams the
// other operand in tiles of SR = 32 rows x all of H; the accumulator
// (ROWS x H fp32) lives in registers, each warp owning the 16-column
// groups warp, warp + W, ... of H (192 registers a thread at ROWS = 64,
// H = 768, W = 8), which caps ROWS at 64 (32 above H = 768, where the
// own tile and two streamed tiles would not fit in shared memory).
//  - The streamed operand is read whole by every block (N / 64 blocks
//    of dx each read the embed), so it is bf16: an fp32 streamed operand
//    (the embed of dx in training, x of dembed on the fp32 path) is
//    converted once a call by `ce_to_bf16` into scratch the wrapper
//    allocates, with the rounding of the tiles (dx's L2 traffic is 9.9
//    GB at GPT-124M, not the 19.8 of an fp32 stream).  One wrapper call
//    is still one launch in its counter.
//  - Streamed tiles come by 16-byte cp.async straight into the padded
//    row-major tile (row stride H + 8) that ldmatrix reads, through a
//    two-stage ring: the next tile is in flight while this one is
//    multiplied.  dembed's lse, g and t of a tile come with it by 4-byte
//    cp.async.
//  - s = own . tile^T (ROWS x SR) is split over H: the warps form KG
//    groups, each computing a partial s over a contiguous slice of the
//    16-column steps of H, so a warp's piece of s is larger (32 x 32 at
//    W = 8, K = 4) and each ldmatrix feeds two products (48 ldmatrix for
//    96 mma a warp a tile; unsplit, 16 x 16 pieces took 96).  Each
//    fragment tile of s has one owner group, which adds the other groups'
//    partials (staged in shared memory) to its own in group order 0, 1,
//    ..., never in the order they finish, computes d and stages it as
//    bf16.  The split moves the last bits of s from the unsplit sum,
//    never from run to run.
//  - d stays staged in shared memory (ROWS x (SR + 8) bf16) for d . tile:
//    every warp reads d for all own rows once per 16 streamed rows and
//    reuses it across its column groups of H (20 ldmatrix for 96 mma a
//    warp).  Keeping d in registers would save the 5 KB stage but give up
//    that reuse.
//  - Three block-wide barriers a streamed tile: the ring's head (the tile
//    landed, the other stage and d free), after the partials, after d.
//  - The widths of the repo's GPT configurations (768, 1024) are
//    compile-time constants of their own instantiations: the score loop
//    unrolls, tile addresses fold to constant offsets, and the K = 4
//    kernel at 768 fits its 254 registers without a spill.  Other widths
//    take H at run time.
// What bounds it (GPT-124M, bf16 x, fp32 embed, an H100 80GB HBM3 at
// 700 W; `python -m apex_tpu_torch.ce_bwd_tiles`, whose ablations take
// parts of the tile loop out): dx 6.0 ms and dembed 5.9, 4.6x their
// bound.  The loop with both products taken out is the stream alone,
// 2.7 ms (9.9 GB from L2 at about 3.7 TB/s); with the copies taken out,
// the products alone, 4.6 ms (1.27 TFLOP at about 275 TFLOP/s, 28 % of
// the tensor cores' peak).  So the copies are only partly hidden, and
// the products are slow on their own: fewer ldmatrix (K = 4 against 1:
// 11 %) and the fixed width (9-11 %) helped, more warps a scheduler (12
// or 16) did not.  The next steps are wgmma, with a producer warp taking
// the copies off the consumers, and TMA.  K = 4 ran 6-7 % faster than K
// = 2, and 16-row tiles 20 % slower.  At H = 1024
// every block streams the whole table for 32 own rows (26 GB from L2 at
// V = 50304); there 12 warps and K = 6 ran 7-11 % faster than 8 warps
// and K = 4.
// Each output element is summed by one block in a fixed order (no
// atomics), so two backward passes give bitwise-equal dx and dembed.
// ops/fused_ce_kernels states the tile plan for the CPU tests
// (`ce_bwd_plan`), and apex_ce_bwd_plan reports what the launches use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using apex_mma::bf16;
using apex_mma::cp_async16;
using apex_mma::cp_async4;
using apex_mma::cp_async_commit;
using apex_mma::cp_async_wait;
using apex_mma::ld_a;
using apex_mma::ld_b_kn;
using apex_mma::ld_b_nk;
using apex_mma::ld_b_nk1;
using apex_mma::mma16816;
using apex_mma::pack2;
using apex_mma::quad_max;
using apex_mma::quad_sum;

constexpr int kChunk = 64;          // rows and columns of a streamed chunk
constexpr int kLdC = kChunk + 8;    // row stride of a forward chunk buffer
constexpr int kMaxHidden = 1024;
constexpr int kTargetBlocks = 128;  // forward blocks aimed at (132 SMs, one block each)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
// The backward's tile plan: own rows a block, streamed rows a tile, K
// groups of the score product, warps a block.  BwdH768 serves H <= 768,
// BwdH1024 the widths above (32 own rows: 64 and two streamed tiles do
// not fit).
struct BwdH768 {
  static constexpr int kRows = 64;
  static constexpr int kStream = 32;
  static constexpr int kGroups = 4;
  static constexpr int kWarps = 8;
};
struct BwdH1024 {
  static constexpr int kRows = 32;
  static constexpr int kStream = 32;
  static constexpr int kGroups = 6;
  static constexpr int kWarps = 12;
};

// 8 values of src as bf16 (nearest even), in one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 bf16x8(const T* src) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
  } else {
    return *reinterpret_cast<const uint4*>(src);
  }
}

// dst[i] = bf16(src[i]) for n8 vectors of 8: the bf16 copy of an fp32
// streamed operand.
__global__ void __launch_bounds__(256)
ce_to_bf16(const float* __restrict__ src, bf16* __restrict__ dst, int64_t n8) {
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n8; i += (int64_t)gridDim.x * 256)
    reinterpret_cast<uint4*>(dst)[i] = bf16x8(src + 8 * i);
}

// acc[m][2i + j] += D[16m.., :SR] . Y[:SR, cols] for this warp's column
// groups n0 = 16 (warp + W i) < H (j: their two 8-column halves); D the
// staged d (16 MT x SR, stride SR + 8), Y the streamed tile (SR x H).
template <int MT, int NP, int SR, int W>
__device__ __forceinline__ void accumulate(float (&acc)[MT][2 * NP][4], const bf16* D,
                                           const bf16* Y, int ld, int H, int warp, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < SR; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ld_a(a[m], D, SR + 8, 16 * m, k0, lane);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n0 = 16 * (warp + W * i);
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

// Shared memory of a backward block: the own tile and two stages of the
// streamed one (row stride H + 8, bf16), d (bf16, row stride sr + 8),
// the row data (fp32 / int32 lse, g, t: of the own rows for dx, of two
// stages' streamed rows for dembed) and kg - 1 partials of s (fp32).
__host__ __device__ constexpr size_t bwd_smem(int H, int rows, int sr, int kg, bool dembed) {
  return ((size_t)(rows + 2 * sr) * (H + 8) + (size_t)rows * (sr + 8)) * sizeof(bf16) +
         (size_t)3 * (dembed ? 2 * sr : rows) * sizeof(float) +
         (size_t)(kg - 1) * rows * sr * sizeof(float);
}

// DEMBED false: own = x (N rows), streamed = embed (V rows), out = dx.
// DEMBED true: own = embed (V rows), streamed = x (N rows), out = dembed.
// d[own r][streamed c] = (exp(s - lse[n]) - (v == t[n])) * g[n], with n
// the x row and v the vocab row of the pair; 0 past N or V.  The streamed
// operand is bf16 (the wrapper's copy when the caller's is fp32).
//   Warps: KG groups of WG = W / KG, group q scoring k-steps [q KS / KG,
// (q + 1) KS / KG) of the KS = H / 16.  A warp's piece of s is MI x NJ
// fragment tiles (16 x 8 each); the pieces of a group tile the ROWS x SR
// block, WR down and WC across.  Fragment tile idx = i NJ + j of every
// piece is owned by group idx % KG.
template <typename TOWN, typename TOUT, int ROWS, int SR, int KG, int W, int NP, int HC,
          bool DEMBED>
__global__ void __launch_bounds__(32 * W, 1)
ce_bwd_kernel(const TOWN* __restrict__ own, const bf16* __restrict__ str,
              const int* __restrict__ tid, const float* __restrict__ lse,
              const float* __restrict__ gr, TOUT* __restrict__ out, int n_own, int n_str,
              int h) {
  constexpr int MT = ROWS / 16, LDD = SR + 8, WG = W / KG, kThreads = 32 * W;
  constexpr int E = ROWS * SR / WG;  // elements of s a warp holds
  constexpr int MI = E >= 512 && ROWS >= 32 ? 2 : 1, NJ = E / (128 * MI);
  constexpr int WR = ROWS / (16 * MI), WC = SR / (8 * NJ);
  static_assert(W % KG == 0 && E >= 128 && WR * WC == WG && (NJ == 1 || NJ % 2 == 0),
                "the warps' pieces must tile the s block");
  // HC > 0: the width is HC, known here, so the score loop unrolls and
  // every tile address folds to a constant offset
  constexpr int KSG = HC > 0 && HC / 16 % KG == 0 ? HC / 16 / KG : 0;  // k-steps a group
  extern __shared__ __align__(128) char smem[];
  const int H = HC > 0 ? HC : h, ld = H + 8, vpr = H / 8, KS = H / 16;
  bf16* sO = reinterpret_cast<bf16*>(smem);
  bf16* sR = sO + ROWS * ld;  // two stages of SR rows
  bf16* sD = sR + 2 * SR * ld;
  float* sRow = reinterpret_cast<float*>(sD + ROWS * LDD);
  float4* sP = reinterpret_cast<float4*>(sRow + 3 * (DEMBED ? 2 * SR : ROWS));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / WG, wig = warp % WG;
  const int wr = (wig / WC) * 16 * MI, wc = (wig % WC) * 8 * NJ;  // this warp's piece of s
  const int ks0 = grp * KS / KG, ks1 = (grp + 1) * KS / KG;
  const int64_t o0 = (int64_t)blockIdx.x * ROWS;
  const int orows = n_own - o0 < ROWS ? (int)(n_own - o0) : ROWS;
  const int n_tiles = (n_str + SR - 1) / SR;

  // streamed tile `it` (rows past n_str zero) and, for dembed, its rows'
  // lse, g, t into stage it & 1.  This thread copies vectors threadIdx.x,
  // + 32 W, ... of the tile: row tr, vector tc, then steps of dr rows and
  // dc vectors.
  const int tr = threadIdx.x / vpr, tc = threadIdx.x % vpr;
  const int dr = kThreads / vpr, dc = kThreads % vpr;
  auto issue = [&](int it) {
    const int s0 = it * SR, valid = min(SR, n_str - s0);
    bf16* dst = sR + (it & 1) * SR * ld;
    const bf16* src = str + (int64_t)s0 * H;
    for (int r = tr, c = tc; r < SR;) {
      const bool ok = r < valid;
      cp_async16(dst + r * ld + 8 * c, ok ? src + (int64_t)r * H + 8 * c : str, ok ? 16 : 0);
      r += dr, c += dc;
      if (c >= vpr) c -= vpr, ++r;
    }
    if (DEMBED && threadIdx.x < SR) {
      float* rd = sRow + (it & 1) * 3 * SR + threadIdx.x;
      const bool ok = (int)threadIdx.x < valid;
      const int n = ok ? s0 + threadIdx.x : 0;
      cp_async4(rd, lse + n, ok ? 4 : 0);
      cp_async4(rd + SR, gr + n, ok ? 4 : 0);
      cp_async4(rd + 2 * SR, tid + n, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  for (int c = threadIdx.x; c < ROWS * vpr; c += kThreads) {  // the own tile, as bf16
    const int r = c / vpr, col = (c % vpr) * 8;
    *reinterpret_cast<uint4*>(sO + r * ld + col) =
        r < orows ? bf16x8(own + (o0 + r) * H + col) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (!DEMBED && threadIdx.x < ROWS) {  // dx: the own rows' lse, g, t
    const int r = threadIdx.x;
    sRow[r] = r < orows ? lse[o0 + r] : 0.f;
    sRow[ROWS + r] = r < orows ? gr[o0 + r] : 0.f;
    reinterpret_cast<int*>(sRow)[2 * ROWS + r] = r < orows ? tid[o0 + r] : -1;
  }
  float acc[MT][2 * NP][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1, d and the partials
    if (it + 1 < n_tiles) issue(it + 1);
    const int s0 = it * SR;
    const bf16* Y = sR + (it & 1) * SR * ld;
    // this group's partial s over its slice of H
    float s[MI][NJ][4] = {};
    auto score_step = [&](int ks) {
      uint32_t b[NJ][2];
      if constexpr (NJ == 1) {
        ld_b_nk1(b[0], Y, ld, wc, 16 * ks, lane);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t b4[4];
          ld_b_nk(b4, Y, ld, wc + 8 * j, 16 * ks, lane);
          b[j][0] = b4[0], b[j][1] = b4[1], b[j + 1][0] = b4[2], b[j + 1][1] = b4[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a[4];
        ld_a(a, sO, ld, wr + 16 * i, 16 * ks, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma16816(s[i][j], a, b[j][0], b[j][1]);
      }
    };
    if constexpr (KSG > 0) {
#pragma unroll
      for (int kk = 0; kk < KSG; ++kk) score_step(ks0 + kk);
    } else {
#pragma unroll 2
      for (int ks = ks0; ks < ks1; ++ks) score_step(ks);
    }
    // partial slot of (writer group p, owner group o) for fragment tile idx of piece wig
    auto slot = [&](int p, int o, int idx) {
      return ((p - (p > o)) * WG * MI * NJ + wig * MI * NJ + idx) * 32 + lane;
    };
    if constexpr (KG > 1) {
#pragma unroll
      for (int idx = 0; idx < MI * NJ; ++idx)
        if (idx % KG != grp) {
          const float(&v)[4] = s[idx / NJ][idx % NJ];
          sP[slot(grp, idx % KG, idx)] = make_float4(v[0], v[1], v[2], v[3]);
        }
      __syncthreads();  // the partials written
    }
    // the owned tiles: s summed in group order, then d, staged as bf16
    constexpr int RN = DEMBED ? SR : ROWS;  // rows of the row data's lse, g, t
    const float* rd = DEMBED ? sRow + (it & 1) * 3 * SR : sRow;
    const int* rt = reinterpret_cast<const int*>(rd) + 2 * RN;
#pragma unroll
    for (int idx = 0; idx < MI * NJ; ++idx) {
      if (idx % KG != grp) continue;
      const int i = idx / NJ, j = idx % NJ;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < KG; ++p) {
        float w[4] = {s[i][j][0], s[i][j][1], s[i][j][2], s[i][j][3]};
        if (p != grp) {
          const float4 f = sP[slot(p, grp, idx)];
          w[0] = f.x, w[1] = f.y, w[2] = f.z, w[3] = f.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] += w[q];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + 16 * i + g + 8 * h, c = wc + 8 * j + 2 * t;
        float d[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = DEMBED ? c + q : r;                     // the pair's x row in rd
          const int64_t vr = DEMBED ? o0 + r : s0 + c + q;      // and its vocab row
          d[q] = 0.f;
          if (r < orows && s0 + c + q < n_str)
            d[q] = (exp2f(fmaf(v[2 * h + q], kLog2e, -rd[n] * kLog2e)) -
                    (vr == rt[n] ? 1.f : 0.f)) * rd[RN + n];
        }
        *reinterpret_cast<uint32_t*>(sD + r * LDD + c) = pack2(d[0], d[1]);
      }
    }
    __syncthreads();  // d staged
    accumulate<MT, NP, SR, W>(acc, sD, Y, ld, H, warp, lane);
  }
  TOUT* dst = out + o0 * H;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n0 = 16 * (warp + W * i);
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

// The backward's plan at width H, as launched: own rows, streamed rows a
// tile, K groups, warps.
struct BwdPlan {
  int rows, sr, kg, warps;
};
template <typename F>
BwdPlan plan_of() {
  return {F::kRows, F::kStream, F::kGroups, F::kWarps};
}
BwdPlan bwd_plan(int H) { return H > 768 ? plan_of<BwdH1024>() : plan_of<BwdH768>(); }

// F's kernel for widths up to MAXH (HC: the width, when fixed): each
// warp owns NP 16-column groups.
template <typename TOWN, typename TOUT, typename F, int MAXH, int HC, bool DEMBED>
cudaError_t bwd_t(const void* own, const bf16* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
  constexpr int NP = (MAXH / 16 + F::kWarps - 1) / F::kWarps;
  auto kernel = ce_bwd_kernel<TOWN, TOUT, F::kRows, F::kStream, F::kGroups, F::kWarps, NP, HC,
                              DEMBED>;
  const size_t smem = bwd_smem(p.H, F::kRows, F::kStream, F::kGroups, DEMBED);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_own + F::kRows - 1) / F::kRows, 32 * F::kWarps, smem, p.st>>>(
      (const TOWN*)own, str, p.t, lse, g, (TOUT*)out, n_own, n_str, p.H);
  return cudaGetLastError();
}

// The width's kernel: the widths of the repo's GPT configurations (768
// for GPT-124M, 1024 for GPT-345M) fixed at compile time, any other H
// a runtime argument.
template <typename TOWN, typename TOUT, bool DEMBED>
cudaError_t bwd_w(const void* own, const bf16* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
#define APEX_CE_BWD(F, MAXH, HC) \
  bwd_t<TOWN, TOUT, F, MAXH, HC, DEMBED>(own, str, p, lse, g, out, n_own, n_str)
  if (p.H == 768) return APEX_CE_BWD(BwdH768, 768, 768);
  if (p.H == 1024) return APEX_CE_BWD(BwdH1024, 1024, 1024);
  return p.H > 768 ? APEX_CE_BWD(BwdH1024, 1024, 0) : APEX_CE_BWD(BwdH768, 768, 0);
#undef APEX_CE_BWD
}

// The streamed operand as bf16: itself, or its copy in `scratch` (rows x
// H), converted here when it is fp32.
template <typename T>
cudaError_t streamed(const void* src, int64_t rows, int H, void* scratch, cudaStream_t st,
                     const bf16** out) {
  *out = (const bf16*)src;
  if constexpr (sizeof(T) == 4) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int64_t n8 = rows * H / 8;
    const int64_t want = (n8 + 255) / 256;
    const int blocks = want < 4096 ? (int)want : 4096;
    ce_to_bf16<<<blocks, 256, 0, st>>>((const float*)src, (bf16*)scratch, n8);
    *out = (const bf16*)scratch;
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// which: 1 = dx (own x, streamed embed), 2 = dembed (own embed, streamed x).
template <typename TX, typename TE>
cudaError_t bwd(int which, const Problem& p, const float* lse, const float* g, void* out,
                void* scratch) {
  const bf16* str;
  cudaError_t err = which == 1 ? streamed<TE>(p.e, p.V, p.H, scratch, p.st, &str)
                               : streamed<TX>(p.x, p.N, p.H, scratch, p.st, &str);
  if (err != cudaSuccess) return err;
  if (which == 1) return bwd_w<TX, TX, false>(p.x, str, p, lse, g, out, p.N, p.V);
  return bwd_w<TE, float, true>(p.e, str, p, lse, g, out, p.V, p.N);
}

bool bad_problem(const Problem& p, int x_dtype, int e_dtype) {
  return p.H <= 0 || p.H % 16 != 0 || p.H > kMaxHidden || p.N < 0 || p.V <= 0 || x_dtype < 0 ||
         x_dtype > 1 || e_dtype < 0 || e_dtype > 1;
}

// which: 0 = forward (o0..o3: m, l, tgt, part), 1 = dx, 2 = dembed (o0:
// the output, o1: the streamed operand's bf16 scratch or null).
// x_dtype, e_dtype: 0 = float32, 1 = bfloat16.
int dispatch(int which, const Problem& p, const float* lse, const float* g, void* o0,
             void* o1, void* o2, void* o3, int x_dtype, int e_dtype) {
  if (bad_problem(p, x_dtype, e_dtype)) return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  cudaError_t err;
#define APEX_CE_RUN(TX, TE)                                                        \
  err = which == 0 ? fwd<TX, TE>(p, (float*)o3, (float*)o0, (float*)o1, (float*)o2) \
                   : bwd<TX, TE>(which, p, lse, g, o0, o1)
  if (x_dtype == 1 && e_dtype == 0)
    APEX_CE_RUN(bf16, float);
  else if (x_dtype == 1)
    APEX_CE_RUN(bf16, bf16);
  else if (e_dtype == 0)
    APEX_CE_RUN(float, float);
  else
    APEX_CE_RUN(float, bf16);
#undef APEX_CE_RUN
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

// The backward's plan (which: 1 = dx, 2 = dembed) into out[7]: own rows
// a block, streamed rows a tile, K groups, warps a block, ring stages,
// shared memory bytes of a block, bytes of the streamed operand's bf16
// scratch (0 when it is bf16).
extern "C" int apex_ce_bwd_plan(int which, int N, int H, int V, int x_dtype, int e_dtype,
                                int64_t* out) {
  const Problem p = {nullptr, nullptr, nullptr, N, H, V, nullptr};
  if ((which != 1 && which != 2) || bad_problem(p, x_dtype, e_dtype))
    return (int)cudaErrorInvalidValue;
  const BwdPlan b = bwd_plan(H);
  const bool fp32_stream = (which == 1 ? e_dtype : x_dtype) == 0;
  out[0] = b.rows;
  out[1] = b.sr;
  out[2] = b.kg;
  out[3] = b.warps;
  out[4] = 2;
  out[5] = (int64_t)bwd_smem(H, b.rows, b.sr, b.kg, which == 2);
  out[6] = fp32_stream ? (int64_t)(which == 1 ? V : N) * H * (int64_t)sizeof(bf16) : 0;
  return 0;
}

// dx (N, H) in x's dtype.  scratch: (V, H) bf16 when the embed is fp32,
// else null.  Two launches when it is fp32: the conversion and dx.
extern "C" int apex_ce_dx(const void* x, const void* e, const void* t, const void* lse,
                          const void* g, void* dx, void* scratch, int N, int H, int V,
                          int x_dtype, int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(1, p, (const float*)lse, (const float*)g, dx, scratch, nullptr, nullptr,
                  x_dtype, e_dtype);
}

// dembed (V, H) fp32.  scratch: (N, H) bf16 when x is fp32, else null.
extern "C" int apex_ce_dembed(const void* x, const void* e, const void* t, const void* lse,
                              const void* g, void* de, void* scratch, int N, int H, int V,
                              int x_dtype, int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(2, p, (const float*)lse, (const float*)g, de, scratch, nullptr, nullptr,
                  x_dtype, e_dtype);
}
