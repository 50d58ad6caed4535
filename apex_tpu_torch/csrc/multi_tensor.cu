// Multi-tensor kernels of the optimizer engine: mt_adam, mt_scale,
// mt_l2norm and mt_adam_remainder (apex_tpu_torch/ops/multi_tensor.py
// holds their wrappers, plain versions and launch plans).
//
// What they replace.  No Pallas kernel: the JAX package writes its
// engine as tree math under one jit and XLA fuses it
// (apex_tpu/ops/multi_tensor.py, apex_tpu/optimizers/bucketing.py).
// mt_adam computes what the XLA fusion of the bucket update computes
// (apex_tpu/optimizers/fused_adam.py:163 `_bucket_update_packfree` and
// the packed path after it), mt_scale `multi_tensor_scale` with its
// finite vote (ops/multi_tensor.py:59), mt_l2norm `multi_tensor_l2norm`
// (ops/multi_tensor.py:90).  Apex's counterparts are
// csrc/multi_tensor_adam.cu, multi_tensor_scale_kernel.cu and
// multi_tensor_l2norm_kernel.cu over csrc/multi_tensor_apply.cuh.
//
// What bounds them: bytes.  Adam reads g, p, m, v and writes p, m, v:
// 28 bytes an fp32 element for about 20 flops, far below the card's
// ~20 flops a byte.  The design therefore reads every operand once,
// where it lies, in 16-byte vectors:
//
// - A table of pointers passed BY VALUE in the kernel's parameters (at
//   most 4 KB, the limit of every CUDA 12 toolkit), as apex's
//   TensorListMetadata: a leaf enters as its own pointer, a leaf of a
//   resident bucket as base + offset, so nothing is packed.  A call of
//   T tensors is ceil(T / capacity) launches (fewer when a group has no
//   element).  Under CUDA-graph capture each launch bakes in the
//   pointers of that replay's buffers; nothing is copied from the host.
// - Blocks walk chunks of kChunk elements; a block finds its tensor by a
//   binary search of the table's cumulative chunk counts, so one launch
//   covers many small leaves and a large leaf many blocks.
// - 16-byte vectors where every pointer of a tensor allows them (4
//   elements), scalar accesses otherwise: a leaf inside a bucket may
//   start at any element offset.
//
// mt_adam_remainder is the ZeRO shard update with store_param_remainders
// (apex's multi_tensor_distopt_adam with remainders; the JAX package's
// XLA fusion of _master_from_remainder, adam_math and _split_master,
// apex_tpu/contrib/optimizers/distributed_fused_adam.py:67-95 and :200).
// It reads the bf16 param shard and its uint16 remainder and rebuilds the
// fp32 master bit-exactly as (bits << 16) | rem, applies the Adam step of
// mt_adam, and writes the master's high 16 bits as the bf16 param and the
// low 16 as the remainder: truncation, the JAX package's convention.
// Bytes bound it too: 2+2 read and 2+2 written a param element against
// Adam's fp32 master's 4+4, beside g, m and v.
//
// Numerics.  mt_adam and mt_scale are bitwise equal to their plain
// PyTorch versions (and so to the JAX package): each operation is
// written with the __f*_rn intrinsics, which nvcc never contracts into
// an FMA, in the association of apex_tpu's adam_core/adam_math; the
// constants (1 - beta, eps, wd, a float lr) are rounded once on the host
// from doubles.  bc1, bc2, the commit predicate, the clip coefficient
// and a tensor lr are read from device memory (the capturable design):
// a false predicate writes the old values, so nothing of the state
// changes.  mt_l2norm sums squares in fp32 in a fixed order, with no
// atomics: per-chunk partials to scratch, then each leaf's partials in
// chunk order, then the leaves in leaf order; two calls agree bitwise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;     // elements a block
constexpr int kTableBytes = 4096;  // kernel parameters before CUDA 12.1

enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float from16(unsigned short bits, int dt) {
  return dt == kBF16 ? __uint_as_float(((unsigned)bits) << 16)
                     : __half2float(__ushort_as_half(bits));
}

__device__ __forceinline__ unsigned short to16(float x, int dt) {
  return dt == kBF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(x))
                     : __half_as_ushort(__float2half_rn(x));
}

__device__ __forceinline__ float ld1(const void* p, long long i, int dt) {
  if (dt == kF32) return static_cast<const float*>(p)[i];
  return from16(static_cast<const unsigned short*>(p)[i], dt);
}

// stores x in dt; returns the value stored, as a float
__device__ __forceinline__ float st1(void* p, long long i, int dt, float x) {
  if (dt == kF32) {
    static_cast<float*>(p)[i] = x;
    return x;
  }
  unsigned short b = to16(x, dt);
  static_cast<unsigned short*>(p)[i] = b;
  return from16(b, dt);
}

// 4 elements at i (a multiple of 4; p aligned to 4 elements)
__device__ __forceinline__ void ld4(const void* p, long long i, int dt, float (&x)[4]) {
  if (dt == kF32) {
    float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    uint2 v = *reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(p) + i);
    x[0] = from16(v.x & 0xFFFF, dt); x[1] = from16(v.x >> 16, dt);
    x[2] = from16(v.y & 0xFFFF, dt); x[3] = from16(v.y >> 16, dt);
  }
}

__device__ __forceinline__ void st4(void* p, long long i, int dt, const float (&x)[4],
                                    float (&stored)[4]) {
  if (dt == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(x[0], x[1], x[2], x[3]);
    for (int k = 0; k < 4; ++k) stored[k] = x[k];
  } else {
    unsigned short b[4];
    for (int k = 0; k < 4; ++k) {
      b[k] = to16(x[k], dt);
      stored[k] = from16(b[k], dt);
    }
    uint2 v;
    v.x = (unsigned)b[0] | ((unsigned)b[1] << 16);
    v.y = (unsigned)b[2] | ((unsigned)b[3] << 16);
    *reinterpret_cast<uint2*>(static_cast<unsigned short*>(p) + i) = v;
  }
}

// The tensor that owns block b: the largest i with start[i] <= b (a
// tensor of no chunks shares its start with the next one).
__device__ __forceinline__ int find_tensor(const int* start, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__host__ __device__ constexpr long long chunks_of(long long n) {
  return (n + kChunk - 1) / kChunk;
}

// ------------------------------------------------------------- mt_adam
constexpr int kAdamOps = 8;  // g, p, m, v, p_out, m_out, v_out, master_out
constexpr int kLrPtr = 1, kAligned = 2;

struct AdamHead {
  const float* bc1;
  const float* bc2;
  const unsigned char* pred;  // commit predicate (bool) or null
  const float* coef;          // clip coefficient or null
  const float* lr;            // tensor lr or null
  float beta1, omb1, beta2, omb2, eps;
  int adam_w_mode, n;
};

constexpr int kAdamBytesPerTensor = kAdamOps * 8 + 8 + 4 + 4 + 4 + 4;
constexpr int kAdamTensors =
    (kTableBytes - (int)sizeof(AdamHead) - 4 - 8) / kAdamBytesPerTensor;

struct AdamTable {
  AdamHead h;
  void* ptr[kAdamOps][kAdamTensors];
  long long n[kAdamTensors];
  int start[kAdamTensors + 1];  // cumulative chunks
  float lr[kAdamTensors];       // the lr, or with kLrPtr its scale
  float wd[kAdamTensors];
  unsigned char g_dt[kAdamTensors], p_dt[kAdamTensors], o_dt[kAdamTensors],
      flags[kAdamTensors];
};
static_assert(sizeof(AdamTable) <= kTableBytes, "mt_adam table over 4 KB");

struct AdamConsts {
  float b1, omb1, b2, omb2, eps, bc1, bc2, lr, wd, coef;
  bool adam_w, clip, keep;
};

__device__ __forceinline__ void adam_one(const AdamConsts& c, float g, float p, float m,
                                         float v, float& p_new, float& m_new, float& v_new) {
  if (c.clip) g = __fmul_rn(g, c.coef);
  if (!c.adam_w) g = __fadd_rn(g, __fmul_rn(c.wd, p));
  m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v_new = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  float core = __fdiv_rn(__fdiv_rn(m_new, c.bc1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, c.bc2)), c.eps));
  float upd = c.adam_w ? __fadd_rn(core, __fmul_rn(c.wd, p)) : core;
  p_new = __fsub_rn(p, __fmul_rn(c.lr, upd));
  if (c.keep) {
    p_new = p;
    m_new = m;
    v_new = v;
  }
}

__global__ void __launch_bounds__(kThreads) mt_adam_kernel(AdamTable t) {
  const int i = find_tensor(t.start, t.h.n, blockIdx.x);
  const long long n = t.n[i];
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(n, lo + kChunk);
  AdamConsts c;
  c.b1 = t.h.beta1; c.omb1 = t.h.omb1; c.b2 = t.h.beta2; c.omb2 = t.h.omb2; c.eps = t.h.eps;
  c.bc1 = *t.h.bc1; c.bc2 = *t.h.bc2;
  c.lr = (t.flags[i] & kLrPtr) ? __fmul_rn(*t.h.lr, t.lr[i]) : t.lr[i];
  c.wd = t.wd[i];
  c.clip = t.h.coef != nullptr;
  c.coef = c.clip ? *t.h.coef : 1.f;
  c.adam_w = t.h.adam_w_mode != 0;
  c.keep = t.h.pred != nullptr && t.h.pred[0] == 0;
  const void* g = t.ptr[0][i];
  const void* p = t.ptr[1][i];
  const float* m = static_cast<const float*>(t.ptr[2][i]);
  const float* v = static_cast<const float*>(t.ptr[3][i]);
  void* po = t.ptr[4][i];
  float* mo = static_cast<float*>(t.ptr[5][i]);
  float* vo = static_cast<float*>(t.ptr[6][i]);
  float* wo = static_cast<float*>(t.ptr[7][i]);  // the fp32 master, or null
  const int gdt = t.g_dt[i], pdt = t.p_dt[i], odt = t.o_dt[i];
  long long e = lo;
  if (t.flags[i] & kAligned) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (e = lo + 4 * threadIdx.x; e < vec_hi; e += 4 * kThreads) {
      float gx[4], px[4], mx[4], vx[4], pn[4], mn[4], vn[4], stored[4];
      ld4(g, e, gdt, gx);
      ld4(p, e, pdt, px);
      ld4(m, e, kF32, mx);
      ld4(v, e, kF32, vx);
      for (int k = 0; k < 4; ++k) adam_one(c, gx[k], px[k], mx[k], vx[k], pn[k], mn[k], vn[k]);
      st4(po, e, odt, pn, stored);
      st4(mo, e, kF32, mn, stored);
      st4(vo, e, kF32, vn, stored);
      if (wo) st4(wo, e, kF32, pn, stored);
    }
    e = vec_hi;
  }
  for (long long j = e + threadIdx.x; j < hi; j += kThreads) {
    float pn, mn, vn;
    adam_one(c, ld1(g, j, gdt), ld1(p, j, pdt), m[j], v[j], pn, mn, vn);
    st1(po, j, odt, pn);
    mo[j] = mn;
    vo[j] = vn;
    if (wo) wo[j] = pn;
  }
}

// ------------------------------------------------------------ mt_scale
struct ScaleHead {
  const float* mult_ptr;  // a tensor multiplier, or null for `mult`
  int* flag;              // set to 1 where an output is not finite
  float mult;
  int n;
};

constexpr int kScaleBytesPerTensor = 2 * 8 + 8 + 4 + 4;
constexpr int kScaleTensors =
    (kTableBytes - (int)sizeof(ScaleHead) - 4 - 8) / kScaleBytesPerTensor;

struct ScaleTable {
  ScaleHead h;
  const void* src[kScaleTensors];
  void* out[kScaleTensors];
  long long n[kScaleTensors];
  int start[kScaleTensors + 1];
  unsigned char s_dt[kScaleTensors], o_dt[kScaleTensors], flags[kScaleTensors],
      pad_[kScaleTensors];
};
static_assert(sizeof(ScaleTable) <= kTableBytes, "mt_scale table over 4 KB");

__global__ void __launch_bounds__(kThreads) mt_scale_kernel(ScaleTable t) {
  const int i = find_tensor(t.start, t.h.n, blockIdx.x);
  const long long n = t.n[i];
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(n, lo + kChunk);
  const float mult = t.h.mult_ptr ? *t.h.mult_ptr : t.h.mult;
  const void* s = t.src[i];
  void* o = t.out[i];
  const int sdt = t.s_dt[i], odt = t.o_dt[i];
  bool bad = false;
  long long e = lo;
  if (t.flags[i] & kAligned) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (e = lo + 4 * threadIdx.x; e < vec_hi; e += 4 * kThreads) {
      float x[4], y[4], stored[4];
      ld4(s, e, sdt, x);
      for (int k = 0; k < 4; ++k) y[k] = __fmul_rn(x[k], mult);
      st4(o, e, odt, y, stored);
      for (int k = 0; k < 4; ++k) bad |= !isfinite(stored[k]);
    }
    e = vec_hi;
  }
  for (long long j = e + threadIdx.x; j < hi; j += kThreads)
    bad |= !isfinite(st1(o, j, odt, __fmul_rn(ld1(s, j, sdt), mult)));
  if (bad) *t.h.flag = 1;  // every writer stores the same value
}

// ----------------------------------------------------------- mt_l2norm
struct NormHead {
  float* partial;    // one fp32 partial a chunk, for every chunk of the call
  float* leaf_out;   // Σx² a leaf, for every leaf of the call
  float* total_out;  // Σx² of the call
  int n, chunk_base, leaf_base, n_leaves, last;
};

constexpr int kNormBytesPerTensor = 8 + 8 + 4 + 1 + 1;
constexpr int kNormTensors =
    (kTableBytes - (int)sizeof(NormHead) - 4 - 8) / kNormBytesPerTensor;

struct NormTable {
  NormHead h;
  const void* src[kNormTensors];
  long long n[kNormTensors];
  int start[kNormTensors + 1];
  unsigned char dt[kNormTensors], flags[kNormTensors];
};
static_assert(sizeof(NormTable) <= kTableBytes, "mt_l2norm table over 4 KB");
static_assert(kNormTensors <= kThreads, "stage 2 gives a thread to each leaf");

__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[w] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < kThreads / 32; ++k) s = __fadd_rn(s, warp_sums[k]);
  return s;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads) mt_l2norm_partial(NormTable t) {
  const int i = find_tensor(t.start, t.h.n, blockIdx.x);
  const long long n = t.n[i];
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(n, lo + kChunk);
  const void* s = t.src[i];
  const int dt = t.dt[i];
  float acc = 0.f;
  long long e = lo;
  if (t.flags[i] & kAligned) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (e = lo + 4 * threadIdx.x; e < vec_hi; e += 4 * kThreads) {
      float x[4];
      ld4(s, e, dt, x);
      for (int k = 0; k < 4; ++k) acc = __fmaf_rn(x[k], x[k], acc);
    }
    e = vec_hi;
  }
  for (long long j = e + threadIdx.x; j < hi; j += kThreads) {
    float x = ld1(s, j, dt);
    acc = __fmaf_rn(x, x, acc);
  }
  const float sum = block_sum(acc);
  if (threadIdx.x == 0) t.h.partial[t.h.chunk_base + blockIdx.x] = sum;
}

__global__ void __launch_bounds__(kThreads) mt_l2norm_leaves(NormTable t) {
  const int i = threadIdx.x;
  if (i < t.h.n) {
    float s = 0.f;
    for (int c = t.start[i]; c < t.start[i + 1]; ++c)
      s = __fadd_rn(s, t.h.partial[t.h.chunk_base + c]);
    t.h.leaf_out[t.h.leaf_base + i] = s;
  }
  if (!t.h.last) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int k = 0; k < t.h.n_leaves; ++k) total = __fadd_rn(total, t.h.leaf_out[k]);
    *t.h.total_out = total;
  }
}


// --------------------------------------------------- mt_adam_remainder
constexpr int kRemOps = 9;  // g, p, rem, m, v, p_out, rem_out, m_out, v_out
constexpr int kRemBytesPerTensor = kRemOps * 8 + 8 + 4 + 4 + 4 + 2;
constexpr int kRemTensors =
    (kTableBytes - (int)sizeof(AdamHead) - 4 - 8) / kRemBytesPerTensor;

struct RemTable {
  AdamHead h;
  void* ptr[kRemOps][kRemTensors];
  long long n[kRemTensors];
  int start[kRemTensors + 1];
  float lr[kRemTensors];
  float wd[kRemTensors];
  unsigned char g_dt[kRemTensors], flags[kRemTensors];
};
static_assert(sizeof(RemTable) <= kTableBytes, "mt_adam_remainder table over 4 KB");

__device__ __forceinline__ float rem_master(unsigned short p, unsigned short r) {
  return __uint_as_float((((unsigned)p) << 16) | (unsigned)r);
}

__global__ void __launch_bounds__(kThreads) mt_adam_remainder_kernel(RemTable t) {
  const int i = find_tensor(t.start, t.h.n, blockIdx.x);
  const long long n = t.n[i];
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(n, lo + kChunk);
  AdamConsts c;
  c.b1 = t.h.beta1; c.omb1 = t.h.omb1; c.b2 = t.h.beta2; c.omb2 = t.h.omb2; c.eps = t.h.eps;
  c.bc1 = *t.h.bc1; c.bc2 = *t.h.bc2;
  c.lr = (t.flags[i] & kLrPtr) ? __fmul_rn(*t.h.lr, t.lr[i]) : t.lr[i];
  c.wd = t.wd[i];
  c.clip = t.h.coef != nullptr;
  c.coef = c.clip ? *t.h.coef : 1.f;
  c.adam_w = t.h.adam_w_mode != 0;
  c.keep = t.h.pred != nullptr && t.h.pred[0] == 0;
  const void* g = t.ptr[0][i];
  const unsigned short* p = static_cast<const unsigned short*>(t.ptr[1][i]);
  const unsigned short* r = static_cast<const unsigned short*>(t.ptr[2][i]);
  const float* m = static_cast<const float*>(t.ptr[3][i]);
  const float* v = static_cast<const float*>(t.ptr[4][i]);
  unsigned short* po = static_cast<unsigned short*>(t.ptr[5][i]);
  unsigned short* ro = static_cast<unsigned short*>(t.ptr[6][i]);
  float* mo = static_cast<float*>(t.ptr[7][i]);
  float* vo = static_cast<float*>(t.ptr[8][i]);
  const int gdt = t.g_dt[i];
  long long e = lo;
  if (t.flags[i] & kAligned) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (e = lo + 4 * threadIdx.x; e < vec_hi; e += 4 * kThreads) {
      float gx[4], mx[4], vx[4], pn[4], mn[4], vn[4], stored[4];
      ld4(g, e, gdt, gx);
      ld4(m, e, kF32, mx);
      ld4(v, e, kF32, vx);
      const uint2 pv = *reinterpret_cast<const uint2*>(p + e);
      const uint2 rv = *reinterpret_cast<const uint2*>(r + e);
      const unsigned short pb[4] = {(unsigned short)(pv.x & 0xFFFF), (unsigned short)(pv.x >> 16),
                                    (unsigned short)(pv.y & 0xFFFF), (unsigned short)(pv.y >> 16)};
      const unsigned short rb[4] = {(unsigned short)(rv.x & 0xFFFF), (unsigned short)(rv.x >> 16),
                                    (unsigned short)(rv.y & 0xFFFF), (unsigned short)(rv.y >> 16)};
      unsigned hb[4], lb[4];
      for (int k = 0; k < 4; ++k) {
        adam_one(c, gx[k], rem_master(pb[k], rb[k]), mx[k], vx[k], pn[k], mn[k], vn[k]);
        const unsigned bits = __float_as_uint(pn[k]);
        hb[k] = bits >> 16;
        lb[k] = bits & 0xFFFFu;
      }
      *reinterpret_cast<uint2*>(po + e) = make_uint2(hb[0] | (hb[1] << 16), hb[2] | (hb[3] << 16));
      *reinterpret_cast<uint2*>(ro + e) = make_uint2(lb[0] | (lb[1] << 16), lb[2] | (lb[3] << 16));
      st4(mo, e, kF32, mn, stored);
      st4(vo, e, kF32, vn, stored);
    }
    e = vec_hi;
  }
  for (long long j = e + threadIdx.x; j < hi; j += kThreads) {
    float pn, mn, vn;
    adam_one(c, ld1(g, j, gdt), rem_master(p[j], r[j]), m[j], v[j], pn, mn, vn);
    const unsigned bits = __float_as_uint(pn);
    po[j] = (unsigned short)(bits >> 16);
    ro[j] = (unsigned short)(bits & 0xFFFFu);
    mo[j] = mn;
    vo[j] = vn;
  }
}

// --------------------------------------------------------------- host
int elem_size(int dt) { return dt == kF32 ? 4 : 2; }

bool aligned(const void* p, int dt) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % (4 * elem_size(dt)) == 0;
}

// Fill start[0..count] with the cumulative chunks of n[first..first+count)
// and return the group's chunks.
long long fill_starts(const long long* n, int first, int count, int* start) {
  long long c = 0;
  for (int k = 0; k < count; ++k) {
    start[k] = (int)c;
    c += chunks_of(n[first + k]);
  }
  start[count] = (int)c;
  return c;
}

int capacity(int kind) {
  return kind == 0 ? kAdamTensors : kind == 1 ? kScaleTensors
       : kind == 2 ? kNormTensors : kRemTensors;
}

}  // namespace

// The launch plan of a call of `T` tensors of `n` elements by kernel
// `kind` (0 mt_adam, 1 mt_scale, 2 mt_l2norm, 3 mt_adam_remainder).  out (int64 x 6):
// capacity a launch, elements a chunk, threads a block, launches, total
// chunks, table bytes.  For mt_l2norm launches counts both stages.
extern "C" int apex_mt_plan(int kind, const long long* n, int T, long long* out) {
  const int cap = capacity(kind);
  long long launches = 0, chunks = 0;
  for (int first = 0; first < T; first += cap) {
    const int count = T - first < cap ? T - first : cap;
    long long c = 0;
    for (int k = 0; k < count; ++k) c += chunks_of(n[first + k]);
    chunks += c;
    launches += (c > 0) + (kind == 2);
  }
  out[0] = cap;
  out[1] = kChunk;
  out[2] = kThreads;
  out[3] = launches;
  out[4] = chunks;
  out[5] = kind == 0 ? sizeof(AdamTable) : kind == 1 ? sizeof(ScaleTable)
         : kind == 2 ? sizeof(NormTable) : sizeof(RemTable);
  return 0;
}

// ptrs: 8 x T (op-major: g, p, m, v, p_out, m_out, v_out, master_out);
// codes: 4 x T (g dtype, p dtype, p_out dtype, 1 = lr from lr_ptr).
extern "C" int apex_mt_adam(const void* const* ptrs, const long long* n, const float* lr,
                            const float* wd, const unsigned char* codes, int T,
                            const void* bc1, const void* bc2, const void* pred,
                            const void* coef, const void* lr_ptr, float beta1, float omb1,
                            float beta2, float omb2, float eps, int adam_w_mode,
                            void* stream, int* launches) {
  *launches = 0;
  AdamTable t;
  t.h.bc1 = static_cast<const float*>(bc1);
  t.h.bc2 = static_cast<const float*>(bc2);
  t.h.pred = static_cast<const unsigned char*>(pred);
  t.h.coef = static_cast<const float*>(coef);
  t.h.lr = static_cast<const float*>(lr_ptr);
  t.h.beta1 = beta1; t.h.omb1 = omb1; t.h.beta2 = beta2; t.h.omb2 = omb2; t.h.eps = eps;
  t.h.adam_w_mode = adam_w_mode;
  for (int first = 0; first < T; first += kAdamTensors) {
    const int count = T - first < kAdamTensors ? T - first : kAdamTensors;
    t.h.n = count;
    for (int k = 0; k < count; ++k) {
      const int i = first + k;
      bool al = true;
      for (int op = 0; op < kAdamOps; ++op) {
        void* p = const_cast<void*>(ptrs[op * T + i]);
        t.ptr[op][k] = p;
        const int dt = op == 0 ? codes[i] : op == 1 ? codes[T + i] : op == 4 ? codes[2 * T + i]
                                                                            : kF32;
        al = al && aligned(p, dt);
      }
      t.n[k] = n[i];
      t.lr[k] = lr[i];
      t.wd[k] = wd[i];
      t.g_dt[k] = codes[i];
      t.p_dt[k] = codes[T + i];
      t.o_dt[k] = codes[2 * T + i];
      t.flags[k] = (codes[3 * T + i] ? kLrPtr : 0) | (al ? kAligned : 0);
    }
    const long long chunks = fill_starts(n, first, count, t.start);
    if (chunks == 0) continue;
    mt_adam_kernel<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(t);
    ++*launches;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// codes: 2 x T (src dtype, out dtype).  flag: int32, zeroed by the
// caller; mult_ptr: a float32 tensor multiplier or null for `mult`.
extern "C" int apex_mt_scale(const void* const* src, void* const* out, const long long* n,
                             const unsigned char* codes, int T, const void* mult_ptr,
                             float mult, void* flag, void* stream, int* launches) {
  *launches = 0;
  ScaleTable t;
  t.h.mult_ptr = static_cast<const float*>(mult_ptr);
  t.h.flag = static_cast<int*>(flag);
  t.h.mult = mult;
  for (int first = 0; first < T; first += kScaleTensors) {
    const int count = T - first < kScaleTensors ? T - first : kScaleTensors;
    t.h.n = count;
    for (int k = 0; k < count; ++k) {
      const int i = first + k;
      t.src[k] = src[i];
      t.out[k] = out[i];
      t.n[k] = n[i];
      t.s_dt[k] = codes[i];
      t.o_dt[k] = codes[T + i];
      t.flags[k] = (aligned(src[i], codes[i]) && aligned(out[i], codes[T + i])) ? kAligned : 0;
    }
    const long long chunks = fill_starts(n, first, count, t.start);
    if (chunks == 0) continue;
    mt_scale_kernel<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(t);
    ++*launches;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// partial: fp32 scratch of the call's total chunks (apex_mt_plan out[4]);
// leaf_out: fp32 x T; total_out: fp32 x 1.
extern "C" int apex_mt_l2norm(const void* const* src, const long long* n,
                              const unsigned char* codes, int T, void* partial, void* leaf_out,
                              void* total_out, void* stream, int* launches) {
  *launches = 0;
  NormTable t;
  t.h.partial = static_cast<float*>(partial);
  t.h.leaf_out = static_cast<float*>(leaf_out);
  t.h.total_out = static_cast<float*>(total_out);
  t.h.n_leaves = T;
  long long chunk_base = 0;
  for (int first = 0; first < T; first += kNormTensors) {
    const int count = T - first < kNormTensors ? T - first : kNormTensors;
    t.h.n = count;
    t.h.chunk_base = (int)chunk_base;
    t.h.leaf_base = first;
    t.h.last = first + count >= T;
    for (int k = 0; k < count; ++k) {
      const int i = first + k;
      t.src[k] = src[i];
      t.n[k] = n[i];
      t.dt[k] = codes[i];
      t.flags[k] = aligned(src[i], codes[i]) ? kAligned : 0;
    }
    const long long chunks = fill_starts(n, first, count, t.start);
    if (chunks > 0) {
      mt_l2norm_partial<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(t);
      ++*launches;
    }
    mt_l2norm_leaves<<<1, kThreads, 0, (cudaStream_t)stream>>>(t);
    ++*launches;
    chunk_base += chunks;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ptrs: 9 x T (op-major: g, p, rem, m, v, p_out, rem_out, m_out, v_out;
// p and p_out bf16, rem and rem_out uint16, the rest fp32 but g, whose
// dtype is codes[i]); codes: 2 x T (g dtype, 1 = lr from lr_ptr).
extern "C" int apex_mt_adam_remainder(const void* const* ptrs, const long long* n,
                                      const float* lr, const float* wd,
                                      const unsigned char* codes, int T, const void* bc1,
                                      const void* bc2, const void* pred, const void* coef,
                                      const void* lr_ptr, float beta1, float omb1, float beta2,
                                      float omb2, float eps, int adam_w_mode, void* stream,
                                      int* launches) {
  *launches = 0;
  RemTable t;
  t.h.bc1 = static_cast<const float*>(bc1);
  t.h.bc2 = static_cast<const float*>(bc2);
  t.h.pred = static_cast<const unsigned char*>(pred);
  t.h.coef = static_cast<const float*>(coef);
  t.h.lr = static_cast<const float*>(lr_ptr);
  t.h.beta1 = beta1; t.h.omb1 = omb1; t.h.beta2 = beta2; t.h.omb2 = omb2; t.h.eps = eps;
  t.h.adam_w_mode = adam_w_mode;
  for (int first = 0; first < T; first += kRemTensors) {
    const int count = T - first < kRemTensors ? T - first : kRemTensors;
    t.h.n = count;
    for (int k = 0; k < count; ++k) {
      const int i = first + k;
      bool al = true;
      for (int op = 0; op < kRemOps; ++op) {
        void* p = const_cast<void*>(ptrs[op * T + i]);
        t.ptr[op][k] = p;
        const int dt = op == 0 ? codes[i] : (op == 1 || op == 2 || op == 5 || op == 6) ? kBF16
                                                                                       : kF32;
        al = al && aligned(p, dt);
      }
      t.n[k] = n[i];
      t.lr[k] = lr[i];
      t.wd[k] = wd[i];
      t.g_dt[k] = codes[i];
      t.flags[k] = (codes[T + i] ? kLrPtr : 0) | (al ? kAligned : 0);
    }
    const long long chunks = fill_starts(n, first, count, t.start);
    if (chunks == 0) continue;
    mt_adam_remainder_kernel<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(t);
    ++*launches;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
