// adamw.cu — the optimizer step as two hand-written multi-tensor passes for
// Hopper (sm_90a), with a plain C interface (loaded through ctypes by
// kernels/_build.py; wrapper kernels/adamw.py).
//
// Replaces no TPU kernel: the JAX package's AdamW and clipping
// (repro/optim/adamw.py) are plain jnp code that XLA fuses. The port's
// eager loop made about 22 float32 passes a leaf, and clipping wrote a
// scaled copy of every gradient: about 184 bytes a parameter. These kernels
// take its place on CUDA tensors.
//
//   * strela_sq_norm: the global sum of squares of the gradients. One pass
//     (sq_norm_kernel) reads each gradient once, as 16-byte vectors with a
//     scalar tail, and writes one double partial per chunk of a leaf; one
//     block (sum_partials_kernel) then sums the partials in a fixed order
//     into a float32 total on the device. No atomics: the same gradients
//     give the same total, bit for bit, on every run.
//   * strela_adamw: AdamW over (g, p, m, v) of every leaf, in place, with
//     the clipping scale applied as g is read (adamw_kernel). It reads the
//     learning rate, the bias corrections and the scale through device
//     pointers (0-d float32 tensors), so nothing comes back to the host.
//
// Bound on the H100: bytes. A bf16 parameter costs the update 2 + 2 + 4 + 4
// bytes read and 2 + 4 + 4 written (22), and the norm 2 read: at minicpm-2b
// (2.73e9 parameters) 59.95 GB, 17.9 ms, and 5.45 GB, 1.6 ms, at 3.35 TB/s.
// So each thread moves 16-byte words (8 elements), a few blocks stay on
// every SM, and the leaves' pointers travel in the launch's parameters, in
// batches of kAdamLeaves (kNormLeaves), which the blocks walk as a list of
// (leaf, chunk) work items: some ten launches for 362 leaves where the
// eager loop made about 10,500.
//
// Arithmetic: the eager loop's, in its order, each operation rounded once
// (never a fused multiply-add). With g' = g * scale rounded to g's dtype
// (as clipping's scaled copy was) and then read as float32:
//   m = b1 * m + c1 * g'                 (c1 = 1 - b1 in double, to float)
//   v = b2 * v + (c2 * g') * g'          (c2 = 1 - b2)
//   s = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
//   p = round_to_p_dtype(p - lr * s)
// so given the same scale the moments and parameters equal the plain
// loop's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                     // elements a thread a step
constexpr long long kAdamChunk = 16384;     // elements of one work item
constexpr long long kNormChunk = 65536;
constexpr int kAdamLeaves = 64;             // leaves a launch (4 KB params)
constexpr int kNormLeaves = 128;
constexpr int kBFloat16 = 1;                // the wrapper's dtype code

struct AdamBatch {
  const void* g[kAdamLeaves];
  void* p[kAdamLeaves];
  float* m[kAdamLeaves];
  float* v[kAdamLeaves];
  long long n[kAdamLeaves];
  int chunk0[kAdamLeaves + 1];              // first work item of each leaf
  unsigned char bf16[kAdamLeaves];
  unsigned char vec[kAdamLeaves];           // all four 16-byte aligned
  int leaves;
};

struct Hyper {
  const float* lr;
  const float* b1c;
  const float* b2c;
  const float* scale;                       // null: 1
  float b1, c1, b2, c2, eps, wd;
};

struct NormBatch {
  const void* g[kNormLeaves];
  long long n[kNormLeaves];
  int chunk0[kNormLeaves + 1];
  unsigned char bf16[kNormLeaves];
  unsigned char vec[kNormLeaves];
  int leaves;
  long long partial0;                       // this batch's first partial
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// 8 elements at a 16-byte aligned address, as float
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* out) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* in) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(in[2 * i]),
                              __float2bfloat16_rn(in[2 * i + 1]));
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store8(float* dst, const float* in) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

struct Step {
  float lr, b1c, b2c, scale;
  bool scaled;
  float b1, c1, b2, c2, eps, wd;
};

template <typename T>
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, const Step& h) {
  if (h.scaled) g = to_float(from_float<T>(__fmul_rn(g, h.scale)));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  float s = __fdiv_rn(__fdiv_rn(m, h.b1c),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  s = __fadd_rn(s, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, s));
}

// elements [lo, hi) of one leaf; lo is a multiple of kVec
template <typename T>
__device__ __forceinline__ void adamw_range(const T* g, T* p, float* m,
                                            float* v, long long lo,
                                            long long hi, bool vec,
                                            const Step& h) {
  long long tail = lo;
  if (vec) {
    tail = lo + ((hi - lo) & ~static_cast<long long>(kVec - 1));
    for (long long i = lo + threadIdx.x * kVec; i < tail;
         i += kThreads * kVec) {
      float gf[kVec], pf[kVec], mf[kVec], vf[kVec];
      load8(g + i, gf);
      load8(p + i, pf);
      load8(m + i, mf);
      load8(v + i, vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        adamw_elem<T>(gf[k], pf[k], mf[k], vf[k], h);
      store8(p + i, pf);
      store8(m + i, mf);
      store8(v + i, vf);
    }
  }
  for (long long i = tail + threadIdx.x; i < hi; i += kThreads) {
    float pf = to_float(p[i]), mf = m[i], vf = v[i];
    adamw_elem<T>(to_float(g[i]), pf, mf, vf, h);
    p[i] = from_float<T>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const AdamBatch b, const Hyper hy) {
  Step h;
  h.lr = *hy.lr;
  h.b1c = *hy.b1c;
  h.b2c = *hy.b2c;
  h.scaled = hy.scale != nullptr;
  h.scale = h.scaled ? *hy.scale : 1.f;
  h.b1 = hy.b1; h.c1 = hy.c1; h.b2 = hy.b2; h.c2 = hy.c2;
  h.eps = hy.eps; h.wd = hy.wd;
  const int items = b.chunk0[b.leaves];
  int leaf = 0;
  for (int c = blockIdx.x; c < items; c += gridDim.x) {
    while (c >= b.chunk0[leaf + 1]) ++leaf;
    const long long lo = (c - b.chunk0[leaf]) * kAdamChunk;
    const long long hi = min(lo + kAdamChunk, b.n[leaf]);
    if (b.bf16[leaf])
      adamw_range(static_cast<const __nv_bfloat16*>(b.g[leaf]),
                  static_cast<__nv_bfloat16*>(b.p[leaf]), b.m[leaf],
                  b.v[leaf], lo, hi, b.vec[leaf], h);
    else
      adamw_range(static_cast<const float*>(b.g[leaf]),
                  static_cast<float*>(b.p[leaf]), b.m[leaf], b.v[leaf], lo,
                  hi, b.vec[leaf], h);
  }
}

// the sum over the block's threads in a fixed order; valid in thread 0
__device__ __forceinline__ double block_sum(double x, double* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) shared[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < warps; ++w) s += shared[w];
  __syncthreads();                          // before shared is written again
  return s;
}

// squares in double: a float's square is exact there, so only the sums round
template <typename T>
__device__ __forceinline__ double sq_range(const T* g, long long lo,
                                           long long hi, bool vec) {
  double acc = 0.0;
  long long tail = lo;
  if (vec) {
    tail = lo + ((hi - lo) & ~static_cast<long long>(kVec - 1));
    for (long long i = lo + threadIdx.x * kVec; i < tail;
         i += kThreads * kVec) {
      float gf[kVec];
      load8(g + i, gf);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const double x = gf[k];
        acc += x * x;
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < hi; i += kThreads) {
    const double x = to_float(g[i]);
    acc += x * x;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(const NormBatch b, double* partials) {
  __shared__ double shared[kThreads / 32];
  const int items = b.chunk0[b.leaves];
  int leaf = 0;
  for (int c = blockIdx.x; c < items; c += gridDim.x) {
    while (c >= b.chunk0[leaf + 1]) ++leaf;
    const long long lo = (c - b.chunk0[leaf]) * kNormChunk;
    const long long hi = min(lo + kNormChunk, b.n[leaf]);
    const double acc =
        b.bf16[leaf]
            ? sq_range(static_cast<const __nv_bfloat16*>(b.g[leaf]), lo, hi,
                       b.vec[leaf])
            : sq_range(static_cast<const float*>(b.g[leaf]), lo, hi,
                       b.vec[leaf]);
    const double s = block_sum(acc, shared);
    if (threadIdx.x == 0) partials[b.partial0 + c] = s;
  }
}

constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const double* partials, long long n, float* total) {
  __shared__ double shared[kSumThreads / 32];
  double acc = 0.0;
  for (long long i = threadIdx.x; i < n; i += kSumThreads) acc += partials[i];
  const double s = block_sum(acc, shared);
  if (threadIdx.x == 0) *total = __double2float_rn(s);
}

long long chunks(long long n, long long chunk) {
  return (n + chunk - 1) / chunk;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// blocks of `kernel` on the card at once (cached: one card a process)
template <typename K>
int resident_blocks(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *out = sms * per_sm;
  return 0;
}

unsigned grid_for(int items, int resident) {
  return static_cast<unsigned>(items < resident ? items : resident);
}

}  // namespace

extern "C" {

// The partials strela_sq_norm writes for leaves of these sizes.
long long strela_sq_norm_partials(const long long* n, int leaves) {
  long long total = 0;
  for (int i = 0; i < leaves; ++i) total += chunks(n[i], kNormChunk);
  return total;
}

// The sum of squares of `leaves` contiguous gradients (device pointers g,
// sizes n, dtype codes dtype) into the 0-d float32 *total on the device.
// `partials` holds strela_sq_norm_partials(n, leaves) doubles. Writes the
// number of launches to *launches. Returns the CUDA error of the launches.
int strela_sq_norm(const long long* g, const long long* n, const int* dtype,
                   int leaves, double* partials, float* total, void* stream,
                   int* launches) {
  static int resident = 0;
  if (resident == 0) {
    const int rc = resident_blocks(sq_norm_kernel, &resident);
    if (rc) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  NormBatch b;
  b.leaves = 0;
  b.chunk0[0] = 0;
  b.partial0 = 0;
  for (int i = 0; i <= leaves; ++i) {
    const bool last = i == leaves;
    if (!last && n[i] > 0) {
      const int k = b.leaves++;
      b.g[k] = reinterpret_cast<const void*>(g[i]);
      b.n[k] = n[i];
      b.bf16[k] = dtype[i] == kBFloat16;
      b.vec[k] = aligned16(b.g[k]);
      b.chunk0[k + 1] =
          b.chunk0[k] + static_cast<int>(chunks(n[i], kNormChunk));
    }
    if (b.leaves == kNormLeaves || (last && b.leaves > 0)) {
      const int items = b.chunk0[b.leaves];
      sq_norm_kernel<<<grid_for(items, resident), kThreads, 0, s>>>(b,
                                                                    partials);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
      ++*launches;
      b.partial0 += items;
      b.leaves = 0;
    }
  }
  sum_partials_kernel<<<1, kSumThreads, 0, s>>>(partials, b.partial0, total);
  ++*launches;
  return static_cast<int>(cudaGetLastError());
}

// AdamW over `leaves` leaves in place: gradients g, parameters p (both of
// dtype code dtype[i]), float32 moments m and v, all contiguous, n[i]
// elements each. lr, b1c, b2c and scale (null: 1) point at float32 on the
// device; c1 = 1 - b1 and c2 = 1 - b2 as the caller rounds them. Writes the
// number of launches to *launches. Returns the CUDA error of the launches.
int strela_adamw(const long long* g, const long long* p, const long long* m,
                 const long long* v, const long long* n, const int* dtype,
                 int leaves, const float* lr, const float* b1c,
                 const float* b2c, const float* scale, float b1, float c1,
                 float b2, float c2, float eps, float wd, void* stream,
                 int* launches) {
  static int resident = 0;
  if (resident == 0) {
    const int rc = resident_blocks(adamw_kernel, &resident);
    if (rc) return rc;
  }
  const Hyper hy{lr, b1c, b2c, scale, b1, c1, b2, c2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  AdamBatch b;
  b.leaves = 0;
  b.chunk0[0] = 0;
  for (int i = 0; i <= leaves; ++i) {
    const bool last = i == leaves;
    if (!last && n[i] > 0) {
      const int k = b.leaves++;
      b.g[k] = reinterpret_cast<const void*>(g[i]);
      b.p[k] = reinterpret_cast<void*>(p[i]);
      b.m[k] = reinterpret_cast<float*>(m[i]);
      b.v[k] = reinterpret_cast<float*>(v[i]);
      b.n[k] = n[i];
      b.bf16[k] = dtype[i] == kBFloat16;
      b.vec[k] = aligned16(b.g[k]) && aligned16(b.p[k]) &&
                 aligned16(b.m[k]) && aligned16(b.v[k]);
      b.chunk0[k + 1] =
          b.chunk0[k] + static_cast<int>(chunks(n[i], kAdamChunk));
    }
    if (b.leaves == kAdamLeaves || (last && b.leaves > 0)) {
      adamw_kernel<<<grid_for(b.chunk0[b.leaves], resident), kThreads, 0, s>>>(
          b, hy);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
      ++*launches;
      b.leaves = 0;
    }
  }
  return 0;
}

}  // extern "C"
