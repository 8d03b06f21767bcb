// flash_attention.cu — tiled online-softmax attention as a hand-written CUDA
// kernel for Hopper (sm_90a), with a plain C interface (loaded through
// ctypes by kernels/_build.py).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _masked_kernel, pallas_call at line 68). q is
// (h, sq, d), k and v are (h, sk, d) with the kv heads already broadcast;
// float32 or bfloat16, upcast on load; all arithmetic in fp32; the output
// has q's dtype. Entry point strela_flash_attention.
//
// Semantics kept from the reference: s = (q . k) * scale with scale =
// 1/sqrt(d); a masked score is -1e30; a key is allowed when ki < sk and,
// if causal, q_off + qi >= ki with q_off = sk - sq (queries aligned to the
// end of the keys); a key tile whose first key lies past the query tile's
// last query is skipped; the output is acc / max(l, 1e-30). The wrapper
// refuses causal with sq > sk, where some rows have no allowed key.
//
// Bound on the H100: operations. Causal attention over 36 heads at
// sq = sk = 4096, d = 64 is 77.3 GFLOP (QK^T and PV over the allowed pairs)
// against 151 MB of q, k, v and o: 1.15 ms at the FP32 units' 67 TFLOP/s
// against 0.045 ms of memory. Both products stay on the FP32 units, with
// no TF32, because the reference tolerance is 3e-5.
//
// Design. One block of 256 threads per (head, 64-query tile); the block
// loops over 64-key tiles, which takes the place of the Pallas grid's
// sequential key axis that carries m, l and acc in VMEM scratch. Q is
// staged once and each K tile per step, both transposed ([d][row]) in
// shared memory, so a thread reads four queries or four keys as one
// float4; V stays row-major. Thread (tq, tk) owns queries 4tq..4tq+3: it
// computes their scores against keys 4tk..4tk+3, takes row maxima and sums
// over the 16 threads of a row group with warp shuffles, writes its
// probabilities to shared memory, and accumulates output columns tk + 16j
// (j < d/16) of its four rows in registers. d takes 16, 64, 80 and 128,
// the head widths of the reference's tests and model configurations. m and l live in registers too.
// Shared memory grows with d (115 KB at d = 128), so it is dynamic and the
// limit is raised with cudaFuncSetAttribute. Blocks of the last query
// tiles, which see the most keys under the causal mask, are launched first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                  // queries per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 256;            // 16 row groups x 16 key groups
constexpr int kPStride = kBK + 4;        // P rows: float4-aligned
constexpr float kNegInf = -1e30f;
static_assert(kBQ == 64 && kBK == 64, "load_transposed stages 64 rows");

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ void store1(T* p, float v);
template <>
__device__ __forceinline__ void store1<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(D) * kBQ + static_cast<size_t>(D) * kBK +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kPStride);
}

// rows [row0, row0 + 64) of a (rows, D) matrix into dst[d * 64 + r],
// zero past n_rows
template <typename T, int D>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int row0, int n_rows) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx % 64, c = (idx / 64) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) x = load4(src + static_cast<size_t>(row) * D + c);
    dst[(c + 0) * 64 + r] = x.x;
    dst[(c + 1) * 64 + r] = x.y;
    dst[(c + 2) * 64 + r] = x.z;
    dst[(c + 3) * 64 + r] = x.w;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             float scale, int causal) {
  constexpr int DC = D / 16;             // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [D][kBQ]
  float* Ks = Qs + D * kBQ;              // [D][kBK]
  float* Vs = Ks + D * kBK;              // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kPStride]

  const int t = threadIdx.x, tk = t % 16, tq = t / 16;
  const int head = blockIdx.y;
  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int q0 = qb * kBQ;
  const int q_off = sk - sq;
  const T* qh = q + static_cast<size_t>(head) * sq * D;
  const T* kh = k + static_cast<size_t>(head) * sk * D;
  const T* vh = v + static_cast<size_t>(head) * sk * D;
  T* oh = o + static_cast<size_t>(head) * sq * D;

  load_transposed<T, D>(Qs, qh, q0, sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_kb = (sk + kBK - 1) / kBK;
  const int last_q = q_off + q0 + kBQ - 1;     // the tile's last query
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    if (causal && k0 > last_q) break;          // this and every later tile
                                               // is masked out
    __syncthreads();                           // last tile's Vs, Ps read
    load_transposed<T, D>(Ks, kh, k0, sk);
    for (int idx = t; idx < kBK * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < sk) x = load4(vh + static_cast<size_t>(k0 + r) * D + c);
      *reinterpret_cast<float4*>(Vs + r * D + c) = x;
    }
    __syncthreads();

    // S = Q K^T for queries 4tq + i, keys 4tk + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + d * kBQ + tq * 4);
      const float4 kv = *reinterpret_cast<const float4*>(Ks + d * kBK + tk * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_off + q0 + tq * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tk * 4 + j;
        const bool ok = ki < sk && (!causal || qi >= ki);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
      *reinterpret_cast<float4*>(Ps + (tq * 4 + i) * kPStride + tk * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P V for queries 4tq + i, columns tk + 16j
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (tq * 4 + i) * kPStride + kk);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) vv[j] = Vs[(kk + u) * D + tk + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j)
            acc[i][j] = fmaf(p[i][u], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tq * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      store1(oh + static_cast<size_t>(row) * D + tk + 16 * j,
             acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int h,
           int sq, int sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // above 48 KB a block may use dynamic shared memory only once the limit
  // is raised (per device, so on every call)
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((sq + kBQ - 1) / kBQ, h);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int h,
               int sq, int sk, int d, float scale, int causal,
               cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, h, sq, sk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, h, sq, sk, scale, causal, s);
    case 80: return launch<T, 80>(q, k, v, o, h, sq, sk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, h, sq, sk, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (h, sq, d), k and v (h, sk, d), o (h, sq, d): contiguous, 16-byte
// aligned, dtype 0 float32 or 1 bfloat16 for all four. d is 16, 64, 80 or
// 128; sk >= 1; causal requires sq <= sk. Returns the CUDA error
// of the launch (0 on success).
int strela_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int h, int sq, int sk, int d, int dtype,
                           int causal, float scale, void* stream) {
  if (h < 0 || h > 65535 || sq < 0 || sk < 1 || (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, h, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, h, sq, sk, d, scale, causal,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
