// flash_attention.cu — tiled online-softmax attention as a hand-written CUDA
// kernel for Hopper (sm_90a), with a plain C interface (loaded through
// ctypes by kernels/_build.py).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _masked_kernel, pallas_call at line 68). q is
// (h, sq, d), k and v are (h, sk, d) with the kv heads already broadcast;
// float32 or bfloat16, upcast on load; all arithmetic in fp32; the output
// has q's dtype. Entry point strela_flash_attention. With a non-null lse
// (float32, (h, sq)) the forward also writes each row's log-sum-exp of
// the scaled scores in natural-log units, m + log(l), for the backward.
//
// Semantics kept from the reference: s = (q . k) * scale with scale =
// 1/sqrt(d); a masked score is -1e30; a key is allowed when ki < sk and,
// if causal, q_off + qi >= ki with q_off = sk - sq (queries aligned to the
// end of the keys); a key tile whose first key lies past the query tile's
// last query is skipped; the output is acc / max(l, 1e-30). (The kernel
// keeps scores in log2 units, s * log2(e), and takes 2^x on the SFU: the
// same softmax; -1e30 still gives 0.) The wrapper refuses causal with
// sq > sk, where some rows have no allowed key.
//
// Bound on the H100: operations. Causal attention over 36 heads at
// sq = sk = 4096, d = 64 is 77.3 GFLOP (QK^T and PV over the allowed pairs)
// against 151 MB of q, k, v and o: 1.15 ms at the FP32 units' 67 TFLOP/s
// against 0.045 ms of memory. Both products stay on the FP32 units, with
// no TF32, because the reference tolerance is 3e-5. So the design feeds
// the FP32 units from registers and keeps shared-memory traffic below them:
//
//   * One block of 128 threads per (head, 128-query tile), looping over
//     64-key tiles, which takes the place of the Pallas grid's sequential
//     key axis that carries m, l and acc in VMEM scratch; m, l and the
//     output rows live in registers. Blocks of the last query tiles, which
//     see the most keys under the causal mask, are launched first.
//   * Thread (tq, tk) = (t / 8, t % 8) owns queries tq + 16 i (i < 8): their
//     scores against keys tk + 8 j (j < 8), and their output columns
//     32 g + 4 tk .. + 3 (g < d / 32, read from V as float4) plus, at
//     d = 16 and 80, 32 (d / 32) + 2 tk .. + 1. Each product does 64 FMAs
//     per two float4 reads of shared memory (8 x 4 blocks would do 32 per
//     three), at 255 registers a thread. Row maxima and sums stay within
//     the 8 threads of a row group (warp shuffles).
//   * Q, K and V lie row-major in shared memory. Q and K rows are padded to
//     d + 4 floats, P rows to 72, so the rows that one warp reads together
//     fall on distinct banks.
//   * K and V tiles come in by cp.async.cg 16-byte copies, zero-filled past
//     sk; bfloat16 inputs are loaded and converted by the threads instead.
//     K and V are single-buffered and each copy overlaps the other product:
//     tile j + 1's K loads during tile j's P V, its V during tile j + 1's
//     Q K^T, at three __syncthreads per key tile.
//
// d takes 16, 64, 80 and 128, the head widths of the reference's tests and
// model configurations. Shared memory grows with d (55 KB at d = 16, 103 KB
// at d = 64, 119 KB at d = 80, 167 KB at d = 128), so it is dynamic and the
// limit is raised with cudaFuncSetAttribute. Two blocks fit on an SM up to
// d = 64, one above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 128;                 // queries per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 128;            // 16 row groups x 8 key groups
constexpr int kPStride = kBK + 8;        // P rows: a warp's four rows on
                                         // distinct banks
constexpr float kNegInf = -1e30f;
constexpr int kSmemPerSM = 233472;       // 228 KB, 1 KB kept per block
static_assert(kBQ == 8 * 16 && kBK == 8 * 8 && kThreads == 16 * 8,
              "each thread owns 8 queries x 8 keys of the 16 x 8 grid");

// Buffers in floats, and whether two blocks fit on an SM
template <int D>
struct Layout {
  static constexpr int QS = D + 4, KS = D + 4, VS = D;   // row strides
  static constexpr int NV4 = D / 32;          // float4 column groups
  static constexpr int NV2 = (D % 32) / 16;   // float2 column groups
  static constexpr int CPT = 4 * NV4 + 2 * NV2;   // columns per thread
  static constexpr int Q = kBQ * QS, K = kBK * KS, V = kBK * VS,
                       P = kBQ * kPStride;
  static constexpr size_t bytes =
      sizeof(float) * (static_cast<size_t>(Q) + K + V + P);
  static constexpr bool two_blocks = 2 * (bytes + 1024) <= kSmemPerSM;
  static_assert(D % 16 == 0 && CPT * 8 == D, "d must be a multiple of 16");
  static_assert(bytes <= 232448, "the block's shared memory passes 227 KB");
};

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
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float2 v);
template <>
__device__ __forceinline__ void store2<float>(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + n) of a (rows, D) matrix into dst (row stride S
// floats), zero past n_rows: float32 by cp.async (src-size 0 fills zeros),
// bfloat16 loaded and converted by the threads
template <typename T, int D, int S>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int row0, int n, int n_rows) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(dst + r * S + c,
                 src + static_cast<size_t>(ok ? row : 0) * D + c,
                 ok ? 16 : 0);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) x = load4(src + static_cast<size_t>(row) * D + c);
      *reinterpret_cast<float4*>(dst + r * S + c) = x;
    }
  }
}

// 2^x by the SFU alone (ex2.approx, relative error about 2^-22, results
// below 2^-126 flushed to 0): exp2f adds range fixes that cost 3% of the
// kernel, and a p below 2^-126 adds nothing a float sum of p can hold
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::two_blocks ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int sq, int sk, float scale,
             int causal) {
  using L = Layout<D>;
  constexpr int QS = L::QS, KS = L::KS, VS = L::VS, NV4 = L::NV4,
                NV2 = L::NV2, CPT = L::CPT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kBQ][QS]
  float* Ks = Qs + L::Q;                 // [kBK][KS]
  float* Vs = Ks + L::K;                 // [kBK][VS]
  float* Ps = Vs + L::V;                 // [kBQ][kPStride]

  const int t = threadIdx.x, tk = t % 8, tq = t / 8;
  // scores in log2 units, so that exp(x - m) is one ex2: the same softmax
  // as the reference's, at a fraction of the instructions of expf
  const float scale2 = scale * 1.4426950408889634f;
  const int head = blockIdx.y;
  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int q0 = qb * kBQ;
  const int q_off = sk - sq;
  const T* qh = q + static_cast<size_t>(head) * sq * D;
  const T* kh = k + static_cast<size_t>(head) * sk * D;
  const T* vh = v + static_cast<size_t>(head) * sk * D;
  T* oh = o + static_cast<size_t>(head) * sq * D;

  // key tiles up to the first that starts past the tile's last query
  const int n_kb = (sk + kBK - 1) / kBK;
  const int n_tiles =
      causal ? min(n_kb, (q_off + q0 + kBQ - 1) / kBK + 1) : n_kb;

  stage_rows<T, D, QS>(Qs, qh, q0, kBQ, sq);
  stage_rows<T, D, KS>(Ks, kh, 0, kBK, sk);
  cp_async_commit();
  stage_rows<T, D, VS>(Vs, vh, 0, kBK, sk);
  cp_async_commit();

  float m[8], l[8], acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBK;
    const bool more = kb + 1 < n_tiles;
    cp_async_wait<1>();          // K (the older group); V may still land
    __syncthreads();             // tile kb's K visible to every thread

    // S = Q K^T for queries tq + 16 i, keys tk + 8 j, in d order
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tq + 16 * i) * QS +
                                                 4 * d4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (tk + 8 * j) * KS + 4 * d4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q_off + q0 + tq + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ki = k0 + tk + 8 * j;
        const bool ok = ki < sk && (!causal || qi >= ki);
        s[i][j] = ok ? s[i][j] * scale2 : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off /= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = ex2(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off /= 2)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = ex2(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[(tq + 16 * i) * kPStride + tk + 8 * j] = s[i][j];
    }
    cp_async_wait<0>();          // tile kb's V
    __syncthreads();             // P and V visible; every thread is done
                                 // with K
    if (more) stage_rows<T, D, KS>(Ks, kh, k0 + kBK, kBK, sk);
    cp_async_commit();

    // acc += P V for queries tq + 16 i and this thread's columns, in key
    // order
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (tq + 16 * i) * kPStride +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * VS;
        float4 vv[NV4 > 0 ? NV4 : 1];
        float2 v2 = make_float2(0.f, 0.f);
#pragma unroll
        for (int g = 0; g < NV4; ++g)
          vv[g] = *reinterpret_cast<const float4*>(vrow + 32 * g + 4 * tk);
        if constexpr (NV2 > 0)
          v2 = *reinterpret_cast<const float2*>(vrow + 32 * NV4 + 2 * tk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int g = 0; g < NV4; ++g) {
            acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
          }
          if constexpr (NV2 > 0) {
            acc[i][4 * NV4 + 0] = fmaf(p, v2.x, acc[i][4 * NV4 + 0]);
            acc[i][4 * NV4 + 1] = fmaf(p, v2.y, acc[i][4 * NV4 + 1]);
          }
        }
      }
    }
    __syncthreads();             // every thread is done with V and P
    if (more) stage_rows<T, D, VS>(Vs, vh, k0 + kBK, kBK, sk);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tq + 16 * i;
    if (row >= sq) continue;
    // m and l are equal across the row group's 8 threads (shuffled); the
    // log-sum-exp back in natural-log units: (m + log2 l) ln 2
    if (lse != nullptr && tk == 0)
      lse[static_cast<size_t>(head) * sq + row] =
          (m[i] + log2f(l[i])) * 0.6931471805599453f;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = oh + static_cast<size_t>(row) * D;
#pragma unroll
    for (int g = 0; g < NV4; ++g)
      store4(orow + 32 * g + 4 * tk,
             make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                         acc[i][4 * g + 2] / denom,
                         acc[i][4 * g + 3] / denom));
    if constexpr (NV2 > 0)
      store2(orow + 32 * NV4 + 2 * tk,
             make_float2(acc[i][4 * NV4] / denom,
                         acc[i][4 * NV4 + 1] / denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int h, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  // above 48 KB a block may use dynamic shared memory only once the limit
  // is raised (per device, so on every call)
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((sq + kBQ - 1) / kBQ, h);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int h, int sq, int sk, int d, float scale,
               int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, h, sq, sk, scale,
                                  causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, h, sq, sk, scale,
                                  causal, s);
    case 80: return launch<T, 80>(q, k, v, o, lse, h, sq, sk, scale,
                                  causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, h, sq, sk, scale,
                                    causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The backward: three kernels, deterministic (no atomics; every sum runs in
// one fixed order), fp32 arithmetic, never TF32.
//
// Given q, k, v, the forward's o and lse (natural-log units) and dO:
//   P  = exp(S scale - lse), 0 where the forward's mask is 0 (padded or
//        masked keys, padded queries), S = Q K^T
//   D  = rowsum(dO o O)                  (flash_bwd_preprocess)
//   dV = P^T dO,  dS = P o (dO V^T - D),  dK = dS^T Q scale
//                                         (flash_bwd_dkdv_kernel)
//   dQ = dS K scale                       (flash_bwd_dq_kernel)
// XLA differentiates the reference's attention (the "full" branch or
// _chunked_attention); the Pallas kernel has no backward, so these are the
// counterpart of XLA's derivative, not of a TPU kernel's.
//
// Bound on the H100: operations, 5 products of 2 sq sk d (S once, dP, dV,
// dK, dQ), halved under the causal mask, on the FP32 units. This design
// recomputes S and dP in both kernels (7 products) so that each output is
// summed by one block in registers: dK and dV by a block per key tile
// looping over the query tiles that see it (the forward's causal skip
// mirrored: query tiles that end before the key tile starts), dQ by a block
// per query tile looping over the key tiles it sees. 64 x 64 tiles, 256
// threads; thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 i (i < 4)
// and columns tx + 16 j of a score tile, and rows ty + 16 i, columns
// tx + 16 c (c < d / 16) of its block's output. Tiles lie in shared memory
// as float32 rows of d + 1 (odd, so the 16 rows a warp reads at one column
// fall on distinct banks); the scalar products read shared memory once per
// FMA pair, a simple design that later work can move to mma.
// ---------------------------------------------------------------------------

constexpr int kBB = 64;                  // queries and keys per tile
constexpr int kBwdThreads = 256;         // 16 x 16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdLayout {
  static constexpr int S = D + 1;        // row stride of Q, K, V, dO tiles
  static constexpr int PS = kBB + 1;     // row stride of P and dS tiles
  static constexpr int CPT = D / 16;     // output columns per thread
  static constexpr int T = kBB * S, P = kBB * PS;
  static constexpr size_t dkdv_bytes =
      sizeof(float) * (4 * static_cast<size_t>(T) + 2 * P + 2 * kBB);
  static constexpr size_t dq_bytes =
      sizeof(float) * (4 * static_cast<size_t>(T) + P + 2 * kBB);
  static_assert(D % 16 == 0, "d must be a multiple of 16");
  static_assert(dkdv_bytes <= 232448,
                "the block's shared memory passes 227 KB");
};

// rows [row0, row0 + kBB) of a (rows, D) matrix into dst as float32 with
// row stride S, zero past n_rows
template <typename T, int D, int S>
__device__ __forceinline__ void stage_bwd(float* dst, const T* src, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < kBB * (D / 4); idx += kBwdThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) x = load4(src + static_cast<size_t>(row) * D + c);
    float* d = dst + r * S + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <typename T>
__device__ __forceinline__ void store1(T* p, float v);
template <>
__device__ __forceinline__ void store1<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float load1(const T* p);
template <>
__device__ __forceinline__ float load1<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load1<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// D = rowsum(dO o O) over rows = h * sq rows of width d: one warp a row,
// lanes over the columns in order, then a fixed butterfly
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(load1(drow + c), load1(orow + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// S = Q K^T and dP = dO V^T for this thread's 4 x 4 of a 64 x 64 tile,
// then P and dS with the forward's mask; P and dS into shared memory
// (dkdv) or dS only (dq, Ps null)
template <int D>
__device__ __forceinline__ void scores_bwd(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse2_s, const float* dl_s, float* Ps, float* dSs, int q0,
    int k0, int sq, int sk, int q_off, float scale2, int causal) {
  using L = BwdLayout<D>;
  constexpr int S = L::S, PS = L::PS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * S + dd];
      ov[i] = dOs[(ty + 16 * i) * S + dd];
      kv[i] = Ks[(tx + 16 * i) * S + dd];
      vv[i] = Vs[(tx + 16 * i) * S + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, ki = k0 + c;
      const bool ok = qi < sq && ki < sk && (!causal || q_off + qi >= ki);
      const float p = ok ? ex2(s[i][j] * scale2 - lse2_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

// lse (in log2 units) and D of query rows [q0, q0 + kBB), zero past sq
__device__ __forceinline__ void stage_rows_stats(float* lse2_s, float* dl_s,
                                                 const float* lse,
                                                 const float* delta, int q0,
                                                 int sq) {
  const int t = threadIdx.x;
  if (t < kBB) {
    const int row = q0 + t;
    lse2_s[t] = row < sq ? lse[row] * kLog2e : 0.f;
    dl_s[t] = row < sq ? delta[row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, float scale,
                      int causal) {
  using L = BwdLayout<D>;
  constexpr int S = L::S, PS = L::PS, CPT = L::CPT;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::T;
  float* Qs = Vs + L::T;
  float* dOs = Qs + L::T;
  float* Ps = dOs + L::T;
  float* dSs = Ps + L::P;
  float* lse2_s = dSs + L::P;
  float* dl_s = lse2_s + kBB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBB;
  const int q_off = sk - sq;
  const float scale2 = scale * kLog2e;
  const size_t qoff = static_cast<size_t>(head) * sq;
  const size_t koff = static_cast<size_t>(head) * sk;

  stage_bwd<T, D, S>(Ks, k + koff * D, k0, sk);
  stage_bwd<T, D, S>(Vs, v + koff * D, k0, sk);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query qi sees key ki when q_off + qi >= ki, so the first query
  // tile that sees this key tile holds query k0 - q_off
  const int qb0 = causal ? max(0, k0 - q_off) / kBB : 0;
  const int n_qb = (sq + kBB - 1) / kBB;
  for (int qb = qb0; qb < n_qb; ++qb) {
    const int q0 = qb * kBB;
    __syncthreads();             // the last tile's Q, dO, P, dS are read
    stage_bwd<T, D, S>(Qs, q + qoff * D, q0, sq);
    stage_bwd<T, D, S>(dOs, dout + qoff * D, q0, sq);
    stage_rows_stats(lse2_s, dl_s, lse + qoff, delta + qoff, q0, sq);
    __syncthreads();
    scores_bwd<D>(Qs, dOs, Ks, Vs, lse2_s, dl_s, Ps, dSs, q0, k0, sq, sk,
                  q_off, scale2, causal);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q for keys ty + 16 i, columns tx + 16 c,
    // in query order
#pragma unroll 2
    for (int qq = 0; qq < kBB; ++qq) {
      float pr[4], dsr[4], oc[CPT], qc[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[qq * PS + ty + 16 * i];
        dsr[i] = dSs[qq * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        oc[c] = dOs[qq * S + tx + 16 * c];
        qc[c] = Qs[qq * S + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv_acc[i][c] = fmaf(pr[i], oc[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsr[i], qc[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
    T* dkrow = dk + (koff + row) * D;
    T* dvrow = dv + (koff + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store1(dkrow + tx + 16 * c, dk_acc[i][c] * scale);
      store1(dvrow + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  using L = BwdLayout<D>;
  constexpr int S = L::S, PS = L::PS, CPT = L::CPT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::T;
  float* Ks = dOs + L::T;
  float* Vs = Ks + L::T;
  float* dSs = Vs + L::T;
  float* lse2_s = dSs + L::P;
  float* dl_s = lse2_s + kBB;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBB;   // heaviest first
  const int q_off = sk - sq;
  const float scale2 = scale * kLog2e;
  const size_t qoff = static_cast<size_t>(head) * sq;
  const size_t koff = static_cast<size_t>(head) * sk;

  stage_bwd<T, D, S>(Qs, q + qoff * D, q0, sq);
  stage_bwd<T, D, S>(dOs, dout + qoff * D, q0, sq);
  stage_rows_stats(lse2_s, dl_s, lse + qoff, delta + qoff, q0, sq);

  float dq_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq_acc[i][c] = 0.f;

  // key tiles up to the first that starts past the tile's last query
  const int n_kb = (sk + kBB - 1) / kBB;
  const int n_tiles =
      causal ? min(n_kb, (q_off + q0 + kBB - 1) / kBB + 1) : n_kb;
  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBB;
    __syncthreads();             // the last tile's K and dS are read
    stage_bwd<T, D, S>(Ks, k + koff * D, k0, sk);
    stage_bwd<T, D, S>(Vs, v + koff * D, k0, sk);
    __syncthreads();
    scores_bwd<D>(Qs, dOs, Ks, Vs, lse2_s, dl_s, nullptr, dSs, q0, k0, sq,
                  sk, q_off, scale2, causal);
    __syncthreads();
    // dQ += dS K for queries ty + 16 i, columns tx + 16 c, in key order
#pragma unroll 2
    for (int kk = 0; kk < kBB; ++kk) {
      float dsr[4], kc[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kc[c] = Ks[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          dq_acc[i][c] = fmaf(dsr[i], kc[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* dqrow = dq + (qoff + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store1(dqrow + tx + 16 * c, dq_acc[i][c] * scale);
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int h, sq, sk;
  float scale;
  int causal;
};

template <typename T, int D>
int launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = BwdLayout<D>::dkdv_bytes;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sk + kBB - 1) / kBB, a.h);
  flash_bwd_dkdv_kernel<T, D><<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t bytes = BwdLayout<D>::dq_bytes;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sq + kBB - 1) / kBB, a.h);
  flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.sq, a.sk, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDq>
int dispatch_bwd(const BwdArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 16: return kDq ? launch_dq<T, 16>(a, s) : launch_dkdv<T, 16>(a, s);
    case 64: return kDq ? launch_dq<T, 64>(a, s) : launch_dkdv<T, 64>(a, s);
    case 80: return kDq ? launch_dq<T, 80>(a, s) : launch_dkdv<T, 80>(a, s);
    case 128:
      return kDq ? launch_dq<T, 128>(a, s) : launch_dkdv<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int run_bwd(const BwdArgs& a, int d, int dtype, void* stream) {
  if (a.h < 0 || a.h > 65535 || a.sq < 0 || a.sk < 1 ||
      (a.causal && a.sq > a.sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.h == 0 || a.sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bwd<float, kDq>(a, d, s);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16, kDq>(a, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (h, sq, d), k and v (h, sk, d), o (h, sq, d): contiguous, 16-byte
// aligned, dtype 0 float32 or 1 bfloat16 for all four. lse is null or a
// float32 (h, sq) buffer for the rows' log-sum-exp. d is 16, 64, 80 or
// 128; sk >= 1; causal requires sq <= sk. Returns the CUDA error
// of the launch (0 on success).
int strela_flash_attention(const void* q, const void* k, const void* v,
                           void* o, void* lse, int h, int sq, int sk, int d,
                           int dtype, int causal, float scale, void* stream) {
  if (h < 0 || h > 65535 || sq < 0 || sk < 1 || (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, l, h, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, l, h, sq, sk, d, scale,
                                     causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// D = rowsum(dout o o) in float32 over rows rows of width d (o and dout
// contiguous, dtype 0 float32 or 1 bfloat16; delta float32 (rows,)).
int strela_flash_bwd_preprocess(const void* o, const void* dout, void* delta,
                                long long rows, int d, int dtype,
                                void* stream) {
  if (rows < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((rows + 7) / 8));
  if (dtype == 0)
    flash_bwd_preprocess<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, d);
  else if (dtype == 1)
    flash_bwd_preprocess<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),
        rows, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV (h, sk, d) from q (h, sq, d), k and v (h, sk, d), dout
// (h, sq, d), the forward's lse and D (float32, (h, sq)): one block per
// (key tile, head). Shapes, dtypes and d as strela_flash_attention's.
int strela_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int h,
                          int sq, int sk, int d, int dtype, int causal,
                          float scale, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, h, sq,
                  sk, scale, causal};
  return run_bwd<false>(a, d, dtype, stream);
}

// dQ (h, sq, d) from the same inputs: one block per (query tile, head).
int strela_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int h, int sq, int sk, int d, int dtype,
                        int causal, float scale, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  h, sq, sk, scale, causal};
  return run_bwd<true>(a, d, dtype, stream);
}

}  // extern "C"
