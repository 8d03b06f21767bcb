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
template <typename T, int D, int S, int kThr = kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int row0, int n, int n_rows) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += kThr) {
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
// one fixed order, so two runs are bit-identical).
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
// dK, dQ), halved under the causal mask. On the FP32 units (67 TFLOP/s) at
// minicpm-2b's training shape (h = 144, sq = sk = 512, d = 64, causal) that
// is 0.1806 ms (dkdv's 4 products 0.1445, dq's 3 products 0.1084). These
// kernels run the products on the TF32 tensor cores in three passes, so
// the bound is the same five products at 495 / 3 = 165 TFLOP/s: 0.0733 ms
// (dkdv 0.0587, dq 0.0440). The design recomputes S and dP in both kernels
// (7 products where 5 suffice) so that each output is summed by one block
// in registers: dK and dV by a block per key tile looping over the query
// tiles that see it (the forward's causal skip mirrored: query tiles that
// end before the key tile starts), dQ by a block per query tile looping
// over the key tiles it sees. 3xTF32 pays for the recomputation 2.5 times.
//
// Why 3xTF32. One TF32 pass keeps 10 mantissa bits of each operand, a
// relative error of 2^-11 per product, which puts the backward out of its
// 1e-4 limit against float32. Each float32 x splits into hi = tf32_rna(x)
// and lo = tf32_rna(x - hi) (cvt.rna.tf32.f32: round to nearest, ties away
// from zero), and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b to about 2^-21
// relative (lo_a lo_b, 2^-22, is dropped): three mma.sync.m16n8k8 TF32
// products into one float32 accumulator, small terms first, in k order.
// (The tensor cores add each product into the accumulator truncating, so
// the error grows with the length of the sum: 7e-6 of max |dK| at 512
// queries, 2.2e-5 at 1500, against the 1e-4 limit.)
//
// Where the split happens. The streamed tile (Q and dO in dkdv, K and V in
// dq) is read by every warp of the block, twice for Q and K: it is split
// once, at staging, into hi and lo planes in shared memory (split_tile),
// which the warps read as B fragments. Splitting it at fragment load
// instead cost every warp the same splits again, and measured 13-16%
// slower at minicpm-2b's and zamba2-2.7b's shapes. The block's own tile
// (K and V in dkdv, Q and dO in dq, 16 rows a warp) is split at fragment
// load, as are P and dS in registers. A split costs four instructions
// (split_tf32: hi by an integer add and mask, lo by a subtract and
// cvt.rna; two cvt.rna a value were 15-19% slower, the conversion pipe
// being the bottleneck).
//
// Warp layout. Each warp owns 16 rows of the block's own tile. dkdv: a
// warp computes S^T = K Q^T and dP^T = V dO^T against the streamed query
// tile (C fragments, 16 keys x QT queries), forms P^T and dS^T in place
// with the forward's mask (a masked entry is exactly 0), and accumulates
// dV += P^T dO and dK += dS^T Q in C fragments (16 keys x d). dq: a warp
// computes S = Q K^T and dP = dO V^T against the streamed key tile, dS in
// place, and accumulates dQ += dS K. A warp none of whose rows the tile
// reaches (past the causal diagonal, past sq or sk) skips it, and a warp
// whose tile has no masked entry forms P and dS without the mask's index
// arithmetic; the sums are the same. mma.sync, not wgmma: TF32 wgmma
// needs both operands K-major in shared memory, so P and dS would have to
// go through shared memory, where mma.sync keeps them in registers.
//
// Permuted-k register reuse. An m16n8k8 C fragment holds columns 2t and
// 2t + 1 (t = lane % 4) of rows g and g + 8 (g = lane / 4); an A fragment
// wants columns t and t + 4. The k index is summed, so it is relabelled:
// logical k = t is physical column 2t and k = t + 4 is 2t + 1. The C
// fragment (c0, c1, c2, c3) becomes the next product's (a0, a2, a1, a3),
// and the B fragment is loaded from rows 2t and 2t + 1 of each 8-row
// group. P and dS feed dV, dK and dQ without a shuffle or shared memory.
//
// Tiles and shared memory (BwdLayout). Rows lie in shared memory with a
// stride of d + 4 words: every fragment load (rows g at column t, and rows
// 2t, 2t + 1 at column g) falls on 32 distinct banks at d = 16, 64, 80 and
// 128, and rows stay 16-byte aligned for cp.async. A block has W = 8 warps
// (4 at d = 128), so R = 16 W own rows, and streams tiles of QT queries
// (dkdv) or KT keys (dq): 64, or 32 at d = 128, where 64 would put the
// 2 x 64 accumulators, S^T and dP^T past the 255 registers a thread and
// the planes past 227 KB. A tile lands by cp.async (bfloat16 inputs are
// loaded and converted by the threads, as the forward does) in a landing
// buffer while the warps compute on the previous tile's planes; then the
// block splits it into the planes: two __syncthreads a tile. Bytes per
// launch, one block an SM above d = 16:
//   d      16      64       80       128
//   dkdv   52,224  175,104  216,064  169,472
//   dq     51,200  174,080  215,040  168,960
// raised per launch with cudaFuncSetAttribute.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdLayout {
  static constexpr int S = D + 4;        // row stride of every tile
  static constexpr int W = D >= 128 ? 4 : 8;      // warps a block
  static constexpr int R = 16 * W;       // a block's own keys (dkdv) or
                                         // queries (dq), 16 a warp
  static constexpr int QT = D >= 128 ? 32 : 64;   // dkdv's query tile
  static constexpr int KT = D >= 128 ? 32 : 64;   // dq's key tile
  static constexpr size_t dkdv_bytes =
      sizeof(float) * (2 * R * S + 6 * QT * S + 4 * QT);
  static constexpr size_t dq_bytes =
      sizeof(float) * (2 * R * S + 6 * KT * S);
  static_assert(D % 16 == 0, "d must be a multiple of 16");
  static_assert(dkdv_bytes <= 232448 && dq_bytes <= 232448,
                "the block's shared memory passes 227 KB");
};

template <typename T>
__device__ __forceinline__ float load1(const T* p);
template <>
__device__ __forceinline__ float load1<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load1<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// one float of lse or D by a 4-byte cp.async, zero when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// x = hi + lo: hi = tf32_rna(x), lo = tf32_rna(x - hi). hi is rounded by
// an integer add of half a TF32 unit and a mask, the bits cvt.rna gives
// for every finite x, lo by cvt.rna itself: the two share the integer and
// the conversion pipes, which all-cvt or all-integer splits saturate. A
// NaN whose payload wraps the add (0x7fffffff) gives hi = -0, but its lo is
// NaN, so the product is NaN as with cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// rows [0, n) of a raw tile (stride S) into its hi and lo planes, once a
// tile for every warp of the block
template <int D, int S, int kThr>
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo,
                                           const float* raw, int n) {
  for (int idx = threadIdx.x; idx < n * (D / 4); idx += kThr) {
    const int at = idx / (D / 4) * S + idx % (D / 4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three TF32 passes, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// c (16 x 8 NT) += A B^T over k = D in d order: A the warp's 16 raw rows
// at a, split at load; B 8 NT rows as hi and lo planes at bh, bl; all
// row-major in shared memory (stride D + 4)
template <int D, int NT>
__device__ __forceinline__ void mma_rows_rows(float (&c)[NT][4],
                                              const float* a,
                                              const uint32_t* bh,
                                              const uint32_t* bl) {
  constexpr int S = BwdLayout<D>::S;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  a += g * S + t;
  bh += g * S + t;
  bl += g * S + t;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a[k0], ah[0], al[0]);
    split_tf32(a[8 * S + k0], ah[1], al[1]);
    split_tf32(a[k0 + 4], ah[2], al[2]);
    split_tf32(a[8 * S + k0 + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t h[2] = {bh[8 * j * S + k0], bh[8 * j * S + k0 + 4]};
      const uint32_t l[2] = {bl[8 * j * S + k0], bl[8 * j * S + k0 + 4]};
      mma_3xtf32(c[j], ah, al, h, l);
    }
  }
}

// c (16 x D) += P B over k = 8 NK rows in row order: P in registers as
// the C fragments of an earlier product (permuted k), B as hi and lo
// planes at bh, bl (row-major, stride D + 4)
template <int D, int NK>
__device__ __forceinline__ void mma_regs_rows(float (&c)[D / 8][4],
                                              const float (&p)[NK][4],
                                              const uint32_t* bh,
                                              const uint32_t* bl) {
  constexpr int S = BwdLayout<D>::S;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  bh += 2 * t * S + g;
  bl += 2 * t * S + g;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t h[2] = {bh[8 * j * S + 8 * n],
                             bh[(8 * j + 1) * S + 8 * n]};
      const uint32_t l[2] = {bl[8 * j * S + 8 * n],
                             bl[(8 * j + 1) * S + 8 * n]};
      mma_3xtf32(c[n], ah, al, h, l);
    }
  }
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

// dK and dV of the key tile [k0, k0 + R): warp w owns keys
// k0 + 16 w + (g, g + 8) and their dK, dV rows as C fragments
template <typename T, int D>
__global__ void __launch_bounds__(32 * BwdLayout<D>::W)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, float scale,
                      int causal) {
  using L = BwdLayout<D>;
  constexpr int S = L::S, R = L::R, QT = L::QT, NT = QT / 8, NC = D / 8;
  constexpr int kThr = 32 * L::W;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // [R][S]
  float* Vs = Ks + R * S;                // [R][S]
  float* Qraw = Vs + R * S;              // [QT][S], landing
  float* dOraw = Qraw + QT * S;          // [QT][S], landing
  uint32_t* Qh = reinterpret_cast<uint32_t*>(dOraw + QT * S);  // [QT][S]
  uint32_t* Ql = Qh + QT * S;
  uint32_t* dOh = Ql + QT * S;
  uint32_t* dOl = dOh + QT * S;
  float* lse_raw = reinterpret_cast<float*>(dOl + QT * S);     // [QT]
  float* dl_raw = lse_raw + QT;
  float* lse2_s = dl_raw + QT;           // lse in log2 units, this tile
  float* dl_s = lse2_s + QT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int kr = k0 + 16 * warp + g;     // this thread's keys kr, kr + 8
  const int q_off = sk - sq;
  const float scale2 = scale * kLog2e;
  const size_t qoff = static_cast<size_t>(head) * sq;
  const size_t koff = static_cast<size_t>(head) * sk;
  const T* qh = q + qoff * D;
  const T* doh = dout + qoff * D;

  // Q, dO, lse and D of query tile qb into the landing buffers
  auto land = [&](int qb) {
    const int q0 = qb * QT;
    stage_rows<T, D, S, kThr>(Qraw, qh, q0, QT, sq);
    stage_rows<T, D, S, kThr>(dOraw, doh, q0, QT, sq);
    const int i = threadIdx.x % QT, row = q0 + i;
    const bool ok = row < sq;
    const float* src = (threadIdx.x < QT ? lse : delta) + qoff +
                       (ok ? row : 0);
    if (threadIdx.x < 2 * QT)
      cp_async4((threadIdx.x < QT ? lse_raw : dl_raw) + i, src, ok);
  };

  stage_rows<T, D, S, kThr>(Ks, k + koff * D, k0, R, sk);
  stage_rows<T, D, S, kThr>(Vs, v + koff * D, k0, R, sk);
  // causal: query qi sees key ki when q_off + qi >= ki, so the first query
  // tile that sees this key tile holds query k0 - q_off
  const int qb0 = causal ? max(0, k0 - q_off) / QT : 0;
  const int n_qb = (sq + QT - 1) / QT;
  land(qb0);
  cp_async_commit();

  float dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float* Kw = Ks + 16 * warp * S;
  const float* Vw = Vs + 16 * warp * S;
  const int kw0 = k0 + 16 * warp, kw_last = kw0 + 15;

  for (int qb = qb0; qb < n_qb; ++qb) {
    const int q0 = qb * QT;
    cp_async_wait<0>();
    __syncthreads();             // tile qb landed; every warp is done with
                                 // the planes of tile qb - 1
    split_tile<D, S, kThr>(Qh, Ql, Qraw, QT);
    split_tile<D, S, kThr>(dOh, dOl, dOraw, QT);
    if (threadIdx.x < QT) {
      lse2_s[threadIdx.x] = lse_raw[threadIdx.x] * kLog2e;
      dl_s[threadIdx.x] = dl_raw[threadIdx.x];
    }
    __syncthreads();             // the planes are whole; landing is free
    if (qb + 1 < n_qb) land(qb + 1);
    cp_async_commit();
    // a warp none of whose keys the tile's queries see adds only zeros
    if (kw0 >= sk || (causal && q_off + q0 + QT - 1 < kw0)) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_rows<D, NT>(s, Kw, Qh, Ql);     // S^T = K Q^T
    mma_rows_rows<D, NT>(dp, Vw, dOh, dOl);  // dP^T = V dO^T
    // P^T and dS^T in place: rows keys kr (+ 8), columns queries
    // q0 + 8 j + 2 t (+ 1); a warp whose tile has no masked entry (every
    // query sees its last key, none past sq or sk) skips the mask
    const bool full = q0 + QT <= sq && kw_last < sk &&
                      (!causal || q_off + q0 >= kw_last);
    auto form = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), qi = q0 + c;
          const int ki = kr + 4 * (e & 2);
          const bool ok = !decltype(masked)::value ||
                          (qi < sq && ki < sk && (!causal || q_off + qi >= ki));
          const float p = ok ? ex2(s[j][e] * scale2 - lse2_s[c]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[c]);
        }
    };
    if (full)
      form(std::false_type{});
    else
      form(std::true_type{});
    mma_regs_rows<D, NT>(dv_acc, s, dOh, dOl);   // dV += P^T dO
    mma_regs_rows<D, NT>(dk_acc, dp, Qh, Ql);    // dK += dS^T Q
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + 8 * r;
    if (row >= sk) continue;
    T* dkrow = dk + (koff + row) * D + 2 * t;
    T* dvrow = dv + (koff + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      store2(dkrow + 8 * n, make_float2(dk_acc[n][2 * r] * scale,
                                        dk_acc[n][2 * r + 1] * scale));
      store2(dvrow + 8 * n, make_float2(dv_acc[n][2 * r],
                                        dv_acc[n][2 * r + 1]));
    }
  }
}

// dQ of the query tile [q0, q0 + R): warp w owns queries
// q0 + 16 w + (g, g + 8) and their dQ rows as C fragments
template <typename T, int D>
__global__ void __launch_bounds__(32 * BwdLayout<D>::W)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, float scale, int causal) {
  using L = BwdLayout<D>;
  constexpr int S = L::S, R = L::R, KT = L::KT, NT = KT / 8, NC = D / 8;
  constexpr int kThr = 32 * L::W;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [R][S]
  float* dOs = Qs + R * S;               // [R][S]
  float* Kraw = dOs + R * S;             // [KT][S], landing
  float* Vraw = Kraw + KT * S;           // [KT][S], landing
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Vraw + KT * S);   // [KT][S]
  uint32_t* Kl = Kh + KT * S;
  uint32_t* Vh = Kl + KT * S;
  uint32_t* Vl = Vh + KT * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;   // heaviest first
  const int qr = q0 + 16 * warp + g;     // this thread's queries qr, qr + 8
  const int q_off = sk - sq;
  const float scale2 = scale * kLog2e;
  const size_t qoff = static_cast<size_t>(head) * sq;
  const size_t koff = static_cast<size_t>(head) * sk;
  const T* kh = k + koff * D;
  const T* vh = v + koff * D;

  auto land = [&](int kb) {
    stage_rows<T, D, S, kThr>(Kraw, kh, kb * KT, KT, sk);
    stage_rows<T, D, S, kThr>(Vraw, vh, kb * KT, KT, sk);
  };

  stage_rows<T, D, S, kThr>(Qs, q + qoff * D, q0, R, sq);
  stage_rows<T, D, S, kThr>(dOs, dout + qoff * D, q0, R, sq);
  land(0);
  cp_async_commit();
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    lse2[r] = row < sq ? lse[qoff + row] * kLog2e : 0.f;
    dl[r] = row < sq ? delta[qoff + row] : 0.f;
  }

  float dq_acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  const float* Qw = Qs + 16 * warp * S;
  const float* dOw = dOs + 16 * warp * S;
  const int qw0 = q0 + 16 * warp;

  // key tiles up to the first that starts past the tile's last query
  const int n_kb = (sk + KT - 1) / KT;
  const int n_tiles =
      causal ? min(n_kb, (q_off + q0 + R - 1) / KT + 1) : n_kb;
  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * KT;
    cp_async_wait<0>();
    __syncthreads();             // tile kb landed; every warp is done with
                                 // the planes of tile kb - 1
    split_tile<D, S, kThr>(Kh, Kl, Kraw, KT);
    split_tile<D, S, kThr>(Vh, Vl, Vraw, KT);
    __syncthreads();             // the planes are whole; landing is free
    if (kb + 1 < n_tiles) land(kb + 1);
    cp_async_commit();
    // a warp none of whose queries sees the tile's keys adds only zeros
    if (qw0 >= sq || (causal && q_off + qw0 + 15 < k0)) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_rows<D, NT>(s, Qw, Kh, Kl);     // S = Q K^T
    mma_rows_rows<D, NT>(dp, dOw, Vh, Vl);   // dP = dO V^T
    // dS in place: rows queries qr (+ 8), columns keys k0 + 8 j + 2 t
    // (+ 1); a warp whose tile has no masked entry (its first query sees
    // the tile's last key, none past sq or sk) skips the mask
    const bool full = qw0 + 16 <= sq && k0 + KT <= sk &&
                      (!causal || q_off + qw0 >= k0 + KT - 1);
    auto form = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, qi = qr + 8 * r;
          const int ki = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = !decltype(masked)::value ||
                          (qi < sq && ki < sk && (!causal || q_off + qi >= ki));
          const float p = ok ? ex2(s[j][e] * scale2 - lse2[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[r]);
        }
    };
    if (full)
      form(std::false_type{});
    else
      form(std::true_type{});
    mma_regs_rows<D, NT>(dq_acc, dp, Kh, Kl);   // dQ += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    if (row >= sq) continue;
    T* dqrow = dq + (qoff + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store2(dqrow + 8 * n, make_float2(dq_acc[n][2 * r] * scale,
                                        dq_acc[n][2 * r + 1] * scale));
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
  using L = BwdLayout<D>;
  constexpr size_t bytes = L::dkdv_bytes;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sk + L::R - 1) / L::R, a.h);
  flash_bwd_dkdv_kernel<T, D><<<grid, 32 * L::W, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  using L = BwdLayout<D>;
  constexpr size_t bytes = L::dq_bytes;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sq + L::R - 1) / L::R, a.h);
  flash_bwd_dq_kernel<T, D><<<grid, 32 * L::W, bytes, stream>>>(
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
