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
//
// The bf16 tensor-core route. For bfloat16 inputs at d = 64 and 128 with
// at least 64 queries (kernels/flash_attention.py tc_route: d = 16 and 80
// and a decode step's single query stay on the kernels above and below)
// the forward and the two backward product kernels are flash_kernel_tc,
// flash_bwd_dq_kernel_tc and flash_bwd_dkdv_kernel_tc (entry points
// strela_flash_attention_tc, strela_flash_bwd_dq_tc and
// strela_flash_bwd_dkdv_tc; flash_bwd_preprocess is shared). Bound on the
// H100: operations on the bf16 tensor cores (989 TFLOP/s) at the same
// float32-grade contract:
//
//   * A product of two bfloat16 is exact in a float32 accumulator, so
//     S = Q K^T and dP = dO V^T take one bf16 pass each.
//   * P and dS are formed in float32 exactly as above (the end-aligned
//     mask, -1e30, log2 units and ex2, P recomputed from the saved lse),
//     then split into three bfloat16: hi = bf16_rn(x), mid = bf16_rn(x -
//     hi), lo = bf16_rn(x - hi - mid), which carry all 24 bits of x. Each of
//     O = P V, dV = P^T dO, dQ = dS K and dK = dS^T Q runs as three passes
//     into one float32 accumulator, smallest piece first: at least as exact
//     as 3xTF32, which drops the lo lo term. One or two pieces would be a
//     lower precision, not the same result.
//   * So the forward is 4 passes of 2 d flop a pair and the backward 11
//     (S, dP, and three for each of dV, dQ, dK; the kernels recompute S and
//     dP in both, 13), against the 2 and 5 products above: at train-4k's
//     shape (36 heads, 4,096 positions, d = 64, causal) 0.156 ms forward
//     and 0.430 ms backward.
//
// Design (the hopper-kernels guide's shape, on hopper.cuh's mbarriers, TMA
// and wgmma helpers, which stream_matmul.cu's wgmma_gemm_kernel shares):
// a block of 384 threads, one producer warpgroup and two consumers. One
// producer thread loads the block's own 128-row tiles once (Q in the
// forward; Q and dO in dq; K and V in dkdv) and keeps a ring of kTcStages
// = 2 stages of the streamed tiles full by TMA (forward and dq: K and V
// tiles of 64 keys; dkdv: Q and dO tiles of 32 queries, with their lse and
// D), a "full" mbarrier per stage counting the bytes in and an "empty" one
// the eight consumer warps out; setmaxnreg moves registers from it (40) to
// the consumers (232). Each consumer warpgroup owns 64 of the block's rows
// (queries in the forward and dq, keys in dkdv) and issues
// wgmma.mma_async m64nNk16: S (or S^T = K Q^T, dP^T = V dO^T in dkdv) with
// both operands K-major from 128-byte swizzled shared memory, then the
// split products with the pieces of P or dS in registers as the A operand
// (an m64nN accumulator's registers are an m64k16 A fragment's, so no piece
// goes through shared memory) and B MN-major from the same tile. dkdv
// computes S^T and dP^T directly, so P^T and dS^T are already A fragments
// of dV and dK; its blocks take one 64-column box of dK and dV each (a
// grid of d / 64 column boxes), so that 64 columns of both fit beside the
// scores in a consumer's registers at d = 128 too, recomputing S^T and
// dP^T once a box. TMA's 3-D maps over (h, s, d) zero-fill rows past s
// within a head; lse and D come through 1-D maps of h sq floats in boxes of
// 36 that start on a 16-byte word. Queries, keys and heads are skipped and
// masked as above; no atomics, and every sum runs in a fixed order, so two
// runs are bit-identical. ptxas gives every thread 168 registers, not the
// 232 setmaxnreg hands a consumer (the kernels' SASS names none above
// R167), so the tiles are sized to fit: no kernel spills, and dkdv waits out
// dV's wgmmas before it splits dS (64-query tiles, or no wait, spilled and
// ran 3-4% slower). Dynamic shared memory, bytes (TcLayout, 1,024 of them
// slack for the swizzle's alignment), one block an SM:
//   d          64       128
//   fwd_tc     50,216   99,368
//   dq_tc      66,600   132,136
//   dkdv_tc    52,264   101,416

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, wgmma descriptors, tensor maps

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

// flash_bwd_preprocess: D = rowsum(dO o O) in float32 over rows = h * sq
// rows of width D. It replaces no TPU kernel (the reference leaves the
// backward to XLA). Bound on the H100: bytes, each of O and dO read once
// and D written once (37.7 MB at minicpm-2b's training shape, 73,728 rows
// of 64 floats: 0.0114 ms at 3.35 TB/s), so the design is about keeping
// enough loads in flight:
//
//   * 16-byte loads (a float4, or 8 bf16): a row is W = D / V words.
//   * A group of L lanes a row (the largest of 4, 2, 1 that divides W),
//     32 / L rows a warp side by side; lane t of a group reads words
//     t, t + L, ... of its row, so a load instruction reads 16 L bytes of
//     each of 32 / L rows. Each lane owns R rows a pass (R = 1 once a row
//     gives it kPreLoads words, else enough rows for kPreLoads), and loads
//     every word of them, of both tensors, before it sums any.
//   * A fixed order of sums, with no atomics: each lane sums its words in
//     order, each word's elements in order (fmaf), then the group adds
//     its lanes by a butterfly (__shfl_xor_sync, L / 2 first); a + b is b
//     + a in float32, so every lane ends with the same bits, run after run.
//   * The grid fills the card (at most the resident blocks of kPreThreads
//     a block, from the occupancy calculator, times the SMs) and strides
//     over the rows, every block the same number of passes.
//   * A base off 16-byte alignment (rows are D elements, a multiple of 16
//     bytes, so every row shares the base's offset) takes kVec = false: the
//     same words, each read as V element loads, in the same order of sums.
constexpr int kPreThreads = 256;
constexpr int kPreLoads = 4;      // words a tensor a lane keeps in flight

template <typename T, int D>
struct PreLayout {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // a word
  static constexpr int W = D / V;                 // words a row
  static constexpr int L = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;  // lanes
  static constexpr int P = W / L;                 // words a lane a row
  static constexpr int R = P >= kPreLoads ? 1 : (kPreLoads + P - 1) / P;
  static constexpr int G = 32 / L;                // row groups a warp
  static constexpr int ROWS = G * R;              // rows a warp a pass
  static_assert(D % V == 0, "a row is whole 16-byte words");
};

// one 16-byte word of a row, zero when !ok: one load, or (kVec false)
// one load an element, the same bits
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_word(const T* p, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int V = 16 / sizeof(T), B = sizeof(T) * 8;
    const auto* e = reinterpret_cast<
        const std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>*>(p);
    uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < V; ++i)
      u[i * B / 32] |= static_cast<uint32_t>(__ldg(e + i)) << (i * B % 32);
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// element i of a word as a float
template <typename T>
__device__ __forceinline__ float word_elem(const uint4& w, int i) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(T) == 4) return __uint_as_float(u[i]);
  return __uint_as_float(i % 2 ? u[i / 2] & 0xffff0000u : u[i / 2] << 16);
}

template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kPreThreads)
flash_bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows) {
  using L = PreLayout<T, D>;
  constexpr int V = L::V, LN = L::L, P = L::P, R = L::R;
  const int lane = threadIdx.x % 32, t = lane % LN, g = lane / LN;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kPreThreads / 32);
  for (long long base = (static_cast<long long>(blockIdx.x) *
                             (kPreThreads / 32) + threadIdx.x / 32) * L::ROWS;
       base < rows; base += warps * L::ROWS) {
    uint4 wo[R][P], wd[R][P];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * L::G + g;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long at = row * D + (t + LN * p) * V;
        wo[r][p] = load_word<T, kVec>(o + at, row < rows);
        wd[r][p] = load_word<T, kVec>(dout + at, row < rows);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc = fmaf(word_elem<T>(wd[r][p], e), word_elem<T>(wo[r][p], e),
                     acc);
#pragma unroll
      for (int off = LN / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const long long row = base + r * L::G + g;
      if (t == 0 && row < rows) delta[row] = acc;
    }
  }
}

template <typename T, int D, bool kVec>
int launch_preprocess(const void* o, const void* dout, float* delta,
                      long long rows, cudaStream_t s) {
  using L = PreLayout<T, D>;
  static int resident = 0;               // blocks on the card at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_bwd_preprocess<T, D, kVec>, kPreThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    resident = sms * per_sm;
  }
  // as few passes as the resident blocks allow, the same number for
  // every block
  const long long per_block = (kPreThreads / 32) * L::ROWS;
  const long long need = (rows + per_block - 1) / per_block;
  const long long passes = (need + resident - 1) / resident;
  const unsigned grid = static_cast<unsigned>((need + passes - 1) / passes);
  flash_bwd_preprocess<T, D, kVec><<<grid, kPreThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int dispatch_preprocess(const void* o, const void* dout, float* delta,
                        long long rows, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch_preprocess<T, 16, kVec>(o, dout, delta, rows, s);
    case 64: return launch_preprocess<T, 64, kVec>(o, dout, delta, rows, s);
    case 80: return launch_preprocess<T, 80, kVec>(o, dout, delta, rows, s);
    case 128:
      return launch_preprocess<T, 128, kVec>(o, dout, delta, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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


// ---------------------------------------------------------------------------
// The bf16 tensor-core route: flash_kernel_tc, flash_bwd_dq_kernel_tc and
// flash_bwd_dkdv_kernel_tc (the note at the top of this file says why and
// how; the wrapper chooses them for bfloat16 inputs at d = 64 and 128 with
// at least 64 queries).
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;          // a producer and two consumer
                                         // warpgroups
constexpr int kTcRows = 128;             // a block's own rows, 64 a consumer
constexpr int kTcStages = 2;             // the streamed tiles' ring
constexpr int kTcProducerRegs = 40, kTcConsumerRegs = 232;   // setmaxnreg
static_assert(kTcProducerRegs + 2 * kTcConsumerRegs <=
                  3 * (65536 / kTcThreads / 8 * 8),
              "setmaxnreg moves registers within the block only");

// Tiles of the three kernels at head width D, and their shared memory in
// bytes: 1,024 of slack for the 1,024-byte alignment the swizzle needs, the
// block's own tiles, the ring, and the mbarriers (8 bytes each). A tile of
// T rows lies as D / 64 boxes of 64 columns, each T x 128 bytes, as TMA
// lays them with the 128-byte swizzle.
template <int D>
struct TcLayout {
  static constexpr int BK = 64;                   // forward's key tile
  static constexpr int KT = 64;                   // dq's key tile
  static constexpr int QT = 32;                   // dkdv's query tile
  static constexpr int kRowBytes = 2 * D;         // one bf16 row
  // dkdv's stage: the Q and dO tiles, then lse and D, QT + 4 floats each
  // in slots of whole 128 bytes, rounded up so that the next stage's
  // boxes start on 1,024 bytes
  static constexpr int kLseSlot = ((QT + 4) * 4 + 127) / 128 * 128;
  static constexpr int kDkdvStage =
      (2 * QT * kRowBytes + 2 * kLseSlot + 1023) / 1024 * 1024;
  static constexpr size_t fwd_bytes = 1024 + kTcRows * kRowBytes +
                                      kTcStages * 2 * BK * kRowBytes +
                                      8 * (2 * kTcStages + 1);
  static constexpr size_t dq_bytes = 1024 + 2 * kTcRows * kRowBytes +
                                     kTcStages * 2 * KT * kRowBytes +
                                     8 * (2 * kTcStages + 1);
  static constexpr size_t dkdv_bytes = 1024 + 2 * kTcRows * kRowBytes +
                                       kTcStages * kDkdvStage +
                                       8 * (2 * kTcStages + 1);
  static_assert(D == 64 || D == 128, "the bf16 route takes d = 64 and 128");
  static_assert(fwd_bytes <= 232448 && dq_bytes <= 232448 &&
                    dkdv_bytes <= 232448,
                "the block's shared memory passes 227 KB");
};

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d += A (shared memory, K-major) B (shared memory, K-major); with
  // scale_d 0, d = A B
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // d += A (shared memory, K-major) B (shared memory, K-major); with
  // scale_d 0, d = A B
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d += A (registers: four bf16 pairs a thread) B (shared memory,
  // MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct Wgmma<128> {
  // d += A (shared memory, K-major) B (shared memory, K-major); with
  // scale_d 0, d = A B
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d += A (registers: four bf16 pairs a thread) B (shared memory,
  // MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

// keeps the compiler from reading a wgmma accumulator before the wait that
// completes it (the asm that issues a wgmma writes it only on paper)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// x = hi + mid + lo in three bfloat16 (hi = bf16_rn(x), mid = bf16_rn(x -
// hi), lo = bf16_rn(x - hi - mid); each difference is exact in float32, so
// the three carry all 24 bits of x unless lo falls below bfloat16's
// subnormals), for two floats at once: each piece packed as an A
// fragment's register, the lower column in the low half
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  x -= hf.x;
  y -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - mf.x, y - mf.y));
}

// the three pieces of accumulator columns [16 kc, 16 kc + 16) as the A
// fragments of a k16 step: an m64nN accumulator holds, in d[4 i .. 4 i +
// 3], rows (g, g, g + 8, g + 8) at columns (8 i + 2 t, + 1) of its warp's
// 16 rows, and an A fragment wants rows (g, g + 8, g, g + 8) at columns
// (2 t, + 1) then (2 t + 8, + 9): d[8 kc .. 8 kc + 7] in order, no shuffle
template <int N>
__device__ __forceinline__ void split_chunk(const float (&d)[N], int kc,
                                            uint32_t (&hi)[4],
                                            uint32_t (&mid)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
    split3(d[8 * kc + 2 * x], d[8 * kc + 2 * x + 1], hi[x], mid[x], lo[x]);
}

// descriptors into a tile of T rows laid out as D / 64 swizzled boxes of
// 64 columns: a K-major operand's rows [r0, r0 + 64) (A) or all T rows (B)
// at k16 step kk (32 bytes along a 128-byte row, the next box after four),
// and an MN-major operand's k rows [16 kk, 16 kk + 16) across every column
// (8-row atoms 1,024 bytes apart, boxes T x 128 bytes apart)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int T, int r0,
                                           int kk) {
  return wgmma_desc(tile + (kk / 4) * T * 128 + r0 * 128 + (kk % 4) * 32, 16,
                    1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int T, int kk) {
  return wgmma_desc(tile + kk * 2048, T * 128, 1024);
}

// every tile of T rows of (h, s, D) at row r0 of head `head`: D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int T, int r0,
                                         int head) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    tma_load_3d(dst + b * T * 128, map, bar, 64 * b, r0, head);
}

__device__ __forceinline__ void tc_init_barriers(uint32_t full,
                                                 uint32_t empty,
                                                 uint32_t own) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);       // one arrival per consumer warp
    }
    mbar_init(own, 1);                   // the block's own tiles
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The forward: queries [q0, q0 + 128) of one head, 64 a consumer
// warpgroup, against key tiles of BK streamed through the ring
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int sk, float scale, int causal) {
  using L = TcLayout<D>;
  constexpr int BK = L::BK, NS = BK / 16;
  constexpr uint32_t kTile = BK * L::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + kTcRows * L::kRowBytes;   // + 2 kTile s: K, V
  const uint32_t full = ring + kTcStages * 2 * kTile;   // + 8 s
  const uint32_t empty = full + 8 * kTcStages;          // + 8 s
  const uint32_t own = empty + 8 * kTcStages;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;   // heaviest first
  const int q_off = sk - sq;
  // key tiles up to the first that starts past the block's last query
  const int n_kb = (sk + BK - 1) / BK;
  const int n_tiles =
      causal ? min(n_kb, (q_off + q0 + kTcRows - 1) / BK + 1) : n_kb;
  tc_init_barriers(full, empty, own);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, kTcRows * L::kRowBytes);
      tma_rows<D>(q_s, &map_q, own, kTcRows, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages;
        const uint32_t ks = ring + s * 2 * kTile;
        mbar_wait(empty + 8 * s, ((j / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kTile);
        tma_rows<D>(ks, &map_k, full + 8 * s, BK, j * BK, head);
        tma_rows<D>(ks + kTile, &map_v, full + 8 * s, BK, j * BK, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kTcConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int w = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wq0 = q0 + 64 * c;         // the warpgroup's first query
    const int row = wq0 + 16 * w + g;    // this thread's rows row, row + 8
    const int my_tiles =
        causal ? min(n_kb, (q_off + wq0 + 63) / BK + 1) : n_kb;
    const bool live = wq0 < sq;          // a warpgroup of padding rows idles
    const float scale2 = scale * kLog2e;
    float acc[D / 2], sc[BK / 2];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kTcStages;
      mbar_wait(full + 8 * s, (j / kTcStages) & 1);
      if (live && j < my_tiles) {
        const uint32_t ks = ring + s * 2 * kTile, vs = ks + kTile;
        // S = Q K^T: one bf16 pass, exact products in float32
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BK>::ss(sc, desc_k(q_s, kTcRows, 64 * c, kk),
                        desc_k(ks, BK, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        // mask, online softmax (rows row and row + 8, each over the 4
        // threads of a quad)
        const int k0 = j * BK;
        auto scores = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ki = k0 + 8 * i + 2 * t + (e & 1);
              const int qi = q_off + row + 8 * (e >> 1);
              const bool ok = !decltype(masked)::value ||
                              (ki < sk && (!causal || qi >= ki));
              sc[4 * i + e] = ok ? sc[4 * i + e] * scale2 : kNegInf;
            }
        };
        if (k0 + BK <= sk && (!causal || q_off + wq0 >= k0 + BK - 1))
          scores(std::false_type{});
        else
          scores(std::true_type{});
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float row_max = kNegInf;
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
            row_max = fmaxf(row_max, fmaxf(sc[4 * i + 2 * r],
                                           sc[4 * i + 2 * r + 1]));
          row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
          row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
          const float m_new = fmaxf(m[r], row_max);
          const float alpha = ex2(m[r] - m_new);
          float row_sum = 0.f;
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[4 * i + 2 * r + e] = ex2(sc[4 * i + 2 * r + e] - m_new);
              row_sum += sc[4 * i + 2 * r + e];
            }
          l[r] = l[r] * alpha + row_sum;     // this thread's columns
          m[r] = m_new;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            acc[4 * n + 2 * r] *= alpha;
            acc[4 * n + 2 * r + 1] *= alpha;
          }
        }
        // O += P V: P as hi, mid and lo, three passes, smallest first
        uint32_t ph[NS][4], pm[NS][4], pl[NS][4];
#pragma unroll
        for (int kc = 0; kc < NS; ++kc) split_chunk(sc, kc, ph[kc], pm[kc],
                                                    pl[kc]);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, pl[kc], desc_mn(vs, BK, kc));
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, pm[kc], desc_mn(vs, BK, kc));
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, ph[kc], desc_mn(vs, BK, kc));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int qr = row + 8 * r;
      if (!live || qr >= sq) continue;
      const size_t at = static_cast<size_t>(head) * sq + qr;
      if (lse != nullptr && t == 0)
        lse[at] = (m[r] + log2f(sum)) * 0.6931471805599453f;
      const float denom = fmaxf(sum, 1e-30f);
      __nv_bfloat16* orow = o + at * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + 8 * n, make_float2(acc[4 * n + 2 * r] / denom,
                                         acc[4 * n + 2 * r + 1] / denom));
    }
  }
}

// dQ of queries [q0, q0 + 128) of one head, 64 a consumer warpgroup,
// against key tiles of KT (K and V) streamed through the ring
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int sq, int sk,
                       float scale, int causal) {
  using L = TcLayout<D>;
  constexpr int KT = L::KT, NS = KT / 16;
  constexpr uint32_t kTile = KT * L::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kTcRows * L::kRowBytes;
  const uint32_t ring = do_s + kTcRows * L::kRowBytes;  // + 2 kTile s: K, V
  const uint32_t full = ring + kTcStages * 2 * kTile;
  const uint32_t empty = full + 8 * kTcStages;
  const uint32_t own = empty + 8 * kTcStages;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;   // heaviest first
  const int q_off = sk - sq;
  const int n_kb = (sk + KT - 1) / KT;
  const int n_tiles =
      causal ? min(n_kb, (q_off + q0 + kTcRows - 1) / KT + 1) : n_kb;
  tc_init_barriers(full, empty, own);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * kTcRows * L::kRowBytes);
      tma_rows<D>(q_s, &map_q, own, kTcRows, q0, head);
      tma_rows<D>(do_s, &map_do, own, kTcRows, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages;
        const uint32_t ks = ring + s * 2 * kTile;
        mbar_wait(empty + 8 * s, ((j / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kTile);
        tma_rows<D>(ks, &map_k, full + 8 * s, KT, j * KT, head);
        tma_rows<D>(ks + kTile, &map_v, full + 8 * s, KT, j * KT, head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kTcConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int w = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wq0 = q0 + 64 * c, qw0 = wq0 + 16 * w;
    const int row = qw0 + g;             // this thread's rows row, row + 8
    const int my_tiles =
        causal ? min(n_kb, (q_off + wq0 + 63) / KT + 1) : n_kb;
    const bool live = wq0 < sq;
    const float scale2 = scale * kLog2e;
    const size_t qoff = static_cast<size_t>(head) * sq;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row + 8 * r < sq;
      lse2[r] = ok ? lse[qoff + row + 8 * r] * kLog2e : 0.f;
      dl[r] = ok ? delta[qoff + row + 8 * r] : 0.f;
    }
    float acc[D / 2], sc[KT / 2], dp[KT / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(own, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kTcStages;
      mbar_wait(full + 8 * s, (j / kTcStages) & 1);
      if (live && j < my_tiles) {
        const uint32_t ks = ring + s * 2 * kTile, vs = ks + kTile;
        // S = Q K^T and dP = dO V^T: one bf16 pass each
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<KT>::ss(sc, desc_k(q_s, kTcRows, 64 * c, kk),
                        desc_k(ks, KT, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<KT>::ss(dp, desc_k(do_s, kTcRows, 64 * c, kk),
                        desc_k(vs, KT, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        reg_fence(dp);
        // dS in place of dP: rows row (+ 8), keys k0 + 8 i + 2 t (+ 1); a
        // warp whose tile has no masked entry skips the mask
        const int k0 = j * KT;
        auto form = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < KT / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, qi = row + 8 * r;
              const int ki = k0 + 8 * i + 2 * t + (e & 1);
              const bool ok =
                  !decltype(masked)::value ||
                  (qi < sq && ki < sk && (!causal || q_off + qi >= ki));
              const float p = ex2(sc[4 * i + e] * scale2 - lse2[r]);
              dp[4 * i + e] = ok ? p * (dp[4 * i + e] - dl[r]) : 0.f;
            }
        };
        if (qw0 + 16 <= sq && k0 + KT <= sk &&
            (!causal || q_off + qw0 >= k0 + KT - 1))
          form(std::false_type{});
        else
          form(std::true_type{});
        // dQ += dS K: dS as hi, mid and lo, three passes, smallest first
        uint32_t dh[NS][4], dm[NS][4], dlo[NS][4];
#pragma unroll
        for (int kc = 0; kc < NS; ++kc) split_chunk(dp, kc, dh[kc], dm[kc],
                                                    dlo[kc]);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, dlo[kc], desc_mn(ks, KT, kc));
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, dm[kc], desc_mn(ks, KT, kc));
#pragma unroll
        for (int kc = 0; kc < NS; ++kc)
          Wgmma<D>::rs(acc, dh[kc], desc_mn(ks, KT, kc));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row + 8 * r;
      if (!live || qr >= sq) continue;
      __nv_bfloat16* dqrow = dq + (qoff + qr) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(dqrow + 8 * n, make_float2(acc[4 * n + 2 * r] * scale,
                                          acc[4 * n + 2 * r + 1] * scale));
    }
  }
}

// dK and dV of keys [k0, k0 + 128) of one head at columns [64 z, 64 z +
// 64) (z = blockIdx.z; one block a column box, so that a consumer keeps 64
// columns each of dK and dV in registers at every d), 64 keys a consumer
// warpgroup, against the query tiles of QT that see them (Q, dO, lse and D
// streamed through the ring): S^T = K Q^T and dP^T = V dO^T put P^T and
// dS^T in the accumulator layout, which is already the A fragments of
// dV += P^T dO and dK += dS^T Q
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_lse,
                         const __grid_constant__ CUtensorMap map_delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk,
                         float scale, int causal) {
  using L = TcLayout<D>;
  constexpr int QT = L::QT, NS = QT / 16;
  constexpr uint32_t kTile = QT * L::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kTcRows * L::kRowBytes;
  // + kDkdvStage s: Q, dO, then lse and D in slots of kLseSlot bytes
  const uint32_t ring = v_s + kTcRows * L::kRowBytes;
  const uint32_t full = ring + kTcStages * L::kDkdvStage;
  const uint32_t empty = full + 8 * kTcStages;
  const uint32_t own = empty + 8 * kTcStages;
  const int head = blockIdx.y, cb = blockIdx.z;
  const int k0 = blockIdx.x * kTcRows;
  const int q_off = sk - sq;
  // causal: the first query tile that sees the block's first key holds
  // query k0 - q_off
  const int qb0 = causal ? max(0, k0 - q_off) / QT : 0;
  const int n_qb = (sq + QT - 1) / QT;
  tc_init_barriers(full, empty, own);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * kTcRows * L::kRowBytes);
      tma_rows<D>(k_s, &map_k, own, kTcRows, k0, head);
      tma_rows<D>(v_s, &map_v, own, kTcRows, k0, head);
      for (int qb = qb0; qb < n_qb; ++qb) {
        const int j = qb - qb0, s = j % kTcStages;
        const uint32_t qs = ring + s * L::kDkdvStage;
        // lse and D of the tile's queries from the flat (h sq) rows, in a
        // box of QT + 4 that starts on the 16-byte word holding the first
        // (a box off a word never completes); the consumers skip the
        // first (head sq + q0) % 4, and a ragged tile's tail reads the
        // next head's values, which the mask drops
        const int at = head * sq + qb * QT;
        mbar_wait(empty + 8 * s, ((j / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kTile + 2 * (QT + 4) * 4);
        tma_rows<D>(qs, &map_q, full + 8 * s, QT, qb * QT, head);
        tma_rows<D>(qs + kTile, &map_do, full + 8 * s, QT, qb * QT, head);
        tma_load_1d(qs + 2 * kTile, &map_lse, full + 8 * s, at & ~3);
        tma_load_1d(qs + 2 * kTile + L::kLseSlot, &map_delta, full + 8 * s,
                    at & ~3);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kTcConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int w = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wk0 = k0 + 64 * c, kw0 = wk0 + 16 * w, kw_last = kw0 + 15;
    const int kr = kw0 + g;              // this thread's keys kr, kr + 8
    const float scale2 = scale * kLog2e;
    // the ring as a generic pointer, for lse and D
    const uint8_t* ring_p = smem_raw + (ring - smem_u32(smem_raw));
    float dk_acc[32], dv_acc[32], st[QT / 2], dpt[QT / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) st[i] = dpt[i] = 0.f;
    mbar_wait(own, 0);
    for (int qb = qb0; qb < n_qb; ++qb) {
      const int j = qb - qb0, s = j % kTcStages, q0 = qb * QT;
      mbar_wait(full + 8 * s, (j / kTcStages) & 1);
      // a warpgroup none of whose keys the tile's queries see adds only
      // zeros
      if (wk0 < sk && !(causal && q_off + q0 + QT - 1 < wk0)) {
        const uint32_t qs = ring + s * L::kDkdvStage, dos = qs + kTile;
        // the column box of Q and dO that dK and dV take as B
        const uint32_t qsb = qs + cb * QT * 128, dob = dos + cb * QT * 128;
        const float* lse_s =
            reinterpret_cast<const float*>(ring_p + s * L::kDkdvStage +
                                           2 * kTile) +
            (head * sq + q0) % 4;
        const float* dl_s = lse_s + L::kLseSlot / 4;
        // S^T = K Q^T and dP^T = V dO^T over every column: one bf16 pass
        // each
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<QT>::ss(st, desc_k(k_s, kTcRows, 64 * c, kk),
                        desc_k(qs, QT, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<QT>::ss(dpt, desc_k(v_s, kTcRows, 64 * c, kk),
                        desc_k(dos, QT, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(st);
        reg_fence(dpt);
        // P^T and dS^T in place: rows keys kr (+ 8), columns queries
        // q0 + 8 i + 2 t (+ 1); a warp whose tile has no masked entry
        // skips the mask
        auto form = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < QT / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * i + 2 * t + (e & 1), qi = q0 + col;
              const int ki = kr + 8 * (e >> 1);
              const bool ok =
                  !decltype(masked)::value ||
                  (qi < sq && ki < sk && (!causal || q_off + qi >= ki));
              const float p =
                  ok ? ex2(st[4 * i + e] * scale2 - lse_s[col] * kLog2e)
                     : 0.f;
              st[4 * i + e] = p;
              dpt[4 * i + e] = ok ? p * (dpt[4 * i + e] - dl_s[col]) : 0.f;
            }
        };
        if (q0 + QT <= sq && kw_last < sk &&
            (!causal || q_off + q0 >= kw_last))
          form(std::false_type{});
        else
          form(std::true_type{});
        // dV += P^T dO, then dK += dS^T Q, over this block's 64 columns:
        // each as hi, mid and lo, three passes, smallest first (dV's
        // pieces are waited out before dS's are made, which keeps the
        // consumer within its registers)
        {
          uint32_t hi[NS][4], mid[NS][4], lo[NS][4];
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            split_chunk(st, kc, hi[kc], mid[kc], lo[kc]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dv_acc, lo[kc], desc_mn(dob, QT, kc));
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dv_acc, mid[kc], desc_mn(dob, QT, kc));
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dv_acc, hi[kc], desc_mn(dob, QT, kc));
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dv_acc);
        }
        {
          uint32_t hi[NS][4], mid[NS][4], lo[NS][4];
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            split_chunk(dpt, kc, hi[kc], mid[kc], lo[kc]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dk_acc, lo[kc], desc_mn(qsb, QT, kc));
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dk_acc, mid[kc], desc_mn(qsb, QT, kc));
#pragma unroll
          for (int kc = 0; kc < NS; ++kc)
            Wgmma<64>::rs(dk_acc, hi[kc], desc_mn(qsb, QT, kc));
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(dk_acc);
        }
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    const size_t koff = static_cast<size_t>(head) * sk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kr + 8 * r;
      if (key >= sk) continue;
      __nv_bfloat16* dkrow = dk + (koff + key) * D + 64 * cb + 2 * t;
      __nv_bfloat16* dvrow = dv + (koff + key) * D + 64 * cb + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        store2(dkrow + 8 * n, make_float2(dk_acc[4 * n + 2 * r] * scale,
                                          dk_acc[4 * n + 2 * r + 1] * scale));
        store2(dvrow + 8 * n, make_float2(dv_acc[4 * n + 2 * r],
                                          dv_acc[4 * n + 2 * r + 1]));
      }
    }
  }
}

// a (h, s, d) bfloat16 tensor as a 3-D map in boxes of {64 columns, `rows`
// rows, one head}, 128-byte swizzle: TMA zero-fills rows past s within each
// head, as the float32 kernels zero-fill their tiles
cudaError_t encode_heads_map(CUtensorMap* map, const void* base, int h,
                             int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                    strides, box, true);
}

// n float32 values as a 1-D map in boxes of `box` (lse and D, whose rows
// of sq floats TMA could not address as a 2-D map unless sq % 4 == 0)
cudaError_t encode_flat_map(CUtensorMap* map, const float* base, long long n,
                            int box) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};   // rank 1 has no outer stride
  const cuuint32_t b[1] = {static_cast<cuuint32_t>(box)};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims,
                    strides, b, false);
}

template <typename K>
cudaError_t tc_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_tc_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int h, int sq, int sk, float scale, int causal,
                  cudaStream_t stream) {
  using L = TcLayout<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t rc = encode_heads_map(&mq, q, h, sq, D, kTcRows);
  if (rc == cudaSuccess) rc = encode_heads_map(&mk, k, h, sk, D, L::BK);
  if (rc == cudaSuccess) rc = encode_heads_map(&mv, v, h, sk, D, L::BK);
  if (rc == cudaSuccess) rc = tc_smem(flash_kernel_tc<D>, L::fwd_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((sq + kTcRows - 1) / kTcRows, h);
  flash_kernel_tc<D><<<grid, kTcThreads, L::fwd_bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc_dq(const BwdArgs& a, cudaStream_t stream) {
  using L = TcLayout<D>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t rc = encode_heads_map(&mq, a.q, a.h, a.sq, D, kTcRows);
  if (rc == cudaSuccess) rc = encode_heads_map(&mk, a.k, a.h, a.sk, D, L::KT);
  if (rc == cudaSuccess) rc = encode_heads_map(&mv, a.v, a.h, a.sk, D, L::KT);
  if (rc == cudaSuccess)
    rc = encode_heads_map(&mdo, a.dout, a.h, a.sq, D, kTcRows);
  if (rc == cudaSuccess) rc = tc_smem(flash_bwd_dq_kernel_tc<D>, L::dq_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sq + kTcRows - 1) / kTcRows, a.h);
  flash_bwd_dq_kernel_tc<D><<<grid, kTcThreads, L::dq_bytes, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.sq, a.sk, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc_dkdv(const BwdArgs& a, cudaStream_t stream) {
  using L = TcLayout<D>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdl;
  const long long rows = static_cast<long long>(a.h) * a.sq;
  cudaError_t rc = encode_heads_map(&mq, a.q, a.h, a.sq, D, L::QT);
  if (rc == cudaSuccess)
    rc = encode_heads_map(&mk, a.k, a.h, a.sk, D, kTcRows);
  if (rc == cudaSuccess)
    rc = encode_heads_map(&mv, a.v, a.h, a.sk, D, kTcRows);
  if (rc == cudaSuccess)
    rc = encode_heads_map(&mdo, a.dout, a.h, a.sq, D, L::QT);
  if (rc == cudaSuccess) rc = encode_flat_map(&mlse, a.lse, rows, L::QT + 4);
  if (rc == cudaSuccess) rc = encode_flat_map(&mdl, a.delta, rows, L::QT + 4);
  if (rc == cudaSuccess)
    rc = tc_smem(flash_bwd_dkdv_kernel_tc<D>, L::dkdv_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.sk + kTcRows - 1) / kTcRows, a.h, D / 64);
  flash_bwd_dkdv_kernel_tc<D><<<grid, kTcThreads, L::dkdv_bytes, stream>>>(
      mq, mk, mv, mdo, mlse, mdl, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.sq, a.sk, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the shapes and pointers the bf16 route takes: d 64 or 128, every base
// 16-byte aligned (TMA), h sq and h sk below 2^31 (the flat lse map's
// coordinates are 32-bit)
bool tc_ok(const void* const* ptrs, int n, int h, int sq, int sk, int d,
           int causal) {
  if (h < 0 || h > 65535 || sq < 0 || sk < 1 || (causal && sq > sk) ||
      (d != 64 && d != 128) ||
      static_cast<long long>(h) * (sq > sk ? sq : sk) >= (1LL << 31))
    return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return true;
}

template <bool kDq>
int run_tc_bwd(const BwdArgs& a, int d, void* stream) {
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.lse, a.delta,
                        kDq ? a.dq : a.dk, kDq ? a.dq : a.dv};
  if (!tc_ok(ptrs, 8, a.h, a.sq, a.sk, d, a.causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.h == 0 || a.sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kDq) return d == 64 ? launch_tc_dq<64>(a, s) : launch_tc_dq<128>(a, s);
  return d == 64 ? launch_tc_dkdv<64>(a, s) : launch_tc_dkdv<128>(a, s);
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
// contiguous, any element-aligned base, dtype 0 float32 or 1 bfloat16; d
// 16, 64, 80 or 128; delta float32 (rows,)).
int strela_flash_bwd_preprocess(const void* o, const void* dout, void* delta,
                                long long rows, int d, int dtype,
                                void* stream) {
  if (rows < 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  const bool vec = ((reinterpret_cast<uintptr_t>(o) |
                     reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  if (dtype == 0)
    return vec ? dispatch_preprocess<float, true>(o, dout, out, rows, d, s)
               : dispatch_preprocess<float, false>(o, dout, out, rows, d, s);
  return vec
             ? dispatch_preprocess<__nv_bfloat16, true>(o, dout, out, rows, d,
                                                        s)
             : dispatch_preprocess<__nv_bfloat16, false>(o, dout, out, rows,
                                                         d, s);
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

// The bf16 tensor-core route (bfloat16 q, k, v, o and dout; d 64 or 128;
// every base 16-byte aligned; h max(sq, sk) < 2^31), with the arguments
// and results of strela_flash_attention, strela_flash_bwd_dkdv and
// strela_flash_bwd_dq less the dtype. Returns the CUDA error of the launch
// (0 on success); cudaErrorInvalidValue for what the route does not take.
int strela_flash_attention_tc(const void* q, const void* k, const void* v,
                              void* o, void* lse, int h, int sq, int sk,
                              int d, int causal, float scale, void* stream) {
  const void* ptrs[] = {q, k, v, o, lse};
  if (!tc_ok(ptrs, 5, h, sq, sk, d, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return d == 64
             ? launch_tc_fwd<64>(q, k, v, o, l, h, sq, sk, scale, causal, s)
             : launch_tc_fwd<128>(q, k, v, o, l, h, sq, sk, scale, causal, s);
}

int strela_flash_bwd_dkdv_tc(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int h,
                             int sq, int sk, int d, int causal, float scale,
                             void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, h, sq,
                  sk, scale, causal};
  return run_tc_bwd<false>(a, d, stream);
}

int strela_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int h, int sq, int sk,
                           int d, int causal, float scale, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  h, sq, sk, scale, causal};
  return run_tc_bwd<true>(a, d, stream);
}

}  // extern "C"
