// stream_matmul.cu — C = A @ B as hand-written CUDA kernels for Hopper
// (sm_90a), with a plain C interface (loaded through ctypes by
// kernels/_build.py).
//
// Replaces the Pallas TPU kernel repro/kernels/stream_matmul.py::stream_matmul
// (body _mm_kernel, pallas_call at line 68): A (M,K) times B (K,N), fp32
// accumulation over K, the result written as out_dtype (float32 or
// bfloat16). Entry point strela_stream_matmul.
//
// Bound on the H100: operations. At the main path's shape (4096 x 2304 x
// 5760) the product is 108.7 GFLOP against 185 MB of traffic: 1.6 ms at the
// FP32 units' 67 TFLOP/s against 0.055 ms of memory; in bf16 0.11 ms at the
// tensor cores' 989 TFLOP/s against 0.042 ms. The design therefore keeps the
// arithmetic units fed from shared memory and registers:
//
//   * float32 inputs: sgemm_kernel, a shared-memory-tiled SGEMM on the FP32
//     units. A 128 x 128 output tile per block of 256 threads, each thread
//     holding an 8 x 8 register block (two 4-wide halves 64 apart, so its
//     float4 reads of shared memory are conflict-free). No TF32: the
//     reference tolerance is 1e-4, and TF32 keeps about three digits.
//   * bfloat16 inputs: bf16_gemm_kernel, mma.sync m16n8k16 on the tensor
//     cores with fp32 accumulators. 128 x 128 x 32 tiles, eight warps of
//     64 x 32 each; fragments come from shared memory by ldmatrix (.trans
//     for B, which stays row-major (K,N) in shared memory).
//
// The Pallas kernel carries its sum in a VMEM scratch accumulator across the
// sequential k axis of its grid; here each block loops over K itself, with
// the next tile's global loads issued into registers before the current
// tile's arithmetic. The Pallas wrapper zero-pads A and B to block
// multiples in device memory; here the ragged M, N and K edges are masked in
// the loads (zero fill) and stores, which gives the same sums without the
// copies. Vector loads are used where rows are 16-byte aligned; otherwise
// each element is loaded alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// flags: which operands take 16-byte vector loads / stores
constexpr int kVecA = 1, kVecB = 2, kVecC = 4;

template <typename OutT>
__device__ __forceinline__ void store_out(OutT* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p,
                                                         float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// float32: register-blocked SGEMM on the FP32 units
// ---------------------------------------------------------------------------

constexpr int kSBM = 128, kSBN = 128, kSBK = 8, kSThreads = 256;
constexpr int kSAStride = kSBM + 4;  // As[k][m]: transposed stores stay
                                     // conflict-free, rows 16-byte aligned

// four consecutive floats of one row from column c, zero past `lim`
__device__ __forceinline__ float4 load4_f32(const float* row, int c, int lim,
                                            bool ok, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok || c >= lim) return v;
  if (vec) return *reinterpret_cast<const float4*>(row + c);
  v.x = row[c];
  if (c + 1 < lim) v.y = row[c + 1];
  if (c + 2 < lim) v.z = row[c + 2];
  if (c + 3 < lim) v.w = row[c + 3];
  return v;
}

template <typename OutT>
__global__ void __launch_bounds__(kSThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             OutT* __restrict__ C, int M, int N, int K, int flags) {
  __shared__ __align__(16) float As[kSBK][kSAStride];
  __shared__ __align__(16) float Bs[kSBK][kSBN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const bool vec_a = flags & kVecA, vec_b = flags & kVecB;

  // this thread's share of each tile: one float4 of A, one of B
  const int a_m = t / 2, a_k = (t % 2) * 4;      // A tile: 128 rows x 8
  const int b_k = t / 32, b_n = (t % 32) * 4;    // B tile: 8 rows x 128
  const bool a_ok = m0 + a_m < M;
  const float* a_row = A + static_cast<size_t>(a_ok ? m0 + a_m : 0) * K;
  const bool bn_ok = n0 + b_n < N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kSBK - 1) / kSBK;
  float4 ra = load4_f32(a_row, a_k, K, a_ok, vec_a);
  float4 rb = load4_f32(B + static_cast<size_t>(b_k) * N, n0 + b_n, N,
                        bn_ok && b_k < K, vec_b);
  for (int kt = 0; kt < n_k; ++kt) {
    As[a_k + 0][a_m] = ra.x;
    As[a_k + 1][a_m] = ra.y;
    As[a_k + 2][a_m] = ra.z;
    As[a_k + 3][a_m] = ra.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = rb;
    __syncthreads();
    if (kt + 1 < n_k) {                  // next tile's loads in flight
      const int k0 = (kt + 1) * kSBK;
      ra = load4_f32(a_row, k0 + a_k, K, a_ok, vec_a);
      rb = load4_f32(B + static_cast<size_t>(k0 + b_k) * N, n0 + b_n, N,
                     bn_ok && k0 + b_k < K, vec_b);
    }
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec_c = flags & kVecC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    OutT* c_row = C + static_cast<size_t>(row) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if constexpr (std::is_same<OutT, float>::value) {
        if (vec_c && col + 3 < N) {
          *reinterpret_cast<float4*>(c_row + col) =
              make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                          acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < N) store_out(c_row + col + j, acc[i][half * 4 + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores, fp32 accumulators
// ---------------------------------------------------------------------------

constexpr int kHBM = 128, kHBN = 128, kHBK = 32, kHThreads = 256;
constexpr int kHAStride = kHBK + 8;   // 80-byte rows: ldmatrix conflict-free
constexpr int kHBStride = kHBN + 8;   // 272-byte rows: ldmatrix conflict-free

// eight consecutive bf16 of one row from column c, zero past `lim`
__device__ __forceinline__ uint4 load8_bf16(const uint16_t* row, int c,
                                            int lim, bool ok, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || c >= lim) return v;
  if (vec) return *reinterpret_cast<const uint4*>(row + c);
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = c + j < lim ? row[c + j] : 0u;
  v.x = e[0] | (e[1] << 16);
  v.y = e[2] | (e[3] << 16);
  v.z = e[4] | (e[5] << 16);
  v.w = e[6] | (e[7] << 16);
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__global__ void __launch_bounds__(kHThreads)
bf16_gemm_kernel(const uint16_t* __restrict__ A,
                 const uint16_t* __restrict__ B, OutT* __restrict__ C, int M,
                 int N, int K, int flags) {
  __shared__ __align__(16) uint16_t As[kHBM * kHAStride];   // [m][k]
  __shared__ __align__(16) uint16_t Bs[kHBK * kHBStride];   // [k][n]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wm = warp / 4, wn = warp % 4;        // 2 x 4 warps of 64 x 32
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * kHBM, n0 = blockIdx.x * kHBN;
  const bool vec_a = flags & kVecA, vec_b = flags & kVecB;

  // each tile is 512 vectors of 8 bf16; every thread loads two of A, two
  // of B. A vector v: row v / 4, k (v % 4) * 8. B vector v: k v / 16,
  // column (v % 16) * 8.
  int a_row[2], a_col[2], b_row[2], b_col[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int v = t + u * kHThreads;
    a_row[u] = v / 4;
    a_col[u] = (v % 4) * 8;
    b_row[u] = v / 16;
    b_col[u] = (v % 16) * 8;
  }
  uint4 ra[2], rb[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + a_row[u];
      ra[u] = load8_bf16(A + static_cast<size_t>(m < M ? m : 0) * K,
                         k0 + a_col[u], K, m < M, vec_a);
      const int k = k0 + b_row[u];
      rb[u] = load8_bf16(B + static_cast<size_t>(k < K ? k : 0) * N,
                         n0 + b_col[u], N, k < K, vec_b);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int n_k = (K + kHBK - 1) / kHBK;
  load_tiles(0);
  for (int kt = 0; kt < n_k; ++kt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      *reinterpret_cast<uint4*>(&As[a_row[u] * kHAStride + a_col[u]]) = ra[u];
      *reinterpret_cast<uint4*>(&Bs[b_row[u] * kHBStride + b_col[u]]) = rb[u];
    }
    __syncthreads();
    if (kt + 1 < n_k) load_tiles((kt + 1) * kHBK);
#pragma unroll
    for (int kk = 0; kk < kHBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &As[(wm * 64 + mi * 16 + (lane & 15)) * kHAStride
                                + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[(kk + (lane & 15)) * kHBStride + wn * 32 +
                                 nj * 16 + (lane >> 4) * 8]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      OutT* c_row = C + static_cast<size_t>(row) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * tig;
        if (col < N) store_out(c_row + col, acc[mi][ni][2 * half]);
        if (col + 1 < N) store_out(c_row + col + 1, acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// dtype codes shared with kernels/stream_matmul.py: 0 float32, 1 bfloat16.
// A (M,K), B (K,N) and C (M,N) are contiguous row-major on the device; A
// and B share in_dtype. Returns the CUDA error of the launch (0 on success).
int strela_stream_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, int in_dtype, int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    const int grid_y = (M + kSBM - 1) / kSBM;
    if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kSBN - 1) / kSBN, grid_y);
    int flags = 0;
    if (K % 4 == 0 && aligned16(a)) flags |= kVecA;
    if (N % 4 == 0 && aligned16(b)) flags |= kVecB;
    if (N % 4 == 0 && aligned16(c) && out_dtype == 0) flags |= kVecC;
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    if (out_dtype == 0)
      sgemm_kernel<float><<<grid, kSThreads, 0, s>>>(
          A, B, static_cast<float*>(c), M, N, K, flags);
    else
      sgemm_kernel<__nv_bfloat16><<<grid, kSThreads, 0, s>>>(
          A, B, static_cast<__nv_bfloat16*>(c), M, N, K, flags);
  } else {
    const int grid_y = (M + kHBM - 1) / kHBM;
    if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kHBN - 1) / kHBN, grid_y);
    int flags = 0;
    if (K % 8 == 0 && aligned16(a)) flags |= kVecA;
    if (N % 8 == 0 && aligned16(b)) flags |= kVecB;
    const uint16_t* A = static_cast<const uint16_t*>(a);
    const uint16_t* B = static_cast<const uint16_t*>(b);
    if (out_dtype == 0)
      bf16_gemm_kernel<float><<<grid, kHThreads, 0, s>>>(
          A, B, static_cast<float*>(c), M, N, K, flags);
    else
      bf16_gemm_kernel<__nv_bfloat16><<<grid, kHThreads, 0, s>>>(
          A, B, static_cast<__nv_bfloat16*>(c), M, N, K, flags);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
