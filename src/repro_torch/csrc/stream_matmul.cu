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
// 5760) the product is 108.7 GFLOP: 1.6 ms at the FP32 units' 67 TFLOP/s;
// in bf16 0.11 ms at the tensor cores' 989 TFLOP/s against 0.042 ms for
// its 139.8 MB (bf16 A and B read once, f32 C written once); at
// granite-moe-3b-a800m's unpadded LM head (4096 x 1536 x 49155, N % 8 = 3)
// 618.5 GFLOP, 0.625 ms, against 0.29 ms for its 0.97 GB (f32 C). Three
// routes, chosen by the caller (kernels/stream_matmul.py::route) and
// checked here:
//
//   * "sgemm", float32 inputs: sgemm_kernel, an SGEMM on the FP32 units. A
//     128 x 128 output tile per block of 256 threads, two blocks per SM (at
//     most 128 registers a thread). A 4-stage cp.async ring of 16-deep k
//     tiles in dynamic shared memory, one barrier per tile; A is transposed
//     on the way in by 4-byte copies, B copied as it lies (16-byte copies
//     where its rows allow). Warps tile the block 2 x 4; each thread holds
//     8 x 8 sums, and every float4 a warp reads from shared memory serves
//     several of its threads. Blocks are rasterised in groups of 8 M tiles,
//     so blocks running together share B tiles in L2 (B alone is 53 MB at
//     the main path's shape, more than the 50 MB L2). No TF32: the
//     reference tolerance is 1e-4, and TF32 keeps about three digits.
//   * "wgmma", bfloat16 inputs whose rows TMA can address (K % 8 == 0,
//     N % 8 == 0, A and B 16-byte aligned): wgmma_gemm_kernel. A 128 x 256
//     output tile per block of three warpgroups. One producer thread keeps
//     a 4-stage ring of 48 KB stages (A: one {64 k, 128 m} TMA box; B: four
//     {64 n, 64 k} boxes, (K,N) row-major as it lies in device memory)
//     full, all with 128-byte swizzle; a "full" mbarrier per stage counts
//     the bytes in, an "empty" one the eight consumer warps out. Two
//     consumer warpgroups each run wgmma.mma_async m64n256k16 over 64 rows
//     (A K-major, B MN-major through the transpose bit), keep one
//     wgmma group in flight and release a stage once the group reading it
//     is done; setmaxnreg moves registers from the producer (40) to them
//     (232) for their 128 fp32 accumulators. TMA zero-fills the ragged M,
//     N and K edges, so the sums equal those of the zero-padded Pallas
//     inputs; the epilogue stores from the accumulator fragments, masked at
//     the M/N edges. Blocks walk M fastest, so neighbours share a B tile in
//     L2. The TMA descriptors are encoded on the host per call
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//     that the library needs no -lcuda) and passed as __grid_constant__.
//   * "wgmma_realign", every other bfloat16 case (K % 8 != 0, N % 8 != 0
//     or a base address off 16-byte alignment): repack_rows_kernel copies
//     each operand TMA cannot address as it lies into device scratch the
//     caller provides, rows rounded up to 8 elements from a 16-byte aligned
//     base (each 16-byte word shifted into place from two aligned words of
//     the source by the row's element offset), then wgmma_gemm_kernel
//     reads the copies through maps that end at the operand's last column,
//     so TMA's zero fill still gives the padded sums. The copy moves each
//     copied operand's bytes twice more (read and written once: 94 MB, some
//     0.03 ms at 3.35 TB/s, for A at 4096 x 2304 x 5760). It replaced an
//     mma.sync kernel (128 x 128 x 32 tiles, single-buffered, 8 predicated
//     2-byte loads per unaligned 16 bytes), 4.6x cuBLAS at 4096 x 2304 x
//     5760 and 1.46 ms there with A off alignment.
//
// The Pallas kernel carries its sum in a VMEM scratch accumulator across the
// sequential k axis of its grid; here each block loops over K itself. The
// Pallas wrapper zero-pads A and B to block multiples in device memory; here
// the sgemm route masks the ragged M, N and K edges in its loads (zero
// fill) and stores, the wgmma routes let TMA fill them, which gives the
// same sums without padded copies (the realign route's copies keep each
// operand's shape, only its rows move).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, wgmma descriptors, tensor maps

namespace {

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
// float32: SGEMM on the FP32 units, a cp.async ring of k tiles
// ---------------------------------------------------------------------------

constexpr int kSBM = 128, kSBN = 128, kSBK = 16, kSStages = 4;
constexpr int kSThreads = 256;
constexpr int kSGroupM = 8;           // M tiles per rasterisation group
constexpr int kSAStride = kSBM + 4;   // As[k][m]: rows 16-byte aligned, the
                                      // transposing copies conflict-free
constexpr int kSAStage = kSBK * kSAStride;   // floats per stage
constexpr int kSBStage = kSBK * kSBN;
constexpr size_t kSSmem =
    sizeof(float) * kSStages * (kSAStage + kSBStage);
static_assert(kSBK % 8 == 0 && kSThreads == 256 && kSBM == 128 &&
              kSBN == 128, "the copy and fragment maps assume these");

// kBytes from src to shared dst by cp.async; src_bytes 0 fills zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One k tile [k0, k0 + kSBK) into a stage, zero past M, N and K: A
// transposed into As[k][m] by 4-byte copies (each warp copies 4 rows x 8 k,
// 32-byte row segments, onto 32 distinct banks), B as it lies into
// Bs[k][n], by 16-byte copies where its rows allow (kB16), else by 4-byte
// ones. a_src: this thread's first A element (row m0 + t / 8, column
// t % 8); a_rows: bit j set when its row m0 + t / 8 + 32 j is below M. A
// zero-filling copy names A's or B's first element as its source.
template <bool kB16>
__device__ __forceinline__ void sgemm_stage(float* As, float* Bs,
                                            const float* A,
                                            const float* a_src, int a_rows,
                                            const float* B, int N, int K,
                                            int n0, int k0, int t) {
  constexpr int kKG = kSBK / 8;          // groups of 8 k per A row
  const int ak = t % 8, am = t / 8;
#pragma unroll
  for (int j = 0; j < 4 * kKG; ++j) {
    const int k = ak + 8 * (j % kKG), m = am + 32 * (j / kKG);
    const bool ok = (a_rows >> (j / kKG) & 1) && k0 + k < K;
    const float* src = a_src + static_cast<size_t>(32 * (j / kKG)) * K +
                       k0 + 8 * (j % kKG);
    cp_async<4>(As + k * kSAStride + m, ok ? src : A, ok ? 4 : 0);
  }
  if constexpr (kB16) {
#pragma unroll
    for (int j = 0; j < kSBK * kSBN / 4 / kSThreads; ++j) {
      const int idx = t + kSThreads * j;
      const int kb = idx / (kSBN / 4), nb = (idx % (kSBN / 4)) * 4;
      const bool ok = k0 + kb < K && n0 + nb < N;
      const float* src = B + static_cast<size_t>(k0 + kb) * N + n0 + nb;
      cp_async<16>(Bs + kb * kSBN + nb, ok ? src : B, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSBK * kSBN / kSThreads; ++j) {
      const int idx = t + kSThreads * j;
      const int kb = idx / kSBN, nb = idx % kSBN;
      const bool ok = k0 + kb < K && n0 + nb < N;
      const float* src = B + static_cast<size_t>(k0 + kb) * N + n0 + nb;
      cp_async<4>(Bs + kb * kSBN + nb, ok ? src : B, ok ? 4 : 0);
    }
  }
}

// A 128 x 128 tile of C per block of 256 threads, two blocks per SM. The
// eight warps tile it 2 (M) x 4 (N), 64 x 32 each; a warp's threads sit 8
// (M) x 4 (N), each holding 8 x 8 sums (rows r..r+3 and r+32..r+35, columns
// c..c+3 and c+16..c+19), so each float4 a warp reads from shared memory
// serves 4 (A) or 8 (B) threads at once. A kSStages-deep ring of kSBK-deep
// k tiles: one cp.async group per tile, one barrier per tile. The k loop is
// unrolled, and the compiler's schedule loads step k + 1's fragments while
// step k multiplies. At two blocks per SM ptxas has 128 registers a thread
// and this loop needs all of them: a second fragment buffer written out by
// hand, pointers stepped through the tile, 32-deep tiles or A kept
// row-major each made it spill, and each ran 4-25% slower.
template <typename OutT, bool kB16>
__global__ void __launch_bounds__(kSThreads, 2)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             OutT* __restrict__ C, int M, int N, int K, bool vec_c) {
  extern __shared__ __align__(16) float ssm[];
  float* As = ssm;                            // kSStages x kSAStage
  float* Bs = ssm + kSStages * kSAStage;      // kSStages x kSBStage

  // rasterise: within a group of kSGroupM M tiles, M walks fastest, so the
  // blocks running together share their B tiles in L2
  const int tiles_m = (M + kSBM - 1) / kSBM, tiles_n = (N + kSBN - 1) / kSBN;
  const int per_group = kSGroupM * tiles_n;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kSGroupM;
  const int group_m = min(tiles_m - first_m, kSGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % group_m) * kSBM;
  const int n0 = in_group / group_m * kSBN;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int ra = (warp / 4) * 64 + (lane / 4) * 4;   // A fragment rows
  const int cb = (warp % 4) * 32 + (lane % 4) * 4;   // B fragment columns

  int a_rows = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a_rows |= (m0 + t / 8 + 32 * j < M) << j;
  const float* a_src =
      A + static_cast<size_t>(a_rows & 1 ? m0 + t / 8 : 0) * K + t % 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kSBK - 1) / kSBK;
#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < n_k)
      sgemm_stage<kB16>(As + s * kSAStage, Bs + s * kSBStage, A, a_src,
                         a_rows, B, N, K, n0, s * kSBK, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kSStages - 2>();    // this thread's copies of tile kt
    __syncthreads();                  // everyone's; and tile kt - 1 is read
    const int nk = kt + kSStages - 1;
    if (nk < n_k) {
      const int slot = nk % kSStages;
      sgemm_stage<kB16>(As + slot * kSAStage, Bs + slot * kSBStage, A,
                         a_src, a_rows, B, N, K, n0, nk * kSBK, t);
    }
    cp_async_commit();
    const float* as = As + (kt % kSStages) * kSAStage;
    const float* bs = Bs + (kt % kSStages) * kSBStage;
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + k * kSAStride + ra);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * kSAStride + ra + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kSBN + cb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * kSBN + cb + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ra + (i < 4 ? i : 28 + i);
    if (row >= M) continue;
    OutT* c_row = C + static_cast<size_t>(row) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + cb + 16 * half;
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

template <typename OutT, bool kB16>
int launch_sgemm(const float* A, const float* B, OutT* C, int M, int N,
                 int K, bool vec_c, cudaStream_t s) {
  const long long blocks = static_cast<long long>((M + kSBM - 1) / kSBM) *
                           ((N + kSBN - 1) / kSBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      sgemm_kernel<OutT, kB16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  sgemm_kernel<OutT, kB16><<<static_cast<unsigned>(blocks), kSThreads,
                              kSSmem, s>>>(A, B, C, M, N, K, vec_c);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 through TMA and wgmma: a warp-specialised ring of tiles
// ---------------------------------------------------------------------------

constexpr int kWBM = 128, kWBN = 256, kWBK = 64, kWStages = 4;
constexpr int kWThreads = 384;                // producer + two consumers
constexpr int kWABytes = kWBM * kWBK * 2;     // 16 KB: one {64 k, 128 m} box
constexpr int kWBBox = kWBK * 64 * 2;         // 8 KB: one {64 n, 64 k} box
constexpr int kWBBytes = (kWBN / 64) * kWBBox;  // 32 KB
constexpr size_t kWSmem =
    1024 + kWStages * (kWABytes + kWBBytes) + 2 * kWStages * 8;
// registers each thread of a block starts with (65,536 over 384, in steps
// of 8); setmaxnreg moves them between the warpgroups of the block only, so
// the producer's and the two consumers' counts add up to three times this
constexpr int kWStartRegs = 65536 / kWThreads / 8 * 8;
static_assert(40 + 2 * 232 <= 3 * kWStartRegs, "wgmma_gemm_kernel's split");

// D (64 x 256, fp32, 128 registers a thread) += A (64 x 16, K-major) *
// B (16 x 256, MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n256k16(float d[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(1));
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float x, float y);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float x,
                                                  float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A warpgroup's 64 x 256 sums (rows 64 c .. 64 c + 63 of the tile) into
// C, masked at the M and N edges. `pairs`: N is even (and C aligned to a
// pair), so a pair of columns lies wholly inside or wholly outside the
// matrix and goes out as one 8-byte (f32) or 4-byte (bf16) store.
template <typename OutT>
__device__ __forceinline__ void wgmma_store(float (&d)[128], int c, OutT* C,
                                            int M, int N, int m0, int n0,
                                            bool pairs) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
  // fragment i of m64nNk16: row 16 warp + lane / 4 (+ 8), column
  // 8 (i / 4) + 2 (lane % 4) (+ 1)
  const int rows[2] = {m0 + c * 64 + warp * 16 + lane / 4,
                       m0 + c * 64 + warp * 16 + lane / 4 + 8};
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = col0 + 8 * i;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= M) continue;
      OutT* p = C + static_cast<size_t>(rows[h]) * N + col;
      if (pairs) {
        store_pair(p, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      } else {
        store_out(p, d[4 * i + 2 * h]);
        if (col + 1 < N) store_out(p + 1, d[4 * i + 2 * h + 1]);
      }
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kWThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  OutT* __restrict__ C, int M, int N, int K, bool pairs) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_smem = base;                          // + s * kWABytes
  const uint32_t b_smem = base + kWStages * kWABytes;    // + s * kWBBytes
  const uint32_t full = b_smem + kWStages * kWBBytes;    // + 8 s
  const uint32_t empty = full + 8 * kWStages;            // + 8 s
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * kWBM, n0 = blockIdx.y * kWBN;
  const int n_k = (K + kWBK - 1) / kWBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // B boxes wholly past N are not loaded: they feed only masked columns
      const int n_boxes = min(kWBN / 64, (N - n0 + 63) / 64);
      const uint32_t bytes = kWABytes + n_boxes * kWBBox;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kWStages;
        mbar_wait(empty + 8 * s, ((kt / kWStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        tma_load_2d(a_smem + s * kWABytes, &map_a, full + 8 * s, kt * kWBK,
                    m0);
        for (int j = 0; j < n_boxes; ++j)
          tma_load_2d(b_smem + s * kWBBytes + j * kWBBox, &map_b,
                      full + 8 * s, n0 + 64 * j, kt * kWBK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;   // consumers: rows 64 c .. 64 c + 63 of the tile
    const int lane = threadIdx.x % 32;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kWStages;
      mbar_wait(full + 8 * s, (kt / kWStages) & 1);
      // A: K-major, 128-byte rows, 8-row atoms 1024 B apart (SBO); a k16
      // step is 32 B along the row. B: MN-major, 8-row (k) atoms 1024 B
      // apart (SBO), 64-column boxes 8 KB apart (LBO); a k16 step is 16
      // rows, 2048 B.
      const uint64_t da =
          wgmma_desc(a_smem + s * kWABytes + c * 64 * 128, 16, 1024);
      const uint64_t db = wgmma_desc(b_smem + s * kWBBytes, kWBBox, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk)
        wgmma_m64n256k16(d, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();                 // the previous stage's group is done
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kWStages));
    }
    wgmma_wait<0>();
    wgmma_store(d, c, C, M, N, m0, n0, pairs);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 rows TMA cannot address as they lie: copied into aligned rows
// ---------------------------------------------------------------------------
//
// A tensor map needs a 16-byte aligned base and row strides of 16-byte
// multiples, which A (M,K) lacks when K % 8 != 0 or its base is off, and B
// (K,N) when N % 8 != 0 or its base is off. repack_rows_kernel copies such
// an operand into scratch whose rows are ld = cols rounded up to 8
// elements apart, from a 16-byte aligned base; the wgmma kernel then reads
// the copy through a map of cols columns with that stride, so TMA still
// zero-fills past the last column and row. A row's element offset e is a
// whole number of elements, so each 16-byte word of the copy is elements
// e % 8 .. e % 8 + 7 of the two aligned words of the source holding
// element e (realign8: two selects and a funnel shift on 32-bit words).
// Columns cols .. ld - 1 of the copy take whatever follows the row (the
// next row's first elements, or zeros past the operand's last word): no
// map reads them. No word past the operand's last is read.
constexpr int kPThreads = 256;              // repack_rows_kernel's block
constexpr int kPRows = 65535;               // grid rows, at most

// elements s .. s + 7 of the 16 consecutive bf16 in (lo, hi), s in 0 .. 7
__device__ __forceinline__ uint4 realign8(uint4 lo, uint4 hi, uint32_t s) {
  uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool by4 = s & 4, by2 = s & 2;
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = by4 ? x[i + 2] : x[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = by2 ? x[i + 1] : x[i];
  const uint32_t sh = (s & 1) * 16;
  return make_uint4(__funnelshift_r(x[0], x[1], sh),
                    __funnelshift_r(x[1], x[2], sh),
                    __funnelshift_r(x[2], x[3], sh),
                    __funnelshift_r(x[3], x[4], sh));
}

// word x of row r of the copy (ld8 = ld / 8 words a row) from `src`, the
// aligned word holding the operand's first element, `off` elements into
// it; the operand spans src_words words
__global__ void __launch_bounds__(kPThreads)
repack_rows_kernel(const uint4* __restrict__ src, int off,
                   uint4* __restrict__ dst, int rows, int cols, int ld8,
                   long long src_words) {
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int x = blockIdx.x * kPThreads + threadIdx.x; x < ld8;
         x += gridDim.x * kPThreads) {
      const long long e = off + static_cast<long long>(r) * cols + 8 * x;
      const long long q = e >> 3;
      const uint32_t s = e & 7;
      const uint4 lo = __ldg(src + q);
      const uint4 hi = s != 0 && q + 1 < src_words ? __ldg(src + q + 1)
                                                   : make_uint4(0, 0, 0, 0);
      dst[static_cast<long long>(r) * ld8 + x] = realign8(lo, hi, s);
    }
  }
}

// cuTensorMapEncodeTiled and the bf16 tensor maps: hopper.cuh

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

long long round8(int n) { return (static_cast<long long>(n) + 7) / 8 * 8; }

// C = A @ B on the wgmma kernel, rows of A lda and rows of B ldb elements
// apart (each a multiple of 8, both bases 16-byte aligned)
template <typename OutT>
int launch_wgmma(const void* a, long long lda, const void* b, long long ldb,
                 void* c, int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_a = {}, map_b = {};
  cudaError_t rc = cudaSuccess;
  if (K > 0) {   // at K = 0 no k step runs, and no map of 0 columns exists
    rc = encode_bf16_map(&map_a, a, M, K, kWBM, kWBK, lda);
    if (rc == cudaSuccess)
      rc = encode_bf16_map(&map_b, b, K, N, kWBK, 64, ldb);
  }
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(wgmma_gemm_kernel<OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kWSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // a pair of columns goes out as one store where N is even and C's base
  // is aligned to the pair
  const bool pairs =
      N % 2 == 0 && reinterpret_cast<uintptr_t>(c) % (2 * sizeof(OutT)) == 0;
  const dim3 grid((M + kWBM - 1) / kWBM, (N + kWBN - 1) / kWBN);
  wgmma_gemm_kernel<OutT><<<grid, kWThreads, kWSmem, s>>>(
      map_a, map_b, static_cast<OutT*>(c), M, N, K, pairs);
  return static_cast<int>(cudaGetLastError());
}

// the (rows, cols) bfloat16 matrix at p into dst, rows round8(cols)
// elements apart
cudaError_t repack_rows(const void* p, int rows, int cols, void* dst,
                        cudaStream_t s) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(at & 15) / 2;
  const int ld8 = static_cast<int>(round8(cols) / 8);
  const long long src_words =
      (off + static_cast<long long>(rows) * cols + 7) / 8;
  const dim3 grid((ld8 + kPThreads - 1) / kPThreads,
                  rows < kPRows ? rows : kPRows);
  repack_rows_kernel<<<grid, kPThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(at & ~uintptr_t{15}), off,
      static_cast<uint4*>(dst), rows, cols, ld8, src_words);
  return cudaGetLastError();
}

// the scratch bytes of the realign route: a copy of each operand TMA
// cannot address as it lies, A's first
long long realign_scratch(const void* a, const void* b, int M, int N,
                          int K) {
  if (K == 0) return 0;
  return (K % 8 == 0 && aligned16(a) ? 0 : 2 * M * round8(K)) +
         (N % 8 == 0 && aligned16(b) ? 0 : 2 * K * round8(N));
}

// the realign route: each operand TMA cannot address as it lies is copied
// into the scratch (repack_rows), then the wgmma kernel reads the copies
template <typename OutT>
int launch_realign(const void* a, const void* b, void* c, int M, int N,
                   int K, void* scratch, cudaStream_t s) {
  uint8_t* next = static_cast<uint8_t*>(scratch);
  long long lda = K, ldb = N;
  cudaError_t rc = cudaSuccess;
  if (K > 0 && !(K % 8 == 0 && aligned16(a))) {
    lda = round8(K);
    rc = repack_rows(a, M, K, next, s);
    a = next;
    next += 2 * M * lda;
  }
  if (rc == cudaSuccess && K > 0 && !(N % 8 == 0 && aligned16(b))) {
    ldb = round8(N);
    rc = repack_rows(b, K, N, next, s);
    b = next;
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return launch_wgmma<OutT>(a, lda, b, ldb, c, M, N, K, s);
}

}  // namespace

extern "C" {

// dtype codes shared with kernels/stream_matmul.py: 0 float32, 1 bfloat16;
// route codes: 0 sgemm (float32 inputs), 2 wgmma and 3 wgmma_realign
// (bfloat16 inputs); code 1, the retired mma.sync route, is refused.
// A (M,K), B (K,N) and C (M,N) are contiguous row-major on the device; A
// and B share in_dtype. A route whose conditions fail is refused
// (wgmma: K >= 1, K % 8 == 0, N % 8 == 0, A, B and C 16-byte aligned;
// wgmma_realign takes every bfloat16 input, given 16-byte aligned device
// scratch of scratch_bytes >= strela_stream_matmul_scratch's count; the
// other routes ignore the scratch). Returns the CUDA error of the launch
// (0 on success).
int strela_stream_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, int in_dtype, int out_dtype, int route,
                         void* scratch, long long scratch_bytes,
                         void* stream) {
  if (M < 0 || N < 0 || K < 0 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || route < 0 || route > 3 ||
      route == 1 || (in_dtype == 0) != (route == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2 && !(K >= 1 && K % 8 == 0 && N % 8 == 0 && aligned16(a) &&
                      aligned16(b) && aligned16(c)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  if (route == 3 && (!aligned16(scratch) ||
                     scratch_bytes < realign_scratch(a, b, M, N, K)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    const bool b16 = N % 4 == 0 && aligned16(b);
    const bool vec_c = N % 4 == 0 && aligned16(c);
    if (out_dtype == 0) {
      float* C = static_cast<float*>(c);
      return b16 ? launch_sgemm<float, true>(A, B, C, M, N, K, vec_c, s)
                 : launch_sgemm<float, false>(A, B, C, M, N, K, vec_c, s);
    }
    __nv_bfloat16* C = static_cast<__nv_bfloat16*>(c);
    return b16 ? launch_sgemm<__nv_bfloat16, true>(A, B, C, M, N, K, false, s)
               : launch_sgemm<__nv_bfloat16, false>(A, B, C, M, N, K, false,
                                                    s);
  }
  if ((N + kWBN - 1) / kWBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2)
    return out_dtype == 0
               ? launch_wgmma<float>(a, K, b, N, c, M, N, K, s)
               : launch_wgmma<__nv_bfloat16>(a, K, b, N, c, M, N, K, s);
  return out_dtype == 0
             ? launch_realign<float>(a, b, c, M, N, K, scratch, s)
             : launch_realign<__nv_bfloat16>(a, b, c, M, N, K, scratch, s);
}

// the device scratch bytes strela_stream_matmul's wgmma_realign route
// needs for these bfloat16 operands (0 for an empty product)
long long strela_stream_matmul_scratch(const void* a, const void* b, int M,
                                       int N, int K) {
  if (M <= 0 || N <= 0 || K < 0) return 0;
  return realign_scratch(a, b, M, N, K);
}

}  // extern "C"
