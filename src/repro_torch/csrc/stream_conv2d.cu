// stream_conv2d.cu — the 'valid' 3x3 correlation as a hand-written CUDA
// kernel for Hopper (sm_90a), with a plain C interface (loaded through
// ctypes by kernels/_build.py).
//
// Replaces the Pallas TPU kernel repro/kernels/stream_conv2d.py::
// stream_conv2d (body _conv_kernel, pallas_call at line 51): an fp32 image
// (H, W) and a (3, 3) fp32 kernel give out[y][x] = sum over r, c of
// kern[r][c] * img[y + r][x + c], an (H-2, W-2) fp32 image. Entry point
// strela_stream_conv2d.
//
// Bound on the H100: bytes. Each input pixel is read once and each output
// pixel written once, 4 bytes each, against 9 multiplies and 9 adds: a
// 4096 x 4096 frame moves 134 MB (0.040 ms at 3.35 TB/s) but does only
// 0.30 GFLOP (0.0045 ms at 67 TFLOP/s). So the design reads the image from
// device memory once: one block per 32 x 128 tile of output, which stages
// its 34 x 130 input pixels (the tile plus a 2-row, 2-column halo) in
// shared memory with coalesced loads; each thread then makes eight output
// pixels of one column from shared memory, with the nine taps in
// registers. The Pallas wrapper feeds its kernel three row streams: a
// padded copy and two jnp.roll copies of the image. That is plumbing for
// the TPU's BlockSpecs, and is not carried over.
//
// Order of the sums: out = 0, then out = out + kern[r][c] * x for r, c in
// row-major order, each product and sum rounded on its own (no fused
// multiply-add), which is what the plain PyTorch version computes. So the
// kernel agrees with it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128;                    // output columns per block
constexpr int kTileH = 32;                     // output rows per block
constexpr int kThreadsY = 4;                   // kTileW x kThreadsY threads
constexpr int kRowsPerThread = kTileH / kThreadsY;
constexpr int kInW = kTileW + 2, kInH = kTileH + 2;

__global__ void __launch_bounds__(kTileW * kThreadsY)
conv3x3_kernel(const float* __restrict__ img, const float* __restrict__ kern,
               float* __restrict__ out, int H, int W) {
  __shared__ float tile[kInH][kInW];
  const int Ho = H - 2, Wo = W - 2;
  const int ox0 = blockIdx.x * kTileW, oy0 = blockIdx.y * kTileH;
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = __ldg(kern + i);

  const int t = threadIdx.y * kTileW + threadIdx.x;
  for (int idx = t; idx < kInH * kInW; idx += kTileW * kThreadsY) {
    const int r = idx / kInW, c = idx % kInW;
    const int y = oy0 + r, x = ox0 + c;
    tile[r][c] = (y < H && x < W) ? img[static_cast<size_t>(y) * W + x]
                                  : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x, ox = ox0 + c;
  if (ox >= Wo) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.y * kRowsPerThread + i, oy = oy0 + r;
    if (oy >= Ho) break;
    float acc = 0.f;
#pragma unroll
    for (int rr = 0; rr < 3; ++rr)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        acc = __fadd_rn(acc, __fmul_rn(k[rr * 3 + cc], tile[r + rr][c + cc]));
    out[static_cast<size_t>(oy) * Wo + ox] = acc;
  }
}

}  // namespace

extern "C" {

// img (H, W), kern (3, 3) and out (H-2, W-2): contiguous fp32 on the
// device, H >= 3 and W >= 3. Returns the CUDA error of the launch.
int strela_stream_conv2d(const float* img, const float* kern, float* out,
                         int H, int W, void* stream) {
  if (H < 3 || W < 3) return static_cast<int>(cudaErrorInvalidValue);
  const int grid_y = (H - 2 + kTileH - 1) / kTileH;
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W - 2 + kTileW - 1) / kTileW, grid_y);
  const dim3 block(kTileW, kThreadsY);
  conv3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, kern, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
