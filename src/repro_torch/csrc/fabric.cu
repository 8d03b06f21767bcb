// fabric.cu — the STRELA fabric's value substrate as hand-written CUDA
// kernels for Hopper (sm_90a), with a plain C interface (loaded through
// ctypes by kernels/_build.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * repro/kernels/fabric_reduce.py::fabric_reduce_lanes  -> fabric_kernel<true>
//     (+ fold_kernel), entry point strela_fabric_reduce_lanes
//   * repro/kernels/fabric_stream.py::fabric_stream        -> fabric_kernel<false>,
//     entry point strela_fabric_stream
//
// Design. The wrapper lowers one shot DFG, in topological order, to a small
// int32 instruction table (kernels/fabric_stream.py::lower); every block
// loads it into shared memory and each thread interprets it once per stream
// element. One build serves every DFG: no per-DFG code generation sits on
// the request path. A thread keeps one value slot per wire in shared memory
// ([slot][thread], so neighbouring threads hit neighbouring banks) and one
// validity bit per wire in a 64-bit register; the opcode is the same for the
// whole warp, so the switch does not diverge. Branch legs run speculatively
// and Merge is a masked select, as in the reference.
//
// Arithmetic is done in uint32_t: signed overflow is undefined in C++ while
// the reference wraps mod 2^32. SHR is an arithmetic shift of int32_t, shift
// counts are masked with & 31, CMP tests the wrapped difference a - b.
//
// Lanes: blockIdx.x is a flattened (lane, chunk) index (gridDim.y stops at
// 65,535 and a gemm MEDIUM grid already has 14,800 lanes); a chunk is
// kThreads * kItems elements and the kernel masks the ragged tail itself.
//
// Reductions take two passes. The Pallas kernel carries its sum across grid
// steps that run in order; a GPU grid does not. Each block folds its chunk
// (registers, then warp shuffles, then shared memory) into one partial per
// reduction node, and fold_kernel folds each lane's partials into acc_init.
// This is exact: ADD, MUL, AND, OR and XOR are associative and commutative
// mod 2^32, and SUB folds as acc - sum(x).
//
// Bound: bytes. Each element is read once per input stream and written once
// per full-rate output (int32), a few integer operations per element; at
// 3.35 TB/s the card's memory is the limit long before its ALUs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                     // elements per thread per chunk
constexpr int kChunk = kThreads * kItems;     // elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 64;                 // one validity bit per slot
constexpr int kMaxInstr = 128;
constexpr int kMaxIO = 16;
constexpr int kMaxRed = 16;
constexpr int kInstrWords = 8;                // kind op dst a b c imm aux

enum Kind { K_INPUT = 0, K_CONST, K_ALU, K_CMP, K_MUX, K_BRANCH, K_MERGE,
            K_RED, K_OUT };
enum Alu { A_NOP = 0, A_ADD, A_SUB, A_MUL, A_SHL, A_SHR, A_AND, A_OR,
           A_XOR };
enum Cmp { C_EQZ = 1, C_GTZ = 2 };

struct Params {
  const int32_t* in[kMaxIO];
  int32_t* out[kMaxIO];
  int red_op[kMaxRed];
  int red_init[kMaxRed];
  int n_instr;
  int n_slots;
  int n_red;
  long long length;            // elements per lane
  long long chunks_per_lane;
  long long n_lanes;
};

__device__ __forceinline__ int32_t alu(int op, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  switch (op) {
    case A_ADD: return static_cast<int32_t>(ua + ub);
    case A_SUB: return static_cast<int32_t>(ua - ub);
    case A_MUL: return static_cast<int32_t>(ua * ub);
    case A_SHL: return static_cast<int32_t>(ua << (ub & 31u));
    case A_SHR: return a >> static_cast<int>(ub & 31u);
    case A_AND: return static_cast<int32_t>(ua & ub);
    case A_OR:  return static_cast<int32_t>(ua | ub);
    case A_XOR: return static_cast<int32_t>(ua ^ ub);
    default:    return a;
  }
}

// partials of a SUB reduction are plain sums: acc - x0 - x1 ... = acc - sum
__device__ __forceinline__ int32_t combine(int op, int32_t a, int32_t b) {
  return alu(op == A_SUB ? A_ADD : op, a, b);
}

__device__ __forceinline__ int32_t identity(int op) {
  if (op == A_AND) return -1;
  if (op == A_MUL) return 1;
  return 0;
}

template <bool kReduce>
__global__ void __launch_bounds__(kThreads)
fabric_kernel(const int32_t* __restrict__ prog, const Params p,
              int32_t* __restrict__ partials) {
  extern __shared__ int32_t smem[];
  int32_t* sprog = smem;                                  // n_instr x 8
  int32_t* sval = sprog + p.n_instr * kInstrWords;        // n_slots x kThreads
  int32_t* sacc = sval + p.n_slots * kThreads;            // n_red x kThreads
  __shared__ int32_t swarp[kMaxRed][kWarps];

  const int tid = threadIdx.x;
  for (int i = tid; i < p.n_instr * kInstrWords; i += kThreads)
    sprog[i] = prog[i];
  if (kReduce)
    for (int r = 0; r < p.n_red; ++r)
      sacc[r * kThreads + tid] = identity(p.red_op[r]);
  __syncthreads();

  const long long lane = blockIdx.x / p.chunks_per_lane;
  const long long chunk = blockIdx.x % p.chunks_per_lane;
  const long long base = lane * p.length;
#define SV(slot) sval[(slot) * kThreads + tid]
  for (int j = 0; j < kItems; ++j) {
    const long long e = chunk * kChunk + j * kThreads + tid;
    if (e >= p.length) break;                     // ragged tail of the lane
    const long long idx = base + e;
    uint64_t valid = 0;
    for (int k = 0; k < p.n_instr; ++k) {
      const int32_t* ins = sprog + k * kInstrWords;
      const int kind = ins[0], op = ins[1], dst = ins[2];
      const int a = ins[3], b = ins[4], c = ins[5];
      const int32_t imm = ins[6];
      switch (kind) {
        case K_INPUT:
          SV(dst) = p.in[a][idx];
          valid |= 1ull << dst;
          break;
        case K_CONST:
          SV(dst) = imm;
          valid |= 1ull << dst;
          break;
        case K_ALU: {
          const uint64_t ma = (valid >> a) & 1ull;
          const uint64_t mb = b >= 0 ? (valid >> b) & 1ull : ma;
          SV(dst) = alu(op, SV(a), b >= 0 ? SV(b) : imm);
          valid |= (ma & mb) << dst;
          break;
        }
        case K_CMP: {
          uint64_t m = (valid >> a) & 1ull;
          int32_t d;
          if (b >= 0) {
            d = alu(A_SUB, SV(a), SV(b));
            m &= (valid >> b) & 1ull;
          } else {
            d = alu(A_SUB, SV(a), imm);
          }
          SV(dst) = op == C_EQZ ? (d == 0) : (d > 0);
          valid |= m << dst;
          break;
        }
        case K_MUX: {
          const uint64_t ma = (valid >> a) & 1ull;
          const uint64_t mb = b >= 0 ? (valid >> b) & 1ull : ma;
          const uint64_t mc = (valid >> c) & 1ull;
          const int32_t vb = b >= 0 ? SV(b) : imm;
          SV(dst) = SV(c) != 0 ? SV(a) : vb;
          valid |= (ma & mb & mc) << dst;
          break;
        }
        case K_BRANCH: {                            // dst = leg t, b = leg f
          const uint64_t m = (valid >> a) & (valid >> c) & 1ull;
          const uint64_t taken = SV(c) != 0 ? 1ull : 0ull;
          const int32_t v = SV(a);
          SV(dst) = v;
          SV(b) = v;
          valid |= (m & taken) << dst;
          valid |= (m & (taken ^ 1ull)) << b;
          break;
        }
        case K_MERGE: {
          const uint64_t ma = (valid >> a) & 1ull;
          const uint64_t mb = (valid >> b) & 1ull;
          SV(dst) = ma ? SV(a) : SV(b);
          valid |= (ma | mb) << dst;
          break;
        }
        case K_RED:
          if (kReduce) {
            const int r = ins[7];
            int32_t& acc = sacc[r * kThreads + tid];
            acc = combine(op, acc, a >= 0 ? SV(a) : imm);
          }
          break;
        case K_OUT:
          p.out[ins[7]][idx] = SV(a);
          break;
      }
    }
  }
#undef SV
  if (!kReduce) return;

  const int warp = tid / 32, lid = tid % 32;
  for (int r = 0; r < p.n_red; ++r) {
    const int op = p.red_op[r];
    int32_t v = sacc[r * kThreads + tid];
    for (int off = 16; off > 0; off /= 2)
      v = combine(op, v, __shfl_down_sync(0xffffffffu, v, off));
    if (lid == 0) swarp[r][warp] = v;
  }
  __syncthreads();
  if (tid < p.n_red) {
    const int op = p.red_op[tid];
    int32_t v = identity(op);
    for (int w = 0; w < kWarps; ++w) v = combine(op, v, swarp[tid][w]);
    partials[static_cast<long long>(tid) * gridDim.x + blockIdx.x] = v;
  }
}

// one thread per (reduction, lane): fold the lane's chunk partials into
// acc_init
__global__ void fold_kernel(const int32_t* __restrict__ partials,
                            int32_t* __restrict__ red_out, const Params p,
                            long long n_blocks) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= p.n_red * p.n_lanes) return;
  const int r = static_cast<int>(t / p.n_lanes);
  const long long lane = t % p.n_lanes;
  const int op = p.red_op[r];
  const int32_t* part = partials + r * n_blocks + lane * p.chunks_per_lane;
  int32_t s = identity(op);
  for (long long c = 0; c < p.chunks_per_lane; ++c) s = combine(op, s, part[c]);
  const int32_t acc = p.red_init[r];
  red_out[t] = op == A_SUB ? alu(A_SUB, acc, s) : combine(op, acc, s);
}

int check_sizes(int n_instr, int n_slots, int n_in, int n_out, int n_red) {
  if (n_instr < 1 || n_instr > kMaxInstr || n_slots < 0 ||
      n_slots > kMaxSlots || n_in < 0 || n_in > kMaxIO || n_out < 0 ||
      n_out > kMaxIO || n_red < 0 || n_red > kMaxRed)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

size_t smem_bytes(const Params& p) {
  return sizeof(int32_t) * (static_cast<size_t>(p.n_instr) * kInstrWords +
                            static_cast<size_t>(p.n_slots + p.n_red) *
                                kThreads);
}

Params make_params(int n_instr, int n_slots, const long long* in_ptrs,
                   int n_in, const long long* out_ptrs, int n_out,
                   long long n_lanes, long long length) {
  Params p = {};
  for (int i = 0; i < n_in; ++i)
    p.in[i] = reinterpret_cast<const int32_t*>(in_ptrs[i]);
  for (int i = 0; i < n_out; ++i)
    p.out[i] = reinterpret_cast<int32_t*>(out_ptrs[i]);
  p.n_instr = n_instr;
  p.n_slots = n_slots;
  p.length = length;
  p.chunks_per_lane = (length + kChunk - 1) / kChunk;
  p.n_lanes = n_lanes;
  return p;
}

}  // namespace

extern "C" {

// elements per block: the caller sizes the reduction partials with it
int strela_chunk_elements() { return kChunk; }

const char* strela_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// N same-DFG lanes of `length` elements each. `partials` holds
// n_red * n_lanes * ceil(length / chunk) int32, `red_out` n_red * n_lanes.
// Returns the CUDA error of the launches (0 on success).
int strela_fabric_reduce_lanes(const int32_t* prog, int n_instr, int n_slots,
                               const long long* in_ptrs, int n_in,
                               const long long* out_ptrs, int n_out,
                               const int* red_ops, const int* red_inits,
                               int n_red, int32_t* partials, int32_t* red_out,
                               long long n_lanes, long long length,
                               void* stream) {
  int rc = check_sizes(n_instr, n_slots, n_in, n_out, n_red);
  if (rc) return rc;
  if (n_lanes <= 0 || length <= 0) return 0;
  Params p = make_params(n_instr, n_slots, in_ptrs, n_in, out_ptrs, n_out,
                         n_lanes, length);
  p.n_red = n_red;
  for (int r = 0; r < n_red; ++r) {
    p.red_op[r] = red_ops[r];
    p.red_init[r] = red_inits[r];
  }
  const long long n_blocks = n_lanes * p.chunks_per_lane;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_red > 0) {
    fabric_kernel<true><<<static_cast<unsigned>(n_blocks), kThreads,
                          smem_bytes(p), s>>>(prog, p, partials);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const long long n_fold = n_red * n_lanes;
    fold_kernel<<<static_cast<unsigned>((n_fold + 255) / 256), 256, 0, s>>>(
        partials, red_out, p, n_blocks);
  } else {
    fabric_kernel<false><<<static_cast<unsigned>(n_blocks), kThreads,
                           smem_bytes(p), s>>>(prog, p, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// One request, no reductions: the fabric_stream entry point.
int strela_fabric_stream(const int32_t* prog, int n_instr, int n_slots,
                         const long long* in_ptrs, int n_in,
                         const long long* out_ptrs, int n_out,
                         long long length, void* stream) {
  int rc = check_sizes(n_instr, n_slots, n_in, n_out, 0);
  if (rc) return rc;
  if (length <= 0) return 0;
  Params p = make_params(n_instr, n_slots, in_ptrs, n_in, out_ptrs, n_out,
                         1, length);
  if (p.chunks_per_lane > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  fabric_kernel<false><<<static_cast<unsigned>(p.chunks_per_lane), kThreads,
                         smem_bytes(p), static_cast<cudaStream_t>(stream)>>>(
      prog, p, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
