// fabric.cu — the STRELA fabric's value substrate as hand-written CUDA
// kernels for Hopper (sm_90a), with a plain C interface (loaded through
// ctypes by kernels/_build.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * repro/kernels/fabric_reduce.py::fabric_reduce_lanes -> lane_kernel
//     (+ fold_kernel for lanes longer than a block), entry point
//     strela_fabric_reduce_lanes
//   * repro/kernels/fabric_stream.py::fabric_stream -> stream_kernel, entry
//     point strela_fabric_stream
//
// Both interpret the instruction table that the wrapper lowers from one shot
// DFG, in topological order (kernels/fabric_stream.py::lower). One build
// serves every DFG: no per-DFG code generation sits on the request path.
// A block loads the table into shared memory once. Wire values live in
// shared memory in one layout (Slots): wire slot s of thread t's vector q
// (kW consecutive items) at (s * kV / kW + q) * kLThreads * kW + t * kW, so
// a warp's vector accesses hit neighbouring banks. Where a block's threads
// share one tile of kLThreads * kV consecutive elements (lane_kernel's flat
// tiles, stream_kernel), vector q of thread t holds elements q * kLThreads
// * kW + t * kW on, and each wire slot is one contiguous run of the tile in
// element order. Where the table has a Merge, each item keeps one
// validity bit per wire in a 64-bit register. The opcode is the same for
// the whole block, so the switch does not diverge. Branch legs run
// speculatively and Merge is a masked select, as in the reference. One copy
// of the instruction step (step()) serves both kernels: each row is decoded
// once and applied to all of a thread's kV items.
//
// Arithmetic is done in uint32_t: signed overflow is undefined in C++ while
// the reference wraps mod 2^32. SHR is an arithmetic shift of int32_t, shift
// counts are masked with & 31, CMP tests the wrapped difference a - b.
//
// Bound: bytes. Each element is read once per input stream and written once
// per full-rate output (int32), a few integer operations per element; at
// 3.35 TB/s the card's memory is the limit long before its ALUs.
//
// lane_kernel (N same-DFG lanes of one length, the engine's lane grid):
//   * Units. A grid without reductions is one flat stream (the lanes lie
//     end to end), cut into tiles of kTile elements. With reductions, a lane
//     of at most kWarpLane elements is the unit of one warp (eight lanes per
//     block at a time), a lane of at most kBlockLane elements that of one
//     block, which loops over its tiles; both fold their reductions in
//     registers and warp shuffles and write them straight to red_out, in
//     one pass. Only a longer lane is split into kBlockLane slices, one
//     partial each, which fold_kernel folds into acc_init.
//   * Blocks are persistent: as many as fit on the SMs at once, each
//     loading the table once and walking the units by a grid-stride loop.
//   * Loads first. For each pass over its items a thread puts every input
//     element it will use in flight at once, by cp.async into its value
//     slots (16-byte copies where the rows allow), then interprets. Each
//     instruction is decoded once and applied to all of the pass's items:
//     kV items per pass, 8 where the DFG's wires fit kSlotBytes of shared
//     memory at 8 items a thread, fewer for wider DFGs.
//   * Reductions are exact in any order: ADD, MUL, AND, OR and XOR are
//     associative and commutative mod 2^32, and SUB folds as acc - sum(x).
//
// stream_kernel (one lane, no reductions) replaces the Pallas kernel
// repro/kernels/fabric_stream.py::fabric_stream. Its bound is bytes: each
// input stream is read once and each full-rate output written once, 8 bytes
// an element for relu (one in, one out), against a few integer operations.
// The design keeps device memory busy and decodes little:
//   * Blocks are persistent: as many as fit on the SMs at once (never more
//     than there are tiles), each loading the table once and walking its
//     tiles of kLThreads * kV elements by a grid-stride loop.
//   * Tiles in the Slots layout, so each input stream's tile lands in its
//     slot as one 1-D bulk copy (cp.async.bulk, counted on an mbarrier,
//     issued by one thread) where the tile is whole and every stream
//     16-byte aligned; the ragged last tile and unaligned streams (a slice
//     x[1:] is legal input) copy element by element with zero fill.
//   * Two stages. Only the input slots are double-buffered: the block
//     issues tile t+1's copies before it interprets tile t. Stage 1 has its
//     own copy of the table, whose rows read input stream i from slot
//     n_slots + i, so step() and the Slots layout serve both stages.
//   * Each table row is decoded once for a thread's kV items; validity bits
//     are kept only where the table has a Merge.
//   * Outputs leave by 16-byte streaming stores (st.global.cs) where the
//     streams are aligned, element by element elsewhere.
//   * kV is chosen as for lane_kernel (8 items a thread, halved while the
//     wires exceed kSlotBytes). Shared memory a block: the table twice
//     (n_instr x 32 bytes each) + (n_slots + n_in) x kV x kLThreads x 4;
//     for relu (4 rows, 3 slots, 1 input) at kV = 8: 256 bytes + 32 KB.
//   Measured on an H100 (PERF.md): 16-byte cp.async copies, 3 or 4
//   stages, an L2 evict-first hint on the copies, plain stores, one block a
//   tile and contiguous tile runs a block were each no faster, or slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxSlots = 64;                 // one validity bit per slot
constexpr int kMaxInstr = 128;
constexpr int kMaxIO = 16;
constexpr int kMaxRed = 16;
constexpr int kInstrWords = 8;                // kind op dst a b c imm aux

// lane_kernel and stream_kernel (kernels/fabric_reduce.py mirrors kWarpLane
// and kBlockLane, kernels/fabric_stream.py kLThreads and kSlotBytes)
constexpr int kLThreads = 256;
constexpr int kLWarps = kLThreads / 32;
constexpr int kLItems = 8;                    // elements per thread per tile
constexpr int kTile = kLThreads * kLItems;    // elements per block tile
constexpr int kWarpLane = 256;                // lanes this short: a warp each
constexpr int kBlockLane = 4096;              // lanes this short: one pass
constexpr int kSlotBytes = 64 * 1024;         // wire values per block
static_assert(kWarpLane == 32 * kLItems, "a warp's tile is one lane");
static_assert(kBlockLane % kTile == 0, "slices are whole tiles");
static_assert(kMaxInstr <= kLThreads, "one thread per instruction scan");

enum Kind { K_INPUT = 0, K_CONST, K_ALU, K_CMP, K_MUX, K_BRANCH, K_MERGE,
            K_RED, K_OUT };
enum Alu { A_NOP = 0, A_ADD, A_SUB, A_MUL, A_SHL, A_SHR, A_AND, A_OR,
           A_XOR };
enum Cmp { C_EQZ = 1, C_GTZ = 2 };
enum Mode { kModeFlat = 0, kModeWarp, kModeBlock, kModeSplit };

struct Params {
  const int32_t* in[kMaxIO];
  int32_t* out[kMaxIO];
  int red_op[kMaxRed];
  int red_init[kMaxRed];
  int n_instr;
  int n_slots;
  int n_red;
  int mode;                    // lane_kernel: a Mode
  int vec;                     // 16-byte copies and stores
  long long length;            // elements per lane (flat: in the grid)
  long long n_lanes;
  long long n_units;           // tiles, lanes or lane slices
  long long slices;            // kModeSplit: slices per lane
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

// acc_init folded with a lane's sum
__device__ __forceinline__ int32_t finish(int op, int32_t init, int32_t s) {
  return op == A_SUB ? alu(A_SUB, init, s) : combine(op, init, s);
}

// kW consecutive int32 items, moved to and from memory as one vector
template <int kW>
struct Items {
  int32_t v[kW];
};

template <int kW>
__device__ __forceinline__ Items<kW> load_items(const int32_t* p) {
  Items<kW> r;
  if constexpr (kW == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else if constexpr (kW == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    r.v[0] = x.x; r.v[1] = x.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int kW>
__device__ __forceinline__ void store_items(int32_t* p, const Items<kW>& r) {
  if constexpr (kW == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else if constexpr (kW == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(r.v[0], r.v[1]);
  } else {
    *p = r.v[0];
  }
}

template <int kW>
__device__ __forceinline__ Items<kW> splat(int32_t x) {
  Items<kW> r;
#pragma unroll
  for (int c = 0; c < kW; ++c) r.v[c] = x;
  return r;
}

// ---------------------------------------------------------------------------
// the instruction step, shared by both kernels
// ---------------------------------------------------------------------------

// This thread's kV = kNQ * kW items: wire slot s of its vector q lies at
// vals + (s * kNQ + q) * vstride (kW consecutive int32).
template <int kW, int kNQ>
struct Slots {
  int32_t* vals;
  int vstride;
  __device__ __forceinline__ int32_t* at(int s, int q) const {
    return vals + (s * kNQ + q) * vstride;
  }
  __device__ __forceinline__ Items<kW> get(int s, int q) const {
    return load_items<kW>(at(s, q));
  }
  // operand b, or the immediate where the table has none
  __device__ __forceinline__ Items<kW> get_or(int s, int q,
                                              int32_t imm) const {
    return s >= 0 ? get(s, q) : splat<kW>(imm);
  }
  __device__ __forceinline__ void put(int s, int q,
                                      const Items<kW>& r) const {
    store_items<kW>(at(s, q), r);
  }
};

// dst = f(a, b or imm), item by item
template <int kW, int kNQ, class F>
__device__ __forceinline__ void map2(const Slots<kW, kNQ>& sv, int dst, int a,
                                     int b, int32_t imm, F f) {
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    const Items<kW> x = sv.get(a, q), y = sv.get_or(b, q, imm);
    Items<kW> r;
#pragma unroll
    for (int c = 0; c < kW; ++c) r.v[c] = f(x.v[c], y.v[c]);
    sv.put(dst, q, r);
  }
}

// Apply one table instruction to this thread's items. valid[j] holds item
// j's validity bits, one per slot, kept only when `track` (only a Merge
// reads them). INPUT, RED and OUT touch device memory, which the kernels
// reach differently: they call back on_input(dst, a), on_red(op, a, imm, r)
// and on_out(a, o).
template <int kW, int kNQ, class OnInput, class OnRed, class OnOut>
__device__ __forceinline__ void step(const int32_t* ins,
                                     const Slots<kW, kNQ>& sv,
                                     uint64_t (&valid)[kW * kNQ], bool track,
                                     OnInput on_input, OnRed on_red,
                                     OnOut on_out) {
  constexpr int kV = kW * kNQ;
  const int4 w0 = *reinterpret_cast<const int4*>(ins);      // kind op dst a
  const int4 w1 = *reinterpret_cast<const int4*>(ins + 4);  // b c imm aux
  const int kind = w0.x, op = w0.y, dst = w0.z, a = w0.w;
  const int b = w1.x, c = w1.y;
  const int32_t imm = w1.z;
  switch (kind) {
    case K_INPUT:
      on_input(dst, a);
      if (track)
#pragma unroll
        for (int j = 0; j < kV; ++j) valid[j] |= 1ull << dst;
      break;
    case K_CONST:
#pragma unroll
      for (int q = 0; q < kNQ; ++q) sv.put(dst, q, splat<kW>(imm));
      if (track)
#pragma unroll
        for (int j = 0; j < kV; ++j) valid[j] |= 1ull << dst;
      break;
    case K_ALU: {
      using U = uint32_t;
      switch (op) {
        case A_ADD:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) + U(y)); });
          break;
        case A_SUB:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) - U(y)); });
          break;
        case A_MUL:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) * U(y)); });
          break;
        case A_SHL:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) << (U(y) & 31u)); });
          break;
        case A_SHR:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return x >> static_cast<int>(U(y) & 31u); });
          break;
        case A_AND:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) & U(y)); });
          break;
        case A_OR:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) | U(y)); });
          break;
        case A_XOR:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
            return static_cast<int32_t>(U(x) ^ U(y)); });
          break;
        default:
          map2(sv, dst, a, b, imm, [](int32_t x, int32_t) { return x; });
      }
      if (track)
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const uint64_t ma = (valid[j] >> a) & 1ull;
          const uint64_t mb = b >= 0 ? (valid[j] >> b) & 1ull : ma;
          valid[j] |= (ma & mb) << dst;
        }
      break;
    }
    case K_CMP:
      if (op == C_EQZ)
        map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
          return static_cast<int32_t>(alu(A_SUB, x, y) == 0); });
      else
        map2(sv, dst, a, b, imm, [](int32_t x, int32_t y) {
          return static_cast<int32_t>(alu(A_SUB, x, y) > 0); });
      if (track)
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          uint64_t m = (valid[j] >> a) & 1ull;
          if (b >= 0) m &= (valid[j] >> b) & 1ull;
          valid[j] |= m << dst;
        }
      break;
    case K_MUX:
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        const Items<kW> x = sv.get(a, q), y = sv.get_or(b, q, imm);
        const Items<kW> s = sv.get(c, q);
        Items<kW> r;
#pragma unroll
        for (int e = 0; e < kW; ++e) r.v[e] = s.v[e] != 0 ? x.v[e] : y.v[e];
        sv.put(dst, q, r);
      }
      if (track)
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const uint64_t ma = (valid[j] >> a) & 1ull;
          const uint64_t mb = b >= 0 ? (valid[j] >> b) & 1ull : ma;
          const uint64_t mc = (valid[j] >> c) & 1ull;
          valid[j] |= (ma & mb & mc) << dst;
        }
      break;
    case K_BRANCH:                                // dst = leg t, b = leg f
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        const Items<kW> x = sv.get(a, q);
        sv.put(dst, q, x);
        sv.put(b, q, x);
        if (track) {
          const Items<kW> s = sv.get(c, q);
#pragma unroll
          for (int e = 0; e < kW; ++e) {
            uint64_t& v = valid[q * kW + e];
            const uint64_t m = (v >> a) & (v >> c) & 1ull;
            const uint64_t taken = s.v[e] != 0 ? 1ull : 0ull;
            v |= (m & taken) << dst;
            v |= (m & (taken ^ 1ull)) << b;
          }
        }
      }
      break;
    case K_MERGE:                 // a table with a Merge always tracks
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        const Items<kW> x = sv.get(a, q), y = sv.get(b, q);
        Items<kW> r;
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          uint64_t& v = valid[q * kW + e];
          const uint64_t ma = (v >> a) & 1ull, mb = (v >> b) & 1ull;
          r.v[e] = ma ? x.v[e] : y.v[e];
          v |= (ma | mb) << dst;
        }
        sv.put(dst, q, r);
      }
      break;
    case K_RED:
      on_red(op, a, imm, w1.w);
      break;
    case K_OUT:
      on_out(a, w1.w);
      break;
  }
}

// ---------------------------------------------------------------------------
// lane_kernel: N lanes, reductions in one pass where a lane fits a block
// ---------------------------------------------------------------------------

// kBytes from src to shared dst by cp.async; src_bytes 0 fills zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(int32_t* dst, const int32_t* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies done but for the newest kPending groups
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kW elements of src from element e, zero past n: one vector copy where
// the vector is whole and the rows allow it, else one copy per element
template <int kW>
__device__ __forceinline__ void fetch(int32_t* dst, const int32_t* src,
                                      int e, int n, bool vec) {
  if (kW > 1 && vec && e + kW <= n) {
    cp_async<4 * kW>(dst, src + e, 4 * kW);
    return;
  }
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    const bool ok = e + c < n;
    cp_async<4>(dst + c, ok ? src + e + c : src, ok ? 4 : 0);
  }
}

// acc folded by f with this thread's items of slot a (or imm); where the
// pass is not whole, items at or past n count as the identity id
template <int kW, int kNQ, class F>
__device__ __forceinline__ int32_t fold_items(const Slots<kW, kNQ>& sv,
                                              int a, int32_t imm,
                                              int32_t acc, int32_t id,
                                              bool whole, int e0, int q_step,
                                              int n, F f) {
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    const Items<kW> x = a >= 0 ? sv.get(a, q) : splat<kW>(imm);
#pragma unroll
    for (int c = 0; c < kW; ++c)
      acc = f(acc, whole || e0 + q * q_step + c < n ? x.v[c] : id);
  }
  return acc;
}

// f applied with op's reduction (SUB folds as ADD) and its identity
template <class F>
__device__ __forceinline__ void with_fold(int op, F f) {
  using U = uint32_t;
  switch (op == A_SUB ? A_ADD : op) {
    case A_MUL:
      f([](int32_t x, int32_t y) { return static_cast<int32_t>(U(x) * U(y)); },
        1);
      break;
    case A_AND:
      f([](int32_t x, int32_t y) { return x & y; }, -1);
      break;
    case A_OR:
      f([](int32_t x, int32_t y) { return x | y; }, 0);
      break;
    case A_XOR:
      f([](int32_t x, int32_t y) { return x ^ y; }, 0);
      break;
    default:
      f([](int32_t x, int32_t y) { return static_cast<int32_t>(U(x) + U(y)); },
        0);
  }
}

template <int kV>
__global__ void __launch_bounds__(kLThreads)
lane_kernel(const int32_t* __restrict__ prog, const Params p,
            int32_t* __restrict__ red_out, int32_t* __restrict__ partials) {
  constexpr int kW = kV < 4 ? kV : 4;           // items per vector
  constexpr int kNQ = kV / kW;                  // vectors per pass
  extern __shared__ __align__(16) int32_t lsmem[];
  int32_t* sprog = lsmem;                               // n_instr x 8
  int32_t* sval = sprog + p.n_instr * kInstrWords;      // slots x kV x thr
  int32_t* sacc = sval + p.n_slots * kV * kLThreads;    // n_red x thr
  __shared__ int32_t swarp[kMaxRed][kLWarps];

  const int tid = threadIdx.x, lid = tid % 32, warp = tid / 32;
  for (int i = tid; i < p.n_instr * kInstrWords; i += kLThreads)
    sprog[i] = prog[i];
  for (int r = 0; r < p.n_red; ++r)
    sacc[r * kLThreads + tid] = identity(p.red_op[r]);
  // the validity bits matter only to a Merge: keep them where there is one
  const bool track = __syncthreads_or(
      tid < p.n_instr && prog[tid * kInstrWords] == K_MERGE);

  const bool by_warp = p.mode == kModeWarp;
  const int G = by_warp ? 32 : kLThreads;       // threads sharing a unit
  const int g = by_warp ? lid : tid;
  const long long per_block = by_warp ? kLWarps : 1;
  const int q_step = G * kW;                    // elements between vectors
  const int pass_len = q_step * kNQ;            // elements per pass
  const Slots<kW, kNQ> sv{sval + tid * kW, kLThreads * kW};

  for (long long u = blockIdx.x * per_block + (by_warp ? warp : 0);
       u < p.n_units; u += gridDim.x * per_block) {
    // the unit: elements [begin, begin + n) of the lane-major grid; n is
    // at most kBlockLane, so offsets within it are ints
    long long lane = u, begin;
    int n;
    if (p.mode == kModeFlat) {
      begin = u * kTile;
      n = static_cast<int>(min(static_cast<long long>(kTile),
                               p.length - begin));
    } else if (p.mode == kModeSplit) {
      lane = u / p.slices;
      const long long off = (u % p.slices) * kBlockLane;
      begin = lane * p.length + off;
      n = static_cast<int>(min(static_cast<long long>(kBlockLane),
                               p.length - off));
    } else {
      begin = lane * p.length;
      n = static_cast<int>(p.length);
    }
    for (int e0 = g * kW; e0 < n; e0 += pass_len) {
      // this pass: vector q of this thread starts at element e0 + q * q_step
      const bool whole = e0 + (kNQ - 1) * q_step + kW <= n;
      for (int k = 0; k < p.n_instr; ++k) {     // every input in flight
        const int32_t* ins = sprog + k * kInstrWords;
        if (ins[0] != K_INPUT) continue;
        const int32_t* src = p.in[ins[3]] + begin;
#pragma unroll
        for (int q = 0; q < kNQ; ++q)
          fetch<kW>(sv.at(ins[2], q), src, e0 + q * q_step, n, p.vec);
      }
      cp_async_wait_all();                      // own copies only
      uint64_t valid[kV] = {};
      for (int k = 0; k < p.n_instr; ++k)
        step(sprog + k * kInstrWords, sv, valid, track,
             [](int, int) {},                     // inputs are in place
             [&](int op, int a, int32_t imm, int r) {
               int32_t& acc = sacc[r * kLThreads + tid];
               with_fold(op, [&](auto f, int32_t id) {
                 acc = fold_items(sv, a, imm, acc, id, whole, e0, q_step, n,
                                  f);
               });
             },
             [&](int a, int o) {
               int32_t* out = p.out[o] + begin;
#pragma unroll
               for (int q = 0; q < kNQ; ++q) {
                 const Items<kW> x = sv.get(a, q);
                 const int e = e0 + q * q_step;
                 if (kW > 1 && p.vec && e + kW <= n) {
                   store_items<kW>(out + e, x);
                 } else {
#pragma unroll
                   for (int c = 0; c < kW; ++c)
                     if (e + c < n) out[e + c] = x.v[c];
                 }
               }
             });
    }
    if (p.n_red == 0) continue;

    // the unit's reductions: registers, warp shuffles, then across warps
    for (int r = 0; r < p.n_red; ++r) {
      const int op = p.red_op[r];
      int32_t v = sacc[r * kLThreads + tid];
      with_fold(op, [&](auto f, int32_t id) {
        sacc[r * kLThreads + tid] = id;
        for (int off = 16; off > 0; off /= 2)
          v = f(v, __shfl_xor_sync(0xffffffffu, v, off));
      });
      if (lid != 0) continue;
      if (by_warp)
        red_out[r * p.n_lanes + lane] = finish(op, p.red_init[r], v);
      else
        swarp[r][warp] = v;
    }
    if (by_warp) continue;
    __syncthreads();
    if (tid < p.n_red) {
      const int op = p.red_op[tid];
      int32_t v = identity(op);
      for (int w = 0; w < kLWarps; ++w) v = combine(op, v, swarp[tid][w]);
      if (p.mode == kModeSplit)
        partials[(tid * p.n_lanes + lane) * p.slices + u % p.slices] = v;
      else
        red_out[tid * p.n_lanes + lane] = finish(op, p.red_init[tid], v);
    }
    __syncthreads();
  }
}

// one thread per (reduction, lane): fold the lane's slice partials into
// acc_init
__global__ void fold_kernel(const int32_t* __restrict__ partials,
                            int32_t* __restrict__ red_out, const Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= p.n_red * p.n_lanes) return;
  const int r = static_cast<int>(t / p.n_lanes);
  const int op = p.red_op[r];
  const int32_t* part = partials + t * p.slices;
  int32_t s = identity(op);
  for (long long c = 0; c < p.slices; ++c) s = combine(op, s, part[c]);
  red_out[t] = finish(op, p.red_init[r], s);
}

// ---------------------------------------------------------------------------
// stream_kernel: one lane, no reductions (fabric_stream)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A copy that never
// lands (a fault in this file) traps after about 2^31 polls, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0x80000000u) __trap();
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// to shared dst as one bulk copy, counted on bar
__device__ __forceinline__ void bulk_load(int32_t* dst, const int32_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// kW consecutive int32 to global memory, streaming (evict first)
template <int kW>
__device__ __forceinline__ void store_stream(int32_t* p, const Items<kW>& r) {
  if constexpr (kW == 4) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(r.v[0], r.v[1], r.v[2], r.v[3]));
  } else if constexpr (kW == 2) {
    __stcs(reinterpret_cast<int2*>(p), make_int2(r.v[0], r.v[1]));
  } else {
    __stcs(p, r.v[0]);
  }
}

// Each block loads the table twice: stage 0's as lowered, stage 1's with
// every read of input stream i's slot moved to slot n_slots + i. It then
// walks the tiles u = blockIdx.x, + gridDim.x, ..., issuing the next tile's
// input copies into the other stage before it interprets this one. A whole
// tile of 16-byte-aligned streams lands by one bulk copy a stream, issued
// by thread 0 and counted on the stage's mbarrier; otherwise each thread
// copies its own items by cp.async (zero past the end) and waits for its
// own groups. At most 64 registers a thread, so that 4 blocks fit an SM:
// on an H100 (PERF.md), unbounded (105 at kV = 8, 2 blocks) was 7% slower
// on relu, and 48 (5 blocks) spilled and was 25% slower.
template <int kV>
__global__ void __launch_bounds__(kLThreads, 4)
stream_kernel(const int32_t* __restrict__ prog, const Params p) {
  constexpr int kW = kV < 4 ? kV : 4;           // items per vector
  constexpr int kNQ = kV / kW;                  // vectors per pass
  constexpr int kTileLen = kLThreads * kV;      // elements per tile
  constexpr int kQStep = kLThreads * kW;        // elements between vectors
  constexpr uint32_t kTileBytes = kTileLen * sizeof(int32_t);
  __shared__ __align__(8) uint64_t full[2];     // a stage's bulk copies
  __shared__ int in_of[kMaxSlots];              // slot -> input stream or -1
  extern __shared__ __align__(16) int32_t ssmem[];
  const int n_words = p.n_instr * kInstrWords;
  int32_t* sprog = ssmem;                       // 2 x n_instr x 8
  int32_t* sval = sprog + 2 * n_words;          // slots x tile

  const int tid = threadIdx.x;
  for (int s = tid; s < kMaxSlots; s += kLThreads) in_of[s] = -1;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool is_input = tid < p.n_instr && prog[tid * kInstrWords] == K_INPUT;
  if (is_input)
    in_of[prog[tid * kInstrWords + 2]] = prog[tid * kInstrWords + 3];
  const int n_in = __syncthreads_count(is_input);
  // the validity bits matter only to a Merge: keep them where there is one
  const bool track = __syncthreads_or(
      tid < p.n_instr && prog[tid * kInstrWords] == K_MERGE);
  // stage 1's input slots need validity bits of their own where tracked: a
  // table too wide for that runs with one stage
  const int stages = !track || p.n_slots + n_in <= kMaxSlots ? 2 : 1;
  for (int j = tid; j < stages * n_words; j += kLThreads) {
    const int i = j % n_words, f = i % kInstrWords;
    int w = prog[i];
    const bool is_slot = f == 2 || f == 4 || f == 5 ||
                         (f == 3 && prog[i - 3] != K_INPUT);
    if (j >= n_words && is_slot && w >= 0 && in_of[w] >= 0)
      w = p.n_slots + in_of[w];
    sprog[j] = w;
  }
  __syncthreads();

  const Slots<kW, kNQ> sv{sval + tid * kW, kLThreads * kW};
  const int e0 = tid * kW;                      // this thread's first item
  const long long n_tiles =                     // this block's tiles
      blockIdx.x < p.n_units ? (p.n_units - 1 - blockIdx.x) / gridDim.x + 1
                             : 0;
  auto begin_of = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * kTileLen;
  };
  auto len_of = [&](long long i) {
    return static_cast<int>(
        min(static_cast<long long>(kTileLen), p.length - begin_of(i)));
  };
  auto by_bulk = [&](int n) { return p.vec && n == kTileLen; };
  // the block's i-th tile's inputs into stage i % stages
  auto issue = [&](long long i) {
    const int st = static_cast<int>(i % stages);
    const int32_t* tab = sprog + st * n_words;
    const long long begin = begin_of(i);
    const int n = len_of(i);
    if (by_bulk(n)) {
      if (tid == 0) {
        // the slots' last reads (generic proxy) before the copy (async)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&full[st], n_in * kTileBytes);
        for (int k = 0; k < p.n_instr; ++k) {
          const int32_t* ins = tab + k * kInstrWords;
          if (ins[0] == K_INPUT)
            bulk_load(sval + ins[2] * kTileLen, p.in[ins[3]] + begin,
                      kTileBytes, &full[st]);
        }
      }
    } else {
      for (int k = 0; k < p.n_instr; ++k) {
        const int32_t* ins = tab + k * kInstrWords;
        if (ins[0] != K_INPUT) continue;
        const int32_t* src = p.in[ins[3]] + begin;
#pragma unroll
        for (int q = 0; q < kNQ; ++q)
          fetch<kW>(sv.at(ins[2], q), src, e0 + q * kQStep, n, p.vec);
      }
    }
    cp_async_commit();
  };

  if (stages == 2 && n_tiles > 0) issue(0);
  uint32_t parity = 0;                          // bit st: full[st]'s phase
  for (long long i = 0; i < n_tiles; ++i) {
    // the next tile (one stage: this one) into the stage read last
    const long long next = i + stages - 1;
    if (next < n_tiles) {
      if (by_bulk(len_of(next))) __syncthreads();
      issue(next);
    }
    const int st = static_cast<int>(i % stages);
    const long long begin = begin_of(i);
    const int n = len_of(i);
    if (by_bulk(n)) {
      mbar_wait(&full[st], (parity >> st) & 1u);
      parity ^= 1u << st;
    }
    if (next > i && next < n_tiles)             // own copies but the next's
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const int32_t* tab = sprog + st * n_words;
    uint64_t valid[kV] = {};
    for (int k = 0; k < p.n_instr; ++k)
      step(tab + k * kInstrWords, sv, valid, track,
           [](int, int) {},                     // inputs are in place
           [](int, int, int32_t, int) {},       // no reductions
           [&](int a, int o) {
             int32_t* out = p.out[o] + begin;
#pragma unroll
             for (int q = 0; q < kNQ; ++q) {
               const Items<kW> x = sv.get(a, q);
               const int e = e0 + q * kQStep;
               if (p.vec && e + kW <= n) {
                 store_stream<kW>(out + e, x);
               } else {
#pragma unroll
                 for (int c = 0; c < kW; ++c)
                   if (e + c < n) __stcs(out + e + c, x.v[c]);
               }
             }
           });
  }
}

int check_sizes(int n_instr, int n_slots, int n_in, int n_out, int n_red) {
  if (n_instr < 1 || n_instr > kMaxInstr || n_slots < 0 ||
      n_slots > kMaxSlots || n_in < 0 || n_in > kMaxIO || n_out < 0 ||
      n_out > kMaxIO || n_red < 0 || n_red > kMaxRed)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Params make_params(int n_instr, int n_slots, const long long* in_ptrs,
                   int n_in, const long long* out_ptrs, int n_out,
                   long long n_lanes, long long length, bool* aligned) {
  Params p = {};
  *aligned = true;
  for (int i = 0; i < n_in; ++i) {
    p.in[i] = reinterpret_cast<const int32_t*>(in_ptrs[i]);
    *aligned = *aligned && in_ptrs[i] % 16 == 0;
  }
  for (int i = 0; i < n_out; ++i) {
    p.out[i] = reinterpret_cast<int32_t*>(out_ptrs[i]);
    *aligned = *aligned && out_ptrs[i] % 16 == 0;
  }
  p.n_instr = n_instr;
  p.n_slots = n_slots;
  p.length = length;
  p.n_lanes = n_lanes;
  return p;
}

// the most any table takes: kMaxInstr rows, kSlotBytes of wire values,
// kMaxRed sums a thread
constexpr size_t kLaneSmemMax =
    sizeof(int32_t) * (kMaxInstr * kInstrWords + kMaxRed * kLThreads) +
    kSlotBytes;

size_t lane_smem(const Params& p, int kv) {
  return sizeof(int32_t) *
         (static_cast<size_t>(p.n_instr) * kInstrWords +
          static_cast<size_t>(p.n_slots) * kv * kLThreads +
          static_cast<size_t>(p.n_red) * kLThreads);
}

// The blocks of `kernel` (kLThreads threads) that fit on the device at once
// with smem bytes of dynamic shared memory each, remembered per (device,
// kernel, smem): the attribute and occupancy queries cost host time on
// every launch otherwise. smem_max is the most any table takes.
cudaError_t resident_blocks(const void* kernel, size_t smem_max, size_t smem,
                            long long* out) {
  struct Entry { int dev; const void* kernel; size_t smem; long long blocks; };
  constexpr int kSeen = 128;
  static std::mutex mu;
  static Entry seen[kSeen];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].kernel == kernel &&
        seen[i].smem == smem) {
      *out = seen[i].blocks;
      return cudaSuccess;
    }
  int n_sm = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_max));
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kLThreads, smem);
  if (rc != cudaSuccess) return rc;
  *out = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  if (n_seen < kSeen) seen[n_seen++] = {dev, kernel, smem, *out};
  return cudaSuccess;
}

// persistent blocks: as many as fit on the SMs at once, at most one a unit
template <int kV>
int launch_lanes(const int32_t* prog, const Params& p, int32_t* red_out,
                 int32_t* partials, cudaStream_t s) {
  const size_t smem = lane_smem(p, kV);
  long long resident = 0;
  const cudaError_t rc = resident_blocks(
      reinterpret_cast<const void*>(lane_kernel<kV>), kLaneSmemMax, smem,
      &resident);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long per_block = p.mode == kModeWarp ? kLWarps : 1;
  long long blocks = (p.n_units + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  lane_kernel<kV><<<static_cast<unsigned>(blocks), kLThreads, smem, s>>>(
      prog, p, red_out, partials);
  return static_cast<int>(cudaGetLastError());
}

// the most any table takes: the table twice, the wires (at most
// kSlotBytes) and a second stage of the inputs (at most as many bytes)
constexpr size_t kStreamSmemMax =
    sizeof(int32_t) * 2 * kMaxInstr * kInstrWords + 2 * kSlotBytes;

// persistent blocks: as many as fit on the SMs at once, at most one a tile
template <int kV>
int launch_stream(const int32_t* prog, const Params& p, int n_in,
                  cudaStream_t s) {
  const size_t smem =
      sizeof(int32_t) *
      (2 * static_cast<size_t>(p.n_instr) * kInstrWords +
       static_cast<size_t>(p.n_slots + n_in) * kV * kLThreads);
  long long resident = 0;
  const cudaError_t rc = resident_blocks(
      reinterpret_cast<const void*>(stream_kernel<kV>), kStreamSmemMax, smem,
      &resident);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long blocks = p.n_units < resident ? p.n_units : resident;
  stream_kernel<kV><<<static_cast<unsigned>(blocks), kLThreads, smem, s>>>(
      prog, p);
  return static_cast<int>(cudaGetLastError());
}

// items a thread holds per pass: 8 where a block's wires fit kSlotBytes,
// halved until they do (kernels/fabric_stream.py::stream_geometry mirrors
// it for the stream kernel)
int items_per_thread(int n_slots) {
  int kv = 8;
  while (kv > 1 && static_cast<size_t>(n_slots) * kv * kLThreads *
                           sizeof(int32_t) > kSlotBytes)
    kv /= 2;
  return kv;
}

}  // namespace

extern "C" {

const char* strela_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// N same-DFG lanes of `length` elements each, lane-major. `red_out` holds
// n_red * n_lanes int32. `partials` (n_red * n_lanes * ceil(length /
// kBlockLane) int32) is read only when some reduction's lanes are longer
// than kBlockLane, and may be null otherwise. Returns the CUDA error of the
// launches (0 on success).
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
  bool aligned = true;
  Params p = make_params(n_instr, n_slots, in_ptrs, n_in, out_ptrs, n_out,
                         n_lanes, length, &aligned);
  p.n_red = n_red;
  for (int r = 0; r < n_red; ++r) {
    p.red_op[r] = red_ops[r];
    p.red_init[r] = red_inits[r];
  }
  p.slices = 1;
  if (n_red == 0) {                     // the lanes lie end to end
    p.mode = kModeFlat;
    p.length = n_lanes * length;
    p.n_units = (p.length + kTile - 1) / kTile;
    p.vec = aligned;
  } else {
    p.vec = aligned && length % 4 == 0;
    p.n_units = n_lanes;
    if (length <= kWarpLane) {
      p.mode = kModeWarp;
    } else if (length <= kBlockLane) {
      p.mode = kModeBlock;
    } else {
      if (partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      p.mode = kModeSplit;
      p.slices = (length + kBlockLane - 1) / kBlockLane;
      p.n_units = n_lanes * p.slices;
    }
  }
  const int kv = items_per_thread(n_slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv) {
    case 8: rc = launch_lanes<8>(prog, p, red_out, partials, s); break;
    case 4: rc = launch_lanes<4>(prog, p, red_out, partials, s); break;
    case 2: rc = launch_lanes<2>(prog, p, red_out, partials, s); break;
    default: rc = launch_lanes<1>(prog, p, red_out, partials, s);
  }
  if (rc || p.mode != kModeSplit) return rc;
  const long long n_fold = n_red * n_lanes;
  fold_kernel<<<static_cast<unsigned>((n_fold + 255) / 256), 256, 0, s>>>(
      partials, red_out, p);
  return static_cast<int>(cudaGetLastError());
}

// One request, no reductions: the fabric_stream entry point. Returns the
// CUDA error of the launch (0 on success).
int strela_fabric_stream(const int32_t* prog, int n_instr, int n_slots,
                         const long long* in_ptrs, int n_in,
                         const long long* out_ptrs, int n_out,
                         long long length, void* stream) {
  const int rc = check_sizes(n_instr, n_slots, n_in, n_out, 0);
  if (rc) return rc;
  if (length <= 0) return 0;
  bool aligned = true;
  Params p = make_params(n_instr, n_slots, in_ptrs, n_in, out_ptrs, n_out,
                         1, length, &aligned);
  p.vec = aligned;
  const int kv = items_per_thread(n_slots);
  const long long tile = static_cast<long long>(kLThreads) * kv;
  p.n_units = (length + tile - 1) / tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv) {
    case 8: return launch_stream<8>(prog, p, n_in, s);
    case 4: return launch_stream<4>(prog, p, n_in, s);
    case 2: return launch_stream<2>(prog, p, n_in, s);
    default: return launch_stream<1>(prog, p, n_in, s);
  }
}

}  // extern "C"
