// Sorted segmented reduction (inclusive segmented scan) and the inclusive
// prefix scan for Hopper (sm_90a), CUDA C++, each in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce/
// segment_reduce.py::segment_reduce_fwd (pallas_call at :66). It computes
// what that kernel computes: the inclusive scan of (N, D) values (int32 or
// f32) under the segmented combine (f_b ? v_b : op(v_a, v_b), f_a | f_b),
// op sum, max or min, with a row's flag (head-or-invalid) starting a new
// segment. Integer sums wrap as torch's do; max and min propagate a NaN as
// torch.maximum and torch.minimum do.
//
// What bounds it on this card: bytes. One combine per element; the least
// traffic reads the values and the flags once and writes the values once
// (at the hybrid path's (2^27, 1) int32: 1.21 GB, 0.36 ms at 3.35 TB/s).
//
// Design. The TPU kernel's sequential grid carried the running value from
// one row tile to the next in VMEM scratch. Here every block scans one tile
// and takes the value carried into it from a decoupled look-back
// (lookback.cuh): it publishes its aggregate, then combines its
// predecessors' aggregates back to the first that holds an inclusive
// prefix. Under the segmented combine a tile whose aggregate holds a
// boundary is its own inclusive prefix and publishes it at once, so at the
// hybrid path's 5 % boundaries every look-back is one step; only a segment
// longer than a tile walks further. The values and flags are read once and
// the output written once, in one launch besides the scratch's memset.
//
// In a tile each thread scans R consecutive rows in registers, their flags
// a bit mask: for D = 1, R = 16 (where the tile is whole and the pointers
// 16-byte aligned, each warp loads and stores its rows as coalesced 16-byte
// chunks through shared memory, and each thread its flags in one 16-byte
// load; blocked loads of 16 rows a thread, each lane 64 bytes from the
// next, ran slower); for D > 1, R = 4 rows of a group of DC = 4 columns
// (the columns are independent scans under the rows' common flags, so a
// tile of a D-column input is ceil(D / 4) tiles of a look-back chain each,
// one packed 64-bit word per column). Then warp shuffles scan
// the threads' aggregates, a serial pass over the (at most 16) warps' gives
// each warp its prefix, DC threads run the look-back, and every row takes
// the carried prefix unless a boundary came before it in the tile. The
// kernel masks its own ragged tail (missing rows read as boundaries).
//
// The prefix scan (prefix_scan_fwd below) is the same tile scan with the
// flags compiled out. It replaces the Pallas TPU kernel src/repro/kernels/
// ssd_scan/prefix.py::prefix_scan_fwd (pallas_call at :62), whose sequential
// grid carried the running value in a VMEM scalar: the inclusive scan of an
// (N,) int32 or f32 array under sum, max or min, forward or from the tail.
// Bound by bytes: it reads the input once and writes the scan once (at the
// hybrid path's 2^27 int32: 1.07 GB, 0.32 ms at 3.35 TB/s). A reverse scan
// cuts its tiles from the head of the array as a forward one does, so every
// whole tile keeps its 16-byte chunks; the look-back takes them last tile
// first (the ragged tile is the first in its order), and each thread, warp
// and block combines its rows, lanes and warps from the high end down. No
// boundary ends its look-back, so warp 0 walks it 32 tiles a round trip
// (lookback.cuh). Max and min combine as torch.cummax and torch.cummin do
// (`pick`), so the result equals theirs bit for bit, NaN rows included; a
// float sum's identity is -0, which leaves every value as it is.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int OP_SUM = 0, OP_MAX = 1, OP_MIN = 2;
constexpr int MAX_WARPS = 16;  // threads per block: 32 .. 512
constexpr unsigned FULL = 0xffffffffu;

template <int OP>
__device__ __forceinline__ int op(int a, int b) {
  if (OP == OP_SUM) return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  if (OP == OP_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <int OP>
__device__ __forceinline__ float op(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (isnan(a) || isnan(b)) return a + b;
  return OP == OP_MAX ? fmaxf(a, b) : fminf(a, b);
}

// The prefix scan's combine of a (earlier) and b (later): torch.cummax's and
// torch.cummin's rule, a NaN winning and the later of two equal values (two
// NaNs, or -0 and +0) kept. It selects one operand, so the NaN's bits and a
// zero's sign come through as torch's do; it is associative.
template <int OP>
__device__ __forceinline__ float pick(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (isnan(b)) return b;
  if (isnan(a)) return a;
  return (OP == OP_MAX ? b >= a : b <= a) ? b : a;
}

template <int OP>
__device__ __forceinline__ int pick(int a, int b) {
  return op<OP>(a, b);
}

// the scan's combine: op under the segmented scan's flags, pick without
template <int OP, bool SEG, typename T>
__device__ __forceinline__ T cmb(T a, T b) {
  if constexpr (SEG) return op<OP>(a, b);
  else return pick<OP>(a, b);
}

// the identity of op on the type of the (unused) argument
template <int OP>
__device__ __forceinline__ int identity(int) {
  return OP == OP_SUM ? 0 : OP == OP_MAX ? INT_MIN : INT_MAX;
}

template <int OP>
__device__ __forceinline__ float identity(float) {
  return OP == OP_SUM ? -0.f : OP == OP_MAX ? -INFINITY : INFINITY;
}

__device__ __forceinline__ uint32_t to_bits(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ int from_bits<int>(uint32_t b) { return static_cast<int>(b); }
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }

// where a warp's 16-byte chunk c sits in its staging area: lane L reads
// chunks 4L .. 4L + 3 of its rows, so eight lanes at a time would hit two
// 16-byte bank groups; XOR-ing the chunk's low bits with bits 3-4 spreads
// them over all eight, and keeps lane-consecutive chunks apart too
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 3); }

// a partial scan: DC column values, whether it holds a boundary, whether it
// holds any row at all (an empty one is the combine's identity)
template <typename T, int DC>
struct Carry {
  T v[DC];
  bool f, has;
};

// a then b, a first
template <typename T, int OP, int DC, bool SEG>
__device__ __forceinline__ Carry<T, DC> combine(const Carry<T, DC>& a, const Carry<T, DC>& b) {
  if (!a.has) return b;
  if (!b.has) return a;
  Carry<T, DC> r;
#pragma unroll
  for (int c = 0; c < DC; ++c) r.v[c] = b.f ? b.v[c] : cmb<OP, SEG>(a.v[c], b.v[c]);
  r.f = a.f || b.f;
  r.has = true;
  return r;
}

// Which scan scan_kernel runs; as its first template argument, the name a
// profile or a trace shows beside the kernel's.
struct Segmented {  // under the rows' flags
  static constexpr bool seg = true, rev = false;
};
struct Prefix {  // no flags (`flags` unused)
  static constexpr bool seg = false, rev = false;
};
struct PrefixReverse {  // no flags, from the tail
  static constexpr bool seg = false, rev = true;
};

// Both scans, one tile a block, in one template: the segmented scan takes
// at most 32 registers a thread (four blocks of 512 threads on an SM, its
// 2048 threads): a tile's serial steps (the tile counter, the block's
// barriers, the look-back) leave its loads idle, and only more blocks on the
// SM cover that; at 50 registers (three 256-thread blocks) it ran slower.
// The prefix scan takes 40 (three blocks): at 32 it spilled, and ran slower.
// (The body as a __forceinline__ __device__ function under two __global__
// entry points spilled more, and the segmented scan ran 27 % slower.)
template <typename Kind, typename T, int OP, int DC, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32, Kind::seg ? 4 : 3)
scan_kernel(const T* __restrict__ v, const uint8_t* __restrict__ flags, T* __restrict__ out,
            long n, int d, int n_groups, bool aligned, unsigned* counter, uint64_t* words) {
  constexpr bool SEG = Kind::seg, REV = Kind::rev;
  static_assert(SEG || DC == 1, "the prefix scan is one column");
  static_assert(!(SEG && REV), "the segmented scan runs forward");
  __shared__ uint4 stage_all[DC == 1 ? MAX_WARPS * 8 * R : 1];
  __shared__ Carry<T, DC> warp_agg[MAX_WARPS];
  __shared__ Carry<T, DC> tile_prefix;
  __shared__ long s_vt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  if (tid == 0) s_vt = lookback::next_tile(counter);
  __syncthreads();
  const long vt = s_vt;
  // the tile in the look-back's order, and where its rows lie: a reverse
  // scan takes the array's tiles last first
  const long tile = vt / n_groups;
  const long at = REV ? static_cast<long>(gridDim.x) - 1 - tile : tile;
  const int c0 = static_cast<int>(vt % n_groups) * DC;
  const long row0 = (at * blockDim.x + tid) * R;
  const T ident = identity<OP>(T());

  // load R rows (missing rows: boundaries holding the identity; the prefix
  // scan's hold the identity only); bit j of fm: row j is a boundary
  T x[R][DC];
  uint32_t fm = 0;
  // a whole tile of 16-byte aligned rows: each warp loads and stores its
  // 32 R rows in 16-byte chunks, neighbouring lanes on neighbouring chunks,
  // through `stage` (a lane's R rows are R / 4 consecutive chunks there)
  bool whole = false;
  uint4* stage = stage_all + warp * (8 * R);
  const long warp_row0 = (at * blockDim.x + warp * 32) * R;
  if constexpr (DC == 1) {
    static_assert(R == 16, "the staging swizzle and the flag loads assume 16 rows a thread");
    whole = aligned && (at + 1) * blockDim.x * R <= n;
    if (whole) {
      const uint4* src = reinterpret_cast<const uint4*>(v + warp_row0);
#pragma unroll
      for (int j = 0; j < R / 4; ++j) stage[swizzle(32 * j + lane)] = src[32 * j + lane];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        const uint4 q = stage[swizzle(lane * (R / 4) + j)];
        x[4 * j][0] = from_bits<T>(q.x), x[4 * j + 1][0] = from_bits<T>(q.y);
        x[4 * j + 2][0] = from_bits<T>(q.z), x[4 * j + 3][0] = from_bits<T>(q.w);
      }
      __syncwarp();  // the stores below reuse `stage`
      if constexpr (SEG) {
#pragma unroll
        for (int j = 0; j < R; j += 16) {
          const uint4 q = *reinterpret_cast<const uint4*>(flags + row0 + j);
          const uint32_t b4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            // bit 0 of each byte that is not zero, gathered into 4 bits
            const uint32_t m = __vcmpne4(b4[b], 0u) & 0x01010101u;
            fm |= ((m | m >> 7 | m >> 14 | m >> 21) & 0xfu) << (j + 4 * b);
          }
        }
      }
    }
  }
  if (!whole) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long r = row0 + j;
      if constexpr (SEG) fm |= static_cast<uint32_t>(r >= n || flags[r] != 0) << j;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        x[j][c] = (r < n && c0 + c < d) ? v[r * d + c0 + c] : ident;
    }
  }

  // the thread's own scan (from its last row down under REV); rows from
  // `first` on follow a boundary of its own
  if constexpr (REV) {
#pragma unroll
    for (int j = R - 2; j >= 0; --j) x[j][0] = cmb<OP, SEG>(x[j + 1][0], x[j][0]);
  } else {
#pragma unroll
    for (int j = 1; j < R; ++j) {
      const bool fj = (fm >> j) & 1u;
#pragma unroll
      for (int c = 0; c < DC; ++c) x[j][c] = fj ? x[j][c] : cmb<OP, SEG>(x[j - 1][c], x[j][c]);
    }
  }
  const int first = fm ? __ffs(fm) - 1 : R;

  // inclusive scan of the threads' aggregates over the warp (from lane 31
  // down under REV)
  Carry<T, DC> s;
#pragma unroll
  for (int c = 0; c < DC; ++c) s.v[c] = x[REV ? 0 : R - 1][c];
  s.f = fm != 0;
  s.has = true;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Carry<T, DC> u;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      u.v[c] = REV ? __shfl_down_sync(FULL, s.v[c], o) : __shfl_up_sync(FULL, s.v[c], o);
    u.f = (REV ? __shfl_down_sync(FULL, static_cast<int>(s.f), o)
               : __shfl_up_sync(FULL, static_cast<int>(s.f), o)) != 0;
    u.has = REV ? lane + o < 32 : lane >= o;
    s = combine<T, OP, DC, SEG>(u, s);
  }
  // the lanes before this one
  Carry<T, DC> lane_prefix;
#pragma unroll
  for (int c = 0; c < DC; ++c)
    lane_prefix.v[c] = REV ? __shfl_down_sync(FULL, s.v[c], 1) : __shfl_up_sync(FULL, s.v[c], 1);
  lane_prefix.f = (REV ? __shfl_down_sync(FULL, static_cast<int>(s.f), 1)
                       : __shfl_up_sync(FULL, static_cast<int>(s.f), 1)) != 0;
  lane_prefix.has = REV ? lane < 31 : lane > 0;
  if (lane == (REV ? 0 : 31)) warp_agg[warp] = s;
  __syncthreads();

  // the warps before this one
  Carry<T, DC> warp_prefix;
  warp_prefix.has = false;
  if constexpr (REV) {
    for (int i = nw - 1; i > warp; --i)
      warp_prefix = combine<T, OP, DC, SEG>(warp_prefix, warp_agg[i]);
  } else {
    for (int i = 0; i < warp; ++i) warp_prefix = combine<T, OP, DC, SEG>(warp_prefix, warp_agg[i]);
  }

  // the look-back: thread c carries column c's chain (the segmented scan,
  // whose walks end at the first aggregate holding a boundary); warp 0 the
  // prefix scan's one chain, which no boundary ends
  if constexpr (SEG) {
    if (tid < DC) {
      Carry<T, DC> agg;
      agg.has = false;
      for (int i = 0; i < nw; ++i) agg = combine<T, OP, DC, SEG>(agg, warp_agg[i]);
      uint64_t* word = words + vt * DC + tid;
      const T mine = agg.v[tid];
      T pre = ident;
      if (tile == 0 || agg.f) {
        lookback::publish(word, lookback::kPrefix, to_bits(mine));
      } else {
        lookback::publish(word, lookback::kAggregate, to_bits(mine));
      }
      if (tile > 0) {
        pre = from_bits<T>(lookback::exclusive_prefix(
            words, vt * DC + tid, static_cast<long>(n_groups) * DC, tile,
            [](uint32_t a, uint32_t b) {
              return to_bits(cmb<OP, SEG>(from_bits<T>(a), from_bits<T>(b)));
            }));
        if (!agg.f) lookback::publish(word, lookback::kPrefix, to_bits(cmb<OP, SEG>(pre, mine)));
      }
      tile_prefix.v[tid] = pre;
      if (tid == 0) {
        tile_prefix.f = false;
        tile_prefix.has = tile > 0;
      }
    }
  } else {
    if (warp == 0) {
      T mine = warp_agg[REV ? nw - 1 : 0].v[0];
      for (int k = 1; k < nw; ++k)
        mine = cmb<OP, SEG>(mine, warp_agg[REV ? nw - 1 - k : k].v[0]);
      uint64_t* word = words + vt;
      if (lane == 0)
        lookback::publish(word, tile == 0 ? lookback::kPrefix : lookback::kAggregate,
                          to_bits(mine));
      T pre = ident;
      if (tile > 0) {
        pre = from_bits<T>(lookback::warp_exclusive_prefix(
            words, vt, 1, tile,
            [](uint32_t a, uint32_t b) {
              return to_bits(cmb<OP, SEG>(from_bits<T>(a), from_bits<T>(b)));
            },
            to_bits(ident)));
        if (lane == 0)
          lookback::publish(word, lookback::kPrefix, to_bits(cmb<OP, SEG>(pre, mine)));
      }
      if (lane == 0) {
        tile_prefix.v[0] = pre;
        tile_prefix.f = false;
        tile_prefix.has = tile > 0;
      }
    }
  }
  __syncthreads();

  // every row before the thread's first boundary takes the carried prefix
  const Carry<T, DC> pre = combine<T, OP, DC, SEG>(
      combine<T, OP, DC, SEG>(tile_prefix, warp_prefix), lane_prefix);
  if (pre.has) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        x[j][c] = j >= first ? x[j][c] : cmb<OP, SEG>(pre.v[c], x[j][c]);
    }
  }

  if (whole) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      stage[swizzle(lane * (R / 4) + j)] =
          make_uint4(to_bits(x[4 * j][0]), to_bits(x[4 * j + 1][0]), to_bits(x[4 * j + 2][0]),
                     to_bits(x[4 * j + 3][0]));
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + warp_row0);
#pragma unroll
    for (int j = 0; j < R / 4; ++j) dst[32 * j + lane] = stage[swizzle(32 * j + lane)];
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long r = row0 + j;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (r < n && c0 + c < d) out[r * d + c0 + c] = x[j][c];
    }
  }
}

constexpr int R1 = 16;  // rows per thread at D = 1
constexpr int RD = 4;   // rows per thread at D > 1
constexpr int DCD = 4;  // columns per group at D > 1

struct Geometry {
  long n_tiles, n_groups, words, scratch_bytes;
};

Geometry geometry(long n, int d, int threads) {
  Geometry g;
  const long rows = static_cast<long>(threads) * (d == 1 ? R1 : RD);
  const int dc = d == 1 ? 1 : DCD;
  g.n_tiles = (n + rows - 1) / rows;
  g.n_groups = (d + dc - 1) / dc;
  g.words = g.n_tiles * g.n_groups * dc;
  g.scratch_bytes = 8 + 8 * g.words;  // the tile counter, then the words
  return g;
}

template <typename T, int OP>
cudaError_t launch(const void* v, const void* flags, void* out, long n, int d, int threads,
                   void* scratch, cudaStream_t stream) {
  const Geometry g = geometry(n, d, threads);
  const bool aligned = ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(flags) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaError_t err = cudaMemsetAsync(scratch, 0, g.scratch_bytes, stream);
  if (err != cudaSuccess) return err;
  unsigned* counter = static_cast<unsigned*>(scratch);
  uint64_t* words = reinterpret_cast<uint64_t*>(static_cast<char*>(scratch) + 8);
  const dim3 grid(static_cast<unsigned>(g.n_tiles * g.n_groups));
  if (d == 1)
    scan_kernel<Segmented, T, OP, 1, R1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const uint8_t*>(flags), static_cast<T*>(out), n, d,
        1, aligned, counter, words);
  else
    scan_kernel<Segmented, T, OP, DCD, RD><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const uint8_t*>(flags), static_cast<T*>(out), n, d,
        static_cast<int>(g.n_groups), aligned, counter, words);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_prefix(const void* x, void* out, long n, bool reverse, int threads,
                          void* scratch, cudaStream_t stream) {
  const Geometry g = geometry(n, 1, threads);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaError_t err = cudaMemsetAsync(scratch, 0, g.scratch_bytes, stream);
  if (err != cudaSuccess) return err;
  unsigned* counter = static_cast<unsigned*>(scratch);
  uint64_t* words = reinterpret_cast<uint64_t*>(static_cast<char*>(scratch) + 8);
  const dim3 grid(static_cast<unsigned>(g.n_tiles));
  if (reverse)
    scan_kernel<PrefixReverse, T, OP, 1, R1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(out), n, 1, 1, aligned, counter,
        words);
  else
    scan_kernel<Prefix, T, OP, 1, R1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(out), n, 1, 1, aligned, counter,
        words);
  return cudaGetLastError();
}

}  // namespace

// values (n, d) int32 (dtype 0) or float32 (dtype 1), flags (n,) bool, out
// (n, d) of the values' dtype, all contiguous; op 0 sum, 1 max, 2 min;
// threads a multiple of 32 in [32, 512]; scratch 8-byte aligned, of at
// least 8 bytes (the tile counter) and 8 more per tile and column of a group
// (the look-back's words). Zeroes the scratch and launches one kernel on
// `stream`; returns cudaGetLastError() after the launch (0 on success).
extern "C" int segment_reduce_fwd(const void* v, const void* flags, void* out, long long n, int d,
                                  int dtype, int op_, int threads, void* scratch,
                                  long long scratch_bytes, void* stream) {
  if (n < 1 || d < 1 || threads < 32 || threads > MAX_WARPS * 32 || threads % 32 != 0 ||
      (dtype != 0 && dtype != 1) || op_ < 0 || op_ > 2 ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0 ||
      scratch_bytes < geometry(n, d, threads).scratch_bytes)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (op_ == OP_SUM) return launch<int, OP_SUM>(v, flags, out, n, d, threads, scratch, s);
    if (op_ == OP_MAX) return launch<int, OP_MAX>(v, flags, out, n, d, threads, scratch, s);
    return launch<int, OP_MIN>(v, flags, out, n, d, threads, scratch, s);
  }
  if (op_ == OP_SUM) return launch<float, OP_SUM>(v, flags, out, n, d, threads, scratch, s);
  if (op_ == OP_MAX) return launch<float, OP_MAX>(v, flags, out, n, d, threads, scratch, s);
  return launch<float, OP_MIN>(v, flags, out, n, d, threads, scratch, s);
}

// x and out (n,) int32 (dtype 0) or float32 (dtype 1), contiguous; op 0
// sum, 1 max, 2 min; reverse 1 scans from the tail; rows, a tile's rows: 16
// a thread, for a multiple of 32 threads in [32, 512] (the caller chooses
// the tile, so its edges are where the caller puts them); scratch 8-byte
// aligned, of at least 8 bytes (the tile counter) and 8 more per tile (the
// look-back's words). Zeroes the scratch and launches one kernel on
// `stream`; returns cudaGetLastError() after the launch (0 on success).
extern "C" int prefix_scan_fwd(const void* x, void* out, long long n, int dtype, int op_,
                               int reverse, int rows, void* scratch, long long scratch_bytes,
                               void* stream) {
  const int threads = rows % R1 == 0 ? rows / R1 : 0;
  if (n < 1 || threads < 32 || threads > MAX_WARPS * 32 || threads % 32 != 0 ||
      (dtype != 0 && dtype != 1) || op_ < 0 || op_ > 2 || (reverse != 0 && reverse != 1) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0 ||
      scratch_bytes < geometry(n, 1, threads).scratch_bytes)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0;
  if (dtype == 0) {
    if (op_ == OP_SUM) return launch_prefix<int, OP_SUM>(x, out, n, rev, threads, scratch, s);
    if (op_ == OP_MAX) return launch_prefix<int, OP_MAX>(x, out, n, rev, threads, scratch, s);
    return launch_prefix<int, OP_MIN>(x, out, n, rev, threads, scratch, s);
  }
  if (op_ == OP_SUM) return launch_prefix<float, OP_SUM>(x, out, n, rev, threads, scratch, s);
  if (op_ == OP_MAX) return launch_prefix<float, OP_MAX>(x, out, n, rev, threads, scratch, s);
  return launch_prefix<float, OP_MIN>(x, out, n, rev, threads, scratch, s);
}

extern "C" const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
