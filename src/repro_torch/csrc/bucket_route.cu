// Shuffle bucket routing (capacity ordinals) for Hopper (sm_90a), CUDA C++,
// in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route/route.py::
// bucket_route_fwd (pallas_call at :60). It computes what that kernel
// computes, for (N,) int32 destinations in [0, P], P the padding sentinel:
// each row's ordinal `pos` among the earlier rows to its bucket (the rank a
// stable argsort by destination gives), keep = pos < capacity & dest < P,
// and `counts`, each bucket's rows. A row to the sentinel or past it takes
// pos 0 and keep false and counts nowhere.
//
// What bounds it on this card: launch latency, then bytes. At the hybrid
// join's 2^20 rows over P = 64 buckets it reads 4 MB and writes 5 MB, some
// 0.003 ms at 3.35 TB/s; a launch and its memset take longer.
//
// Design. The TPU kernel's sequential grid over row tiles carried the
// per-bucket counts in a VMEM (1, P) scratch row. Here every block routes one
// tile and takes the counts of the tiles before it from a decoupled
// look-back (lookback.cuh), one chain of packed 64-bit words per bucket,
// walked by one thread each, as moe_route.cu carries its per-expert counts.
// In a tile each warp owns a contiguous run of rows and walks it twice, 32
// rows a round, neighbouring lanes on neighbouring rows, each lane loading U
// rounds' rows at once. The first walk counts the warp's rows per bucket in
// a (warps, P) table in shared memory (a shared atomic a row: counts need no
// order). An exclusive scan over the warps, per bucket, turns the table into
// each warp's base in the tile, and the look-back adds the count carried
// into the tile. The second walk reads the rows again (from L2): a row's
// peers are the lanes with its bucket (a ballot per bit of the bucket id;
// __match_any_sync ran slower), its ordinal its warp's base plus the peers
// below its lane, and the lowest peer advances the base by its group.
//
// Any P whose one warp's table and counts fit in shared memory (8 P bytes,
// at most MAX_SMEM): the table takes 4 P bytes a warp, and the tile's counts
// 4 P more. The caller chooses the warps of a block and the rows of a tile
// (kernels/moe_route/route.py::geometry: as many warps as 48 KB holds, at
// least one, above 48 KB by opting in to more dynamic shared memory, and a
// tile at least 16 P rows, so the look-back's words, 8 P bytes a tile, stay
// an eighth of the tile's input); the entry point takes any tile of whole
// batches of U rounds for each warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int MAX_WARPS = 16;               // threads per block: 32 .. 512
constexpr long MAX_SMEM = 227 * 1024 - 16;  // dynamic shared memory a block may take
constexpr int U = 8;                        // rounds of 32 rows a warp loads at once
constexpr unsigned FULL = 0xffffffffu;

// the lanes whose bucket is b (b's peers), from one ballot per bit of the
// `bits` a bucket id takes
__device__ __forceinline__ unsigned peers_of(int b, int bits) {
  unsigned peers = FULL;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (b >> i) & 1;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
bucket_route_kernel(const int* __restrict__ dest, int* __restrict__ pos, bool* __restrict__ keep,
                    int* __restrict__ counts, long n, int p, int capacity, long rows,
                    unsigned* counter, uint64_t* words) {
  // [warp][bucket]: the warp's count, then its base; then [bucket]: the tile's count
  extern __shared__ int table[];
  __shared__ long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;  // lanes before this one
  int* tile_count = table + nw * p;
  if (tid == 0) s_tile = gridDim.x == 1 ? 0 : lookback::next_tile(counter);
  for (int i = tid; i < nw * p; i += blockDim.x) table[i] = 0;
  __syncthreads();
  const long tile = s_tile;
  const long per_warp = rows / nw;
  const long r0 = tile * rows + warp * per_warp;  // the warp's rows: [r0, r1)
  const long r1 = r0 + per_warp < n ? r0 + per_warp : n;
  int* mine = table + warp * p;
  const int bits = 32 - __clz(p);  // of a bucket id, the sentinel p included

  // 1. the warp's count per bucket, U rounds of rows loaded at once (the
  // counts need no order: each lane adds its own row)
  for (long base = r0; base < r1; base += 32 * U) {
    int b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long r = base + 32 * u + lane;
      const int d = r < r1 ? dest[r] : p;  // an id past p (or below 0) goes to p
      b[u] = static_cast<unsigned>(d) <= static_cast<unsigned>(p) ? d : p;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (static_cast<unsigned>(b[u]) < static_cast<unsigned>(p)) atomicAdd(mine + b[u], 1);
  }
  __syncthreads();

  // 2. per bucket (a thread each, the same in 3): each warp's base in the
  // tile (an exclusive scan over the warps), and the tile's count, published
  // (as the prefix at tile 0)
  for (int b = tid; b < p; b += blockDim.x) {
    int c = 0;
    for (int w = 0; w < nw; ++w) {
      const int k = table[w * p + b];
      table[w * p + b] = c;
      c += k;
    }
    tile_count[b] = c;
    if (gridDim.x == 1)
      counts[b] = c;
    else
      lookback::publish(words + tile * p + b,
                        tile == 0 ? lookback::kPrefix : lookback::kAggregate,
                        static_cast<uint32_t>(c));
  }
  // 3. per bucket: the count carried into the tile
  if (gridDim.x > 1) {
    for (int b = tid; b < p; b += blockDim.x) {
      const uint32_t c = static_cast<uint32_t>(tile_count[b]);
      uint32_t carried = 0;
      if (tile > 0) {
        carried = lookback::exclusive_prefix(words, tile * p + b, p, tile,
                                             [](uint32_t a, uint32_t x) { return a + x; });
        lookback::publish(words + tile * p + b, lookback::kPrefix, carried + c);
        for (int w = 0; w < nw; ++w) table[w * p + b] += static_cast<int>(carried);
      }
      if (tile == gridDim.x - 1) counts[b] = static_cast<int>(carried + c);
    }
  }
  __syncthreads();

  // 4. the ordinals: the warp's rows again (from L2), in order
  for (long base = r0; base < r1; base += 32 * U) {
    int b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long r = base + 32 * u + lane;
      const int d = r < r1 ? dest[r] : p;  // an id past p (or below 0) goes to p
      b[u] = static_cast<unsigned>(d) <= static_cast<unsigned>(p) ? d : p;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned peers = peers_of(b[u], bits);
      const int leader = __ffs(peers) - 1;
      const bool routed = static_cast<unsigned>(b[u]) < static_cast<unsigned>(p);
      int first = 0;
      if (routed && lane == leader) first = atomicAdd(mine + b[u], __popc(peers));
      first = __shfl_sync(FULL, first, leader);
      const long r = base + 32 * u + lane;
      if (r < r1) {
        const int q = routed ? first + __popc(peers & lower) : 0;
        pos[r] = q;
        keep[r] = routed && q < capacity;
      }
    }
  }
}

}  // namespace

// dest (n,) int32, pos (n,) int32, keep (n,) bool, counts (p,) int32, all
// contiguous; p >= 1; warps, the block's, in [1, 16], with their tables and
// the tile's counts, 4 (warps + 1) p bytes, within MAX_SMEM; rows, a tile's,
// a positive multiple of 32 U warps; scratch 8-byte aligned, of at least a
// tile counter and a word per tile and bucket (none for one tile). Zeroes
// the scratch (where there is one) and launches one kernel on `stream`;
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int bucket_route_fwd(const void* dest, void* pos, void* keep, void* counts,
                                long long n, int p, int capacity, int warps, long long rows,
                                void* scratch, long long scratch_bytes, void* stream) {
  if (n < 1 || p < 1 || warps < 1 || warps > MAX_WARPS || rows < 1 ||
      rows % (32L * U * warps) != 0 || 4L * (warps + 1) * p > MAX_SMEM ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return cudaErrorInvalidValue;
  const long tiles = (n + rows - 1) / rows;
  // the tile counter, then a word per (tile, bucket); none for one tile
  const long need = tiles > 1 ? 8 + 8 * tiles * p : 0;
  if (scratch_bytes < need || tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  const size_t smem = 4ul * (warps + 1) * p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (smem > 32 * 1024) {  // past the 48 KB a block has unasked, with its own 16
    err = cudaFuncSetAttribute(bucket_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (need > 0) {
    err = cudaMemsetAsync(scratch, 0, need, s);
    if (err != cudaSuccess) return err;
  }
  unsigned* counter = need > 0 ? static_cast<unsigned*>(scratch) : nullptr;
  uint64_t* words =
      need > 0 ? reinterpret_cast<uint64_t*>(static_cast<char*>(scratch) + 8) : nullptr;
  bucket_route_kernel<<<static_cast<unsigned>(tiles), warps * 32, smem, s>>>(
      static_cast<const int*>(dest), static_cast<int*>(pos), static_cast<bool*>(keep),
      static_cast<int*>(counts), n, p, capacity, rows, counter, words);
  return cudaGetLastError();
}

extern "C" const char* bucket_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
