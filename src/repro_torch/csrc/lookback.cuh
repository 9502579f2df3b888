// Decoupled look-back over tile prefixes (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA, 2016): how a
// one-pass kernel carries a 32-bit value from tile to tile when its blocks
// run in parallel and in no order. Header-only, included by the CUDA
// sources of this directory.
//
// Each tile owns one 64-bit word per chain it carries (a column of a
// segmented scan, an expert of the router): the status in the high 32 bits,
// the value's bits in the low 32, stored at once, so a reader never sees a
// status without its value. A tile publishes its own aggregate (kAggregate)
// as soon as it has it, then walks back over its predecessors' words,
// combining their aggregates until it meets one that holds an inclusive
// prefix (kPrefix), and publishes its own inclusive prefix. A tile that
// needs nothing before it (the first, or a segmented tile whose aggregate
// holds a boundary) publishes its aggregate as its prefix at once.
//
// The prefix scan's chain, which no boundary ends, walks with a whole warp
// (warp_exclusive_prefix): with some 400 tiles in flight at once, a tile's
// nearest published prefix can lie many tiles back, and one thread reading
// one word per round trip to L2 would hold up every tile behind it; 32
// lanes read 32 predecessors' words a round trip. (The bucket router's many
// chains, one thread each, walked faster so than a warp at a time.)
//
// The words and a tile counter live in scratch that the entry point zeroes
// with cudaMemsetAsync on the kernel's stream before each launch. A block
// takes its tile from the counter, not from blockIdx: tiles are then handed
// out in the order blocks start, so a block only ever waits on tiles whose
// blocks are already running, and the walk cannot deadlock on a block that
// was never scheduled.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr uint32_t kAggregate = 1;  // the tile's own aggregate
constexpr uint32_t kPrefix = 2;     // the inclusive prefix through the tile

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// the next tile in the order blocks started; one thread of the block calls it
__device__ __forceinline__ long next_tile(unsigned* counter) {
  return static_cast<long>(atomicAdd(counter, 1u));
}

__device__ __forceinline__ void publish(uint64_t* word, uint32_t status, uint32_t bits) {
  store_release(word, (static_cast<uint64_t>(status) << 32) | bits);
}

// The exclusive prefix of the tile whose word is words[self]: the
// combination, earliest first, of the values of its `preds` >= 1
// predecessors, whose words are words[self - step], words[self - 2 step],
// ... It waits on each word until that tile has published, and stops at the
// first that holds an inclusive prefix. `op(earlier, later)` combines two
// values' bits.
template <class Op>
__device__ uint32_t exclusive_prefix(const uint64_t* words, long self, long step, long preds,
                                     Op op) {
  uint32_t acc = 0;
  for (long i = 1; i <= preds; ++i) {
    const uint64_t* w = words + (self - i * step);
    uint64_t x = load_acquire(w);
    while ((x >> 32) == 0) {
      __nanosleep(32);
      x = load_acquire(w);
    }
    const uint32_t bits = static_cast<uint32_t>(x);
    acc = i == 1 ? bits : op(bits, acc);
    if (static_cast<uint32_t>(x >> 32) & kPrefix) break;
  }
  return acc;
}

// exclusive_prefix walked by a whole warp, which must call it together (all
// 32 lanes, converged): lane l reads the word of the predecessor at distance
// base + l + 1, in windows of 32, and waits for it; the window's values from
// the nearest published prefix down to the tile's neighbour combine,
// earliest first, by an ordered tree over the lanes. `ident` is the bits of
// op's identity (what a lane past the prefix, or past the first tile,
// contributes). Returns the exclusive prefix on every lane.
template <class Op>
__device__ uint32_t warp_exclusive_prefix(const uint64_t* words, long self, long step,
                                          long preds, Op op, uint32_t ident) {
  const int lane = threadIdx.x & 31;
  uint32_t acc = ident;  // the windows walked so far, all later than the next
  for (long base = 0; base < preds; base += 32) {
    const long i = base + lane + 1;
    uint64_t x = 0;
    if (i <= preds) {
      const uint64_t* w = words + (self - i * step);
      x = load_acquire(w);
      while ((x >> 32) == 0) {
        __nanosleep(32);
        x = load_acquire(w);
      }
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, static_cast<uint32_t>(x >> 32) & kPrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;  // the nearest published prefix
    uint32_t v = i <= preds && lane <= stop ? static_cast<uint32_t>(x) : ident;
    // lane l + off holds an earlier span than lane l
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t o = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v = op(o, v);
    }
    acc = op(__shfl_sync(0xffffffffu, v, 0), acc);
    if (prefix) break;
  }
  return acc;
}

}  // namespace lookback
