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

}  // namespace lookback
