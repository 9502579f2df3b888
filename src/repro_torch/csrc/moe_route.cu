// Fused MoE routing for Hopper (sm_90a), CUDA C++, in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route/moe_route.py::
// moe_route_fwd (pallas_call at :68). It computes what that kernel
// computes, for logits (T, E) in f32: the softmax exp(l - max) / sum; the
// top k (k <= 2) experts by probability, the lowest index winning a tie;
// their weights renormalised as w / max(sum w, 1e-9); and each assignment's
// ordinal within its expert in token-major, slot-minor order, with
// keep = ordinal < capacity. A NaN probability counts as the largest, the
// first one winning, as torch.argmax and jax.lax.top_k take it: a row with
// a NaN or an infinite logit, whose probabilities are all NaN, routes to
// experts 0 and 1 (the Pallas kernel gives 0 twice there).
//
// What bounds it on this card: launch latency. At the Mixtral prefill
// (T = 2048, E = 8, k = 2) it reads 64 KB and writes 52 KB, some 0.035 us
// at 3.35 TB/s; at a decode tick (T = 4) a few hundred bytes. The work is a
// few operations per logit.
//
// Design. The TPU kernel's sequential grid over token tiles carried the
// per-expert counts in VMEM scratch. Here a grid of ceil(T / 256) blocks
// routes 256 tokens each, one per thread, and takes the counts of the tiles
// before it from a decoupled look-back (lookback.cuh): each expert's count
// is one chain of packed 64-bit words, walked by one thread per expert. A
// token's ordinal is the carried count of its expert, plus the assignments
// of earlier warps of its tile to that expert (a scan over the warps'
// per-expert counts), plus those of earlier lanes of its own warp (ballots
// over the expert ids of both slots). One tile (T <= 256, every decode
// tick) needs no look-back, no scratch and no memset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int NT = 256;       // tokens per tile, one per thread
constexpr int NW = NT / 32;   // warps
constexpr int MAX_E = 64;
constexpr unsigned FULL = 0xffffffffu;

// p ranks above v: larger, or NaN where v is not
__device__ __forceinline__ bool above(float p, float v) {
  return p > v || (isnan(p) && !isnan(v));
}

__global__ void __launch_bounds__(NT)
moe_route_kernel(const float* __restrict__ logits, float* __restrict__ w,
                 int* __restrict__ idx, int* __restrict__ pos, bool* __restrict__ keep, int T,
                 int E, int k, int capacity, unsigned* counter, uint64_t* words) {
  __shared__ int base[NW][MAX_E];  // per warp: its count, then its base in the expert
  __shared__ long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;  // lanes before this one
  if (tid == 0) s_tile = gridDim.x == 1 ? 0 : lookback::next_tile(counter);
  __syncthreads();
  const long tile = s_tile;

  const long t = tile * NT + tid;
  const bool live = t < T;
  int i0 = -1, i1 = -1;
  float v0 = -INFINITY, v1 = -INFINITY;
  if (live) {
    const float* row = logits + t * E;
    float m = -INFINITY;
    for (int e = 0; e < E; ++e) m = fmaxf(m, row[e]);
    float s = 0.f;
    for (int e = 0; e < E; ++e) s += expf(row[e] - m);
    // one pass in index order; strict comparisons keep the lower index,
    // so i0 and (for E >= 2) i1 are always set
    for (int e = 0; e < E; ++e) {
      const float p = expf(row[e] - m) / s;
      if (above(p, v0)) {
        v1 = v0;
        i1 = i0;
        v0 = p;
        i0 = e;
      } else if (above(p, v1)) {
        v1 = p;
        i1 = e;
      }
    }
  }

  // ordinals within the warp, and the warp's count per expert
  int r0 = 0, r1 = 0;
  for (int e = 0; e < E; ++e) {
    const unsigned b0 = __ballot_sync(FULL, live && i0 == e);
    const unsigned b1 = __ballot_sync(FULL, live && k == 2 && i1 == e);
    const int before = __popc(b0 & lower) + __popc(b1 & lower);
    if (i0 == e) r0 = before;
    if (i1 == e) r1 = before;  // this token's own slot 0 has another expert
    if (lane == 0) base[warp][e] = __popc(b0) + __popc(b1);
  }
  __syncthreads();
  if (tid < E) {
    const int e = tid;
    int c = 0;  // the tile's assignments to e, then its warps' bases
    for (int wi = 0; wi < NW; ++wi) {
      const int n = base[wi][e];
      base[wi][e] = c;
      c += n;
    }
    if (gridDim.x > 1) {
      uint64_t* word = words + tile * E + e;
      int carried = 0;  // assignments to e in the tiles before this one
      if (tile == 0) {
        lookback::publish(word, lookback::kPrefix, static_cast<uint32_t>(c));
      } else {
        lookback::publish(word, lookback::kAggregate, static_cast<uint32_t>(c));
        carried = static_cast<int>(lookback::exclusive_prefix(
            words, tile * E + e, E, tile, [](uint32_t a, uint32_t b) { return a + b; }));
        lookback::publish(word, lookback::kPrefix, static_cast<uint32_t>(carried + c));
      }
      for (int wi = 0; wi < NW; ++wi) base[wi][e] += carried;
    }
  }
  __syncthreads();
  if (live) {
    const long o = t * k;
    const float d = fmaxf(k == 2 ? v0 + v1 : v0, 1e-9f);
    const int p0 = base[warp][i0] + r0;
    w[o] = v0 / d;
    idx[o] = i0;
    pos[o] = p0;
    keep[o] = p0 < capacity;
    if (k == 2) {
      const int p1 = base[warp][i1] + r1;
      w[o + 1] = v1 / d;
      idx[o + 1] = i1;
      pos[o + 1] = p1;
      keep[o + 1] = p1 < capacity;
    }
  }
}

long scratch_bytes(int T, int E) {
  const long tiles = (T + NT - 1) / NT;
  return tiles > 1 ? 8 + 8 * tiles * E : 0;  // the tile counter, then a word per (tile, expert)
}

}  // namespace

// logits (T, E) float32; w (T, k) float32, idx and pos (T, k) int32, keep
// (T, k) bool; all contiguous; 1 <= k <= 2, k <= E <= 64; scratch 8-byte
// aligned, of at least 8 + 8 E ceil(T / 256) bytes where T > 256 (a tile
// counter and a word per tile and expert; none for one tile). Zeroes the
// scratch (where there is one) and launches ceil(T / 256) blocks on
// `stream`; returns cudaGetLastError() after the launch (0 on success).
extern "C" int moe_route_fwd(const void* logits, void* w, void* idx, void* pos, void* keep,
                             int T, int E, int k, int capacity, void* scratch,
                             long long scratch_bytes_given, void* stream) {
  const long need = scratch_bytes(T, E);
  if (k < 1 || k > 2 || E < k || E > MAX_E || T < 1 || scratch_bytes_given < need ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need > 0) {
    const cudaError_t err = cudaMemsetAsync(scratch, 0, need, s);
    if (err != cudaSuccess) return err;
  }
  unsigned* counter = need > 0 ? static_cast<unsigned*>(scratch) : nullptr;
  uint64_t* words =
      need > 0 ? reinterpret_cast<uint64_t*>(static_cast<char*>(scratch) + 8) : nullptr;
  moe_route_kernel<<<(T + NT - 1) / NT, NT, 0, s>>>(
      static_cast<const float*>(logits), static_cast<float*>(w), static_cast<int*>(idx),
      static_cast<int*>(pos), static_cast<bool*>(keep), T, E, k, capacity, counter, words);
  return cudaGetLastError();
}

extern "C" const char* moe_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
