// Fused MoE routing for Hopper (sm_90a), CUDA C++, in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route/moe_route.py::
// moe_route_fwd (pallas_call at :68). It computes what that kernel
// computes, for logits (T, E) in f32: the softmax exp(l - max) / sum; the
// top k (k <= 16) experts by probability, the lowest index winning a tie;
// their weights renormalised as w / max(sum w, 1e-9), the sum taken slot by
// slot; and each assignment's ordinal within its expert in token-major,
// slot-minor order, with keep = ordinal < capacity. A NaN probability
// counts as the largest, the first one winning, as torch.argmax and
// jax.lax.top_k take it: a row with a NaN or an infinite logit, whose
// probabilities are all NaN, routes to experts 0, 1, ... (the Pallas
// kernel gives 0 twice there).
//
// What bounds it on this card: launch latency. At the Mixtral prefill
// (T = 2048, E = 8, k = 2) it reads 64 KB and writes 52 KB, some 0.035 us
// at 3.35 TB/s; at a decode tick (T = 4) a few hundred bytes. The work is a
// few operations per logit and slot: one pass over the row inserts each
// probability into the sorted top k held in registers.
//
// Design. The TPU kernel's sequential grid over token tiles carried the
// per-expert counts in VMEM scratch. Here a grid of ceil(T / 256) blocks
// routes 256 tokens each, one per thread, and takes the counts of the tiles
// before it from a decoupled look-back (lookback.cuh): each expert's count
// is one chain of packed 64-bit words, walked by one thread per expert. A
// token's ordinal is the carried count of its expert, plus the assignments
// of earlier warps of its tile to that expert (a scan over the warps'
// per-expert counts), plus those of earlier lanes of its own warp (ballots
// over the expert ids of every slot; a token's k experts are distinct, so
// a lane holds an expert in one slot at most). One tile (T <= 256, every
// decode tick) needs no look-back, no scratch and no memset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int NT = 256;       // tokens per tile, one per thread
constexpr int NW = NT / 32;   // warps
constexpr int MAX_E = 128;
constexpr int MAX_K = 16;
constexpr unsigned FULL = 0xffffffffu;

// p ranks above v: larger, or NaN where v is not
__device__ __forceinline__ bool above(float p, float v) {
  return p > v || (isnan(p) && !isnan(v));
}

// KMAX bounds k at compile time: a token's slots sit in registers and the
// loops over them unroll to KMAX. The top-1 and top-2 routers take the
// instances KMAX = k = 1 and 2, where every test of k folds away and the
// insertion compiles to the two compares of a top-2; wider routers take
// KMAX = 16 and stop at the k they are given
template <int KMAX>
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
  const int kk = KMAX == MAX_K ? k : KMAX;

  const long t = tile * NT + tid;
  const bool live = t < T;
  int id[KMAX];
  float v[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    id[j] = -1;
    v[j] = -INFINITY;  // every probability, NaN too, ranks above: no empty-slot test
  }
  if (live) {
    const float* row = logits + t * E;
    float m = -INFINITY;
    for (int e = 0; e < E; ++e) m = fmaxf(m, row[e]);
    float s = 0.f;
    for (int e = 0; e < E; ++e) s += expf(row[e] - m);
    // one pass in index order, each probability inserted into the sorted
    // top k: it takes the first slot whose entry it ranks above (strictly,
    // so a tie keeps the lower index, already there), and every entry from
    // there on moves down a slot
    for (int e = 0; e < E; ++e) {
      float cv = expf(row[e] - m) / s;
      int ci = e;
      bool moving = false;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < kk && (moving || above(cv, v[j]))) {
          const float tv = v[j];
          const int ti = id[j];
          v[j] = cv;
          id[j] = ci;
          cv = tv;
          ci = ti;
          moving = true;
        }
      }
    }
  }

  // ordinals within the warp, and the warp's count per expert
  int r[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) r[j] = 0;
  for (int e = 0; e < E; ++e) {
    int before = 0, total = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < kk) {
        const unsigned b = __ballot_sync(FULL, live && id[j] == e);
        before += __popc(b & lower);
        total += __popc(b);
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (id[j] == e) r[j] = before;  // the token's one slot with e, if any
    if (lane == 0) base[warp][e] = total;
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
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < kk) sum += v[j];
    const float d = fmaxf(sum, 1e-9f);
    const long o = t * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < kk) {
        const int p = base[warp][id[j]] + r[j];
        w[o + j] = v[j] / d;
        idx[o + j] = id[j];
        pos[o + j] = p;
        keep[o + j] = p < capacity;
      }
    }
  }
}

long scratch_bytes(int T, int E) {
  const long tiles = (T + NT - 1) / NT;
  return tiles > 1 ? 8 + 8 * tiles * E : 0;  // the tile counter, then a word per (tile, expert)
}

}  // namespace

// logits (T, E) float32; w (T, k) float32, idx and pos (T, k) int32, keep
// (T, k) bool; all contiguous; 1 <= k <= 16, k <= E <= 128; scratch 8-byte
// aligned, of at least 8 + 8 E ceil(T / 256) bytes where T > 256 (a tile
// counter and a word per tile and expert; none for one tile). Zeroes the
// scratch (where there is one) and launches ceil(T / 256) blocks on
// `stream`; returns cudaGetLastError() after the launch (0 on success).
extern "C" int moe_route_fwd(const void* logits, void* w, void* idx, void* pos, void* keep,
                             int T, int E, int k, int capacity, void* scratch,
                             long long scratch_bytes_given, void* stream) {
  const long need = scratch_bytes(T, E);
  if (k < 1 || k > MAX_K || E < k || E > MAX_E || T < 1 || scratch_bytes_given < need ||
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
  const dim3 grid((T + NT - 1) / NT);
  const auto* l = static_cast<const float*>(logits);
  auto* wf = static_cast<float*>(w);
  auto* ip = static_cast<int*>(idx);
  auto* pp = static_cast<int*>(pos);
  auto* kp = static_cast<bool*>(keep);
  if (k == 1)
    moe_route_kernel<1><<<grid, NT, 0, s>>>(l, wf, ip, pp, kp, T, E, k, capacity, counter, words);
  else if (k == 2)
    moe_route_kernel<2><<<grid, NT, 0, s>>>(l, wf, ip, pp, kp, T, E, k, capacity, counter, words);
  else
    moe_route_kernel<MAX_K><<<grid, NT, 0, s>>>(l, wf, ip, pp, kp, T, E, k, capacity, counter,
                                                 words);
  return cudaGetLastError();
}

extern "C" const char* moe_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
