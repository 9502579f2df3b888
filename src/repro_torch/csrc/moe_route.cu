// Fused MoE routing for Hopper (sm_90a), CUDA C++.
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
// at 3.35 TB/s; the work is a few operations per logit.
//
// Design. The TPU kernel's sequential grid over token tiles carried the
// per-expert counts in VMEM scratch; CUDA blocks run in no order, so one
// block loops over tiles of NT tokens itself and carries the E counts in
// shared memory. At the path's sizes (T <= 2048 at prefill, T = 4 at
// decode) one block is enough. In a tile each thread routes one token;
// a token's ordinal is the carried count of its expert, plus the
// assignments of earlier warps of the tile to that expert (a scan over the
// warps' per-expert counts), plus those of earlier lanes of its own warp
// (ballots over the expert ids of both slots).

#include <cuda_runtime.h>
#include <math.h>

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
                 int E, int k, int capacity) {
  __shared__ int counts[MAX_E];      // assignments per expert in earlier tiles
  __shared__ int base[NW][MAX_E];    // per warp: its count, then its exclusive base
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;  // lanes before this one
  for (int e = tid; e < E; e += NT) counts[e] = 0;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += NT) {
    const int t = t0 + tid;
    const bool live = t < T;
    int i0 = -1, i1 = -1;
    float v0 = -INFINITY, v1 = -INFINITY;
    if (live) {
      const float* row = logits + (size_t)t * E;
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
    for (int e = tid; e < E; e += NT) {
      int c = counts[e];
      for (int wi = 0; wi < NW; ++wi) {
        const int n = base[wi][e];
        base[wi][e] = c;
        c += n;
      }
      counts[e] = c;
    }
    __syncthreads();
    if (live) {
      const size_t o = (size_t)t * k;
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
    __syncthreads();  // base is rewritten by the next tile
  }
}

}  // namespace

// logits (T, E) float32; w (T, k) float32, idx and pos (T, k) int32, keep
// (T, k) bool; all contiguous; 1 <= k <= 2, k <= E <= 64. Launches one
// block on `stream` and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int moe_route_fwd(const void* logits, void* w, void* idx, void* pos, void* keep,
                             int T, int E, int k, int capacity, void* stream) {
  if (k < 1 || k > 2 || E < k || E > MAX_E || T < 0) return cudaErrorInvalidValue;
  moe_route_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(w), static_cast<int*>(idx),
      static_cast<int*>(pos), static_cast<bool*>(keep), T, E, k, capacity);
  return cudaGetLastError();
}

extern "C" const char* moe_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
