// Decode attention for Hopper (sm_90a), CUDA C++: one query token a slot
// against that slot's rows of the bf16 KV slab, read where they lie.
//
// Replaces no TPU kernel. The JAX package's decode runs the plain masked
// attention over the whole cache (src/repro/models/attention.py::
// decode_attention); so did the port, as the plain version beside this
// kernel (kernels/decode_attention/ref.py) still does on the CPU. It was
// added because that plain version, at 128 slots of 2048 positions, casts
// the whole bf16 slab to f32 in every layer of every step.
//
// What it computes, per slot b and query head h = kv_head * G + g: the
// softmax over the live rows of q . k * scale (tanh soft-capped where
// softcap > 0) against v, the same function as the plain version. The live
// rows are lo .. hi with hi = min(pos[b], Smax - 1) (the clamp of the cache
// write) and lo = max(0, pos[b] - window + 1); pos is read on the device,
// so no length crosses to the host. Scores, the online softmax (m, l) and
// the P . V sums are f32 from the exact bf16 values; only the output is
// rounded, to bf16 (v's dtype). A slot with no live row (only past the
// slab's end with a window shorter than the overrun) gets zeros, where the
// plain version averages every row.
//
// What bounds it on this card: bytes. Each live K and V row is read once
// (hd x 2 B each) for 4 x hd x G FLOP, some G FLOP per byte against the
// H100's ~295 bf16 FLOP per byte; at the serve cell (128 slots, 16 kv heads,
// hd 128, ~1,170 live rows a slot) a layer's call reads ~1.2 GB, 0.37 ms at
// 3.35 TB/s.
//
// Design:
//   - one block of 4 warps per (slot, kv head, split); it holds all G query
//     heads of its kv head, so under GQA each row crosses the bus once;
//   - a row is read by HD / 8 neighbouring threads, 16 bytes each (a row of
//     hd 128 is 256 contiguous bytes); a warp reads 32 / (HD / 8) rows at a
//     time, and each thread issues the loads of U rows of K and of V before
//     it uses any (unrolled register loads: at G <= 2, 16 KB in flight a
//     block and several blocks an SM);
//   - each group of HD / 8 threads runs its own online softmax over the rows
//     it reads (the score of a row is a shuffle sum over the group), so the
//     loop has no barrier; at the end the groups of a warp merge (m, l, acc)
//     by shuffles and the warps through shared memory;
//   - the split count comes from the wrapper: with fewer (slot, kv head)
//     pairs than SMs the live rows of each slot are cut into `splits` equal
//     ranges, each block writes its (m, l, acc) in f32 and a second kernel
//     merges them; with enough pairs (the serve cell's 2048) splits is 1 and
//     the block writes the output itself.
// G (1 to 8), HD (64, 128, 256) and q's dtype (bf16, or f32 for an f32
// model over the bf16 slab) are template parameters; window and softcap
// are arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NW = 4;  // warps a block
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  f[0] = lo_bf16(r.x); f[1] = hi_bf16(r.x);
  f[2] = lo_bf16(r.y); f[3] = hi_bf16(r.y);
  f[4] = lo_bf16(r.z); f[5] = hi_bf16(r.z);
  f[6] = lo_bf16(r.w); f[7] = hi_bf16(r.w);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// exp(x - m) for the online softmax; 0 where m is -inf (nothing seen yet)
__device__ __forceinline__ float rescale(float x, float m) {
  return m == -INFINITY ? 0.f : exp2f((x - m) * LOG2E);
}

// rows a thread loads before it uses any: more where G leaves registers
template <int G>
struct Unroll {
  static constexpr int value = G <= 2 ? 4 : 2;
};

template <typename TQ, int HD, int G>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ o, float* __restrict__ part_ml, float* __restrict__ part_o,
    int Smax, int K, int window, float softcap, float scale, int splits) {
  constexpr int TPR = HD / 8;    // threads a row
  constexpr int RPW = 32 / TPR;  // rows a warp reads at once
  constexpr int U = Unroll<G>::value;
  constexpr int STEP = NW * RPW * U;  // rows a block reads an iteration

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / TPR, c = (lane % TPR) * 8;
  const int H = K * G;

  // the live rows of this slot, then this split's share of them
  const int p = pos[b];
  const int hi = min(p, Smax - 1);
  const int lo = max(0, p - window + 1);
  const int n = hi - lo + 1;
  const int per = n > 0 ? (n + splits - 1) / splits : 0;
  const int begin = lo + split * per;
  const int end = min(begin + per, hi + 1);

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qp = q + ((size_t)b * H + kh * G + g) * HD + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] = to_f32(qp[e]);
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)K * HD;  // elements between a slot's rows
  const __nv_bfloat16* kb = k + (size_t)b * Smax * row_stride + (size_t)kh * HD + c;
  const __nv_bfloat16* vb = v + (size_t)b * Smax * row_stride + (size_t)kh * HD + c;

  // the bound is the warp's, not the row group's: every lane of the warp
  // takes part in the shuffles of each iteration
  for (int w0 = begin + warp * RPW * U; w0 < end; w0 += STEP) {
    const int r0 = w0 + sub;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + u * RPW;
      if (row < end) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + row * row_stride));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + row * row_stride));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
        d *= scale;
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[u][g] = r0 + u * RPW < end ? d : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mn = fmaxf(mn, s[u][g]);
      if (mn == -INFINITY) continue;  // no live row yet (the group's last, ragged step)
      const float alpha = rescale(m[g], mn);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = exp2f((s[u][g] - mn) * LOG2E);  // 0 for a masked row
        float vf[8];
        unpack8(vr[u], vf);
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
      m[g] = mn;
    }
  }

  // merge the row groups of the warp (lanes TPR apart), then the warps
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo_ = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = rescale(m[g], mn), bo = rescale(mo, mn);
      l[g] = l[g] * a + lo_ * bo;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], off) * bo;
      m[g] = mn;
    }
  }
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_o[NW][G][HD];
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_o[warp][g][c + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int g = i / HD, col = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = rescale(sm_m[w][g], M);
      L += sm_l[w][g] * wt;
      O += sm_o[w][g][col] * wt;
    }
    const size_t bh = (size_t)b * H + kh * G + g;
    if (splits == 1) {
      o[bh * HD + col] = __float2bfloat16(L > 0.f ? O / L : 0.f);
    } else {
      const size_t at = bh * splits + split;
      part_o[at * HD + col] = O;
      if (col == 0) {
        part_ml[2 * at] = M;
        part_ml[2 * at + 1] = L;
      }
    }
  }
}

// o[bh] from the splits' (m, l, acc): one block a (slot, query head), one
// thread a column
__global__ void decode_attention_merge(const float* __restrict__ part_ml,
                                       const float* __restrict__ part_o,
                                       __nv_bfloat16* __restrict__ o, int splits, int HD) {
  const size_t bh = blockIdx.x;
  const int col = threadIdx.x;
  const float* ml = part_ml + 2 * bh * splits;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float wt = rescale(ml[2 * s], M);
    L += ml[2 * s + 1] * wt;
    O += part_o[(bh * splits + s) * HD + col] * wt;
  }
  o[bh * HD + col] = __float2bfloat16(L > 0.f ? O / L : 0.f);
}

template <typename TQ, int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* o,
                   void* part_ml, void* part_o, int B, int K, int Smax, int window,
                   float softcap, float scale, int splits, cudaStream_t s) {
  const dim3 grid(B, K, splits);
  decode_attention_kernel<TQ, HD, G><<<grid, NT, 0, s>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(part_ml),
      static_cast<float*>(part_o), Smax, K, window, softcap, scale, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_attention_merge<<<B * K * G, HD, 0, s>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_o),
      static_cast<__nv_bfloat16*>(o), splits, HD);
  return cudaGetLastError();
}

template <typename TQ, int HD>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const void* pos,
                     void* o, void* part_ml, void* part_o, int B, int K, int Smax, int window,
                     float softcap, float scale, int splits, cudaStream_t s) {
#define DECODE_G(n)                                                                        \
  case n:                                                                                  \
    return launch<TQ, HD, n>(q, k, v, pos, o, part_ml, part_o, B, K, Smax, window, softcap, \
                             scale, splits, s);
  switch (G) {
    DECODE_G(1) DECODE_G(2) DECODE_G(3) DECODE_G(4)
    DECODE_G(5) DECODE_G(6) DECODE_G(7) DECODE_G(8)
  }
#undef DECODE_G
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_hd(int hd, int G, const void* q, const void* k, const void* v,
                      const void* pos, void* o, void* part_ml, void* part_o, int B, int K,
                      int Smax, int window, float softcap, float scale, int splits,
                      cudaStream_t s) {
  if (hd == 64)
    return launch_g<TQ, 64>(G, q, k, v, pos, o, part_ml, part_o, B, K, Smax, window, softcap,
                            scale, splits, s);
  if (hd == 128)
    return launch_g<TQ, 128>(G, q, k, v, pos, o, part_ml, part_o, B, K, Smax, window, softcap,
                             scale, splits, s);
  if (hd == 256)
    return launch_g<TQ, 256>(G, q, k, v, pos, o, part_ml, part_o, B, K, Smax, window, softcap,
                             scale, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, hd) in bf16 (q_dtype 1) or f32 (0); k, v (B, Smax, K, hd) bf16;
// pos (B,) int32; o (B, H, hd) bf16. With splits > 1, part_ml (B, H,
// splits, 2) and part_o (B, H, splits, hd) f32 scratch. window >= 1 (the
// wrapper passes 2^30 for none); softcap 0 for none.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, void* part_ml, void* part_o,
                                    int q_dtype, int B, int K, int G, int Smax, int hd,
                                    int window, float softcap, float scale, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || K < 1 || K > 65535 || Smax < 1 || window < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && (part_ml == nullptr || part_o == nullptr)))
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_hd<float>(hd, G, q, k, v, pos, o, part_ml, part_o, B, K, Smax, window,
                            softcap, scale, splits, s);
  if (q_dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, G, q, k, v, pos, o, part_ml, part_o, B, K, Smax, window,
                                    softcap, scale, splits, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
