// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py::flash_attention_fwd (pallas_call at :94). It computes
// what that kernel computes: causal / sliding-window / kv_len masks with the
// finite NEG_INF = -1e30, an optional tanh soft-cap, GQA (head h reads KV
// head h / G), a query offset, and the online softmax with m, l and the
// output accumulator in f32, finished as acc / max(l, 1e-20).
//
// What bounds it on this card: operations. At the serve path's largest
// prefill (S = 2048, H = 40, hd = 128, causal) the two products are about
// 4.3e10 FLOP against 50 MB of q, k, v and o, some 850 FLOP per byte, far
// above the H100's ~295 bf16 tensor-core FLOP per byte of HBM.
//
// Two routes. The wrapper chooses one by dtype and head dim before the
// launch, counts it and passes it in; the entry point only dispatches:
//
// wgmma (bf16, hd 64 and 128: every call of the serve paths). The first
// design ran both products as f32 FMAs on the CUDA cores with operands read
// from shared memory; that cannot go below 67 TFLOP/s, 0.51 ms at q (1, 40,
// 1819, 128), and ran at 1.67 ms, 49x the bound and 16x torch's SDPA. Here
// both products run on the tensor cores:
//   - a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each and one producer warp;
//   - the producer loads the Q tile once, then K and V tiles of 128 keys
//     into a ring of 2 stages with TMA (one mbarrier per stage for K, one
//     for V, one for the consumers' release). The tensor maps are rank 3
//     (hd, S, B * heads), 128-byte swizzled, boxes 64 columns wide (a row
//     of hd 128 is two boxes): rows past Sq or Skv load as zeros and never
//     reach into the next head;
//   - S = Q K^T is wgmma m64n128k16, A and B K-major from shared memory,
//     f32 accumulators; the online softmax runs on the accumulator fragment
//     in registers (a row's max and sum are shuffles over the 4 lanes that
//     hold it), masking only the tiles that cross the diagonal, the window
//     edge or kv_len;
//   - P is rounded to bf16 in registers (as the plain version rounds it) and
//     is wgmma's register A operand for O += P V, V the MN-major B operand
//     (the transpose bit) in its (keys, hd) layout; O is rescaled by alpha
//     between tiles and stored as O / max(l, 1e-20) in bf16, rows >= Sq
//     masked;
//   - each warpgroup runs S, softmax and P V of a tile in turn; the two
//     warpgroups of a block overlap each other's softmax with wgmma. Tried
//     on the card and not kept, each slower at the serve shape: 64-key
//     tiles, a third stage, and issuing S_t before P_{t-1} V_{t-1} within a
//     warpgroup (FA3's intra-warpgroup overlap).
//
// fma (f32 at every hd, and bf16 at hd 256). The first design, kept: f32
// inputs hold a 2e-5 / 1e-4 tolerance that bf16 or TF32 products cannot,
// and at hd 256 a 64 x 256 f32 O accumulator (128 registers a thread) does
// not fit beside S and P in one warpgroup's registers. The TPU kernel's
// sequential KV grid axis, which carried (m, l, acc) in VMEM scratch,
// becomes a loop inside one thread block: each block owns one (q tile,
// head, batch) and nothing carries between blocks; the TPU's dead-block
// skip becomes the bounds of that loop. The Q tile and one K and V tile at
// a time sit in dynamic shared memory as f32; each of the 256 threads
// computes a 4 x 4 micro-tile of S = Q K^T with f32 FMAs and keeps 4 rows
// of the output accumulator in registers. Rows >= Sq and columns >= Skv
// are masked here, so the caller pads nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fma: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace fma_route {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads: 16 x 16, each 4 rows x 4 columns of S

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// max / sum over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int G, int Sq, int Skv, int q_offset, int kv_len,
          int causal, int window, float softcap, float scale) {
  constexpr int DC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (HD + 1)
  float* Ks = Qs + BQ * (HD + 1);    // BK x (HD + 1)
  float* Vs = Ks + BK * (HD + 1);    // BK x HD
  float* Ps = Vs + BK * HD;          // BQ x (BK + 1): probabilities of one tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int K = H / G;
  const T* qp = q + ((size_t)b * H + h) * Sq * HD;
  const T* kp = k + ((size_t)b * K + h / G) * Skv * HD;
  const T* vp = v + ((size_t)b * K + h / G) * Skv * HD;
  T* op = o + ((size_t)b * H + h) * Sq * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[r * (HD + 1) + d] = q0 + r < Sq ? to_f32(qp[(size_t)(q0 + r) * HD + d]) : 0.f;
  }

  // the live KV tiles of this block's rows (the TPU kernel's block skip)
  const int row_first = q0 + q_offset;
  const int row_last = min(q0 + BQ, Sq) - 1 + q_offset;
  int t_end = (kv_len + BK - 1) / BK;
  if (causal) t_end = min(t_end, row_last / BK + 1);
  int t_begin = 0;
  if (window > 0 && row_first - window + 1 > 0) t_begin = (row_first - window + 1) / BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const bool in = c0 + c < Skv;
      const size_t g = (size_t)(c0 + c) * HD + d;
      Ks[c * (HD + 1) + d] = in ? to_f32(kp[g]) : 0.f;
      Vs[c * HD + d] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < kv_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vb = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DC; ++j) store(&op[(size_t)r * HD + tx + 16 * j], acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
                   int Sq, int Skv, int q_offset, int kv_len, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, G, Sq, Skv, q_offset, kv_len, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                      int H, int G, int Sq, int Skv, int q_offset, int kv_len, int causal,
                      int window, float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                           softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                            softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                            softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace fma_route

// ---------------------------------------------------------------------------
// wgmma: bf16 tensor cores fed by TMA
// ---------------------------------------------------------------------------

namespace wgmma_route {

constexpr int BQ = 128;         // query rows per block: two warpgroups of 64
constexpr int BK = 128;         // keys per K / V tile
constexpr int STAGES = 2;       // K / V tiles in flight (a third measured slower)
constexpr int BOX = 64;         // columns (128 bytes) of a TMA box, and the rows of a Q box
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int NTHREADS = 2 * 128 + 32;  // two consumer warpgroups, one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {
  static constexpr int CB = HD / BOX;                 // boxes across a row
  static constexpr int Q_BYTES = 2 * CB * BOX_BYTES;  // 128 rows
  static constexpr int KV_BYTES = CB * BK * 128;      // one tile of BK keys
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;       // q; k full, v full, kv empty per stage
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + the 1024-byte alignment
};

// first and one-past-last live KV tile of query rows [r_first, r_last]
// (positions, q_offset added), as the fma route bounds its loop
__device__ __forceinline__ void live_tiles(int r_first, int r_last, int kv_len, int causal,
                                           int window, int& t_begin, int& t_end) {
  t_end = (kv_len + BK - 1) / BK;
  if (causal) t_end = min(t_end, r_last / BK + 1);
  t_begin = 0;
  if (window > 0 && r_first - window + 1 > 0) t_begin = (r_first - window + 1) / BK;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                int G, int Sq, int q_offset, int kv_len, int causal, int window, float softcap,
                float scale) {
  using L = Layout<HD>;
  constexpr int CB = L::CB;
  constexpr int NO = HD / 2;  // O accumulator registers a thread: 64 x HD over 128 threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte tiles
  const uint32_t bar_q = sb + L::BAR_OFF;
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto k_at = [&](int s, int c) { return sb + L::K_OFF + s * L::KV_BYTES + c * BK * 128; };
  auto v_at = [&](int s, int c) { return sb + L::V_OFF + s * L::KV_BYTES + c * BK * 128; };

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int qh = b * H + h, kvh = b * (H / G) + h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int t_begin, t_end;
  live_tiles(q0 + q_offset, min(q0 + BQ, Sq) - 1 + q_offset, kv_len, causal, window, t_begin,
             t_end);

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_k(s), 1);
      sm90::mbar_init(bar_v(s), 1);
      sm90::mbar_init(bar_e(s), 8);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < CB; ++c)
          sm90::tma_load_3d(sb + (w * CB + c) * BOX_BYTES, &tq, bar_q, c * BOX, q0 + w * BOX, qh);
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(bar_k(s), L::KV_BYTES);
        for (int c = 0; c < CB; ++c)
          sm90::tma_load_3d(k_at(s, c), &tk, bar_k(s), c * BOX, t * BK, kvh);
        sm90::mbar_arrive_expect_tx(bar_v(s), L::KV_BYTES);
        for (int c = 0; c < CB; ++c)
          sm90::tma_load_3d(v_at(s, c), &tv, bar_v(s), c * BOX, t * BK, kvh);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows from r0
  const int wgi = warp / 4;
  const int r0 = q0 + wgi * 64;
  const bool rows_live = r0 < Sq;
  const int w_first = r0 + q_offset, w_last = min(r0 + 64, Sq) - 1 + q_offset;
  int w_begin, w_end;
  live_tiles(w_first, w_last, kv_len, causal, window, w_begin, w_end);
  // this thread's two rows (of the accumulator fragment) and its column pair
  const int rr = (warp % 4) * 16 + lane / 4;
  const int pos_a = r0 + rr + q_offset, pos_b = pos_a + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_at = sb + wgi * CB * BOX_BYTES;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's share

  sm90::mbar_wait(bar_q, 0);
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    sm90::mbar_wait(bar_k(s), ph);
    if (!rows_live || t < w_begin || t >= w_end) {  // none of this warpgroup's rows see it
      sm90::mbar_wait(bar_v(s), ph);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar_e(s));
      continue;
    }
    float sc[BK / 2];  // S: 64 x BK over the warpgroup
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      sm90::wgmma_ss_m64n128k16(sc, sm90::desc_sw128(q_at + c * BOX_BYTES + off, 16, 1024),
                               sm90::desc_sw128(k_at(s, c) + off, 16, 1024), kk == 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    const int c0 = t * BK;
    const bool masked = c0 + BK > kv_len || (causal && c0 + BK - 1 > w_first) ||
                        (window > 0 && w_last - c0 >= window);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if (masked) {
        const int col = c0 + (i / 4) * 8 + cq + (i & 1);
        const int row = (i & 2) ? pos_b : pos_a;
        bool ok = col < kv_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        x = ok ? x : NEG_INF;
      }
      sc[i] = x;
      if (i & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * LOG2E), al_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {  // x - m is 0, not a residue, where both are NEG_INF
      const float p = exp2f((sc[i] - ((i & 2) ? mn_b : mn_a)) * LOG2E);
      sc[i] = p;
      if (i & 2) ps_b += p; else ps_a += p;
    }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? al_b : al_a;
    // P as wgmma's A fragments: k-step kk holds keys 16 kk .. 16 kk + 15
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    sm90::mbar_wait(bar_v(s), ph);
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sm90::desc_sw128(v_at(s, 0) + kk * 16 * 128, BK * 128, 1024);
      if constexpr (HD == 128) sm90::wgmma_rs_m64n128k16_tb(acc, pa[kk], dv);
      else sm90::wgmma_rs_m64n64k16_tb(acc, pa[kk], dv);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar_e(s));
  }
  if (!rows_live) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-20f), inv_b = 1.f / fmaxf(l_b, 1e-20f);
  const int row_a = r0 + rr, row_b = row_a + 8;
  __nv_bfloat16* oa = o + ((size_t)qh * Sq + row_a) * HD + cq;
  __nv_bfloat16* ob = oa + 8 * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
                   int Sq, int Skv, int q_offset, int kv_len, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int K = H / G;
  cudaError_t err = sm90::encode_bf16_3d(&tq, q, HD, Sq, (uint64_t)B * H, BOX, BOX);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tk, k, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tv, v, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err != cudaSuccess) return err;
  constexpr int smem = Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma<HD><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, G, Sq, q_offset, kv_len, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace wgmma_route

}  // namespace

// q (B, H, Sq, hd); k, v (B, H / G, Skv, hd); o (B, H, Sq, hd); all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16. route: 0 = fma (f32
// or bf16, hd 64, 128 or 256), 1 = wgmma (bf16 at hd 64 or 128, q, k, v
// 16-byte aligned); any other combination returns cudaErrorInvalidValue.
// window <= 0 means no window; softcap <= 0 means no soft-cap. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int route, int B, int H, int G, int Sq, int Skv,
                                   int hd, int q_offset, int kv_len, int causal, int window,
                                   float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || (hd != 64 && hd != 128)) return cudaErrorInvalidValue;
    if (hd == 64)
      return wgmma_route::launch<64>(q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                            softcap, scale, s);
    return wgmma_route::launch<128>(q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                           softcap, scale, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return fma_route::launch_hd<float>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal,
                                 window, softcap, scale, s);
  if (dtype == 1)
    return fma_route::launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len,
                                         causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
