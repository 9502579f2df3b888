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
//
// The backward of the wgmma route (namespace attn_bwd, entry point
// flash_attention_bwd) replaces no TPU kernel: the JAX package takes the vjp
// of its plain version, and so did this port, at some 11 ms a layer for
// OLMo-1B at 4 x 2048 with f32 scores of (B, H, S, S) written and read ten
// times over. What bounds the backward on this card: operations. At the
// training cell's shape (B 8, H 16, S 2048, hd 128, causal) its five
// products are 3.4e11 FLOP against 0.54 GB of q, k, v, o, dO, dq, dk and dv,
// some 640 FLOP per byte. Its design, as FlashAttention-2/3's backward:
//   - the forward's instance with LSE writes each row's log-sum-exp; a
//     first kernel (attn_bwd_dot_do_o) takes D = rowsum(dO * O) in f32 and
//     zeroes the f32 dQ accumulator;
//   - the main kernel (attn_bwd_main) owns 128 keys of one (batch, kv head):
//     K and V are loaded once by TMA, and a producer warpgroup (which gives
//     its registers to the consumers by setmaxnreg) streams the (Q, dO,
//     LSE, D) tiles of the G query heads and of the query blocks that see
//     those keys (causal and window limits skip whole blocks) through a ring
//     of two stages. Each of two consumer warpgroups takes 64 keys: S^T =
//     K Q^T and dP^T = V dO^T by wgmma, P = exp(S - LSE) and dS = P (dP - D)
//     in registers (S, P, dP and dS never leave the SM), dV += P^T dO and
//     dK += dS^T Q with P and dS rounded to bf16 as register A operands and
//     f32 accumulators held across the loop; dS^T goes to shared memory, dQ
//     = dS K is split over the two warpgroups and added into the f32
//     accumulator with one bulk reduce-add each (cp.reduce.async.bulk);
//   - a last kernel (attn_bwd_dq_convert) writes dq in bf16. dk and dv are
//     written once, by their block, in bf16.
// At the training cell's shape the three take 0.95 ms (37 % of the bound;
// cuDNN's SDPA backward, the same three passes, 0.87 ms). Tried on the card
// and not kept: 9 warps (168 registers a thread: spills, serialised
// wgmmas), branches on the soft-cap and the mask inside the unrolled P / dS
// loop (3x slower there), issuing the next tile's S and dP before the dQ
// reduce (spills), dQ by red.global.add.v4.f32 from registers (3 % slower),
// a third stage and a second dQ staging buffer (no faster).
// No kernel of the backward is named flash*: the profile's flash* time is
// the forward's alone.

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

// LSE: also write each row's log-sum-exp of its scaled, capped and masked
// scores, m + log(l), to lse[(b * H + h) * lse_stride + row] (f32), for the
// backward; the instance without it is the serve path's. (lse and
// lse_stride come last: ahead of the others they moved the serve
// instance's code and cost it 3 % at the serve shapes.)
template <int HD, bool LSE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                int G, int Sq, int q_offset, int kv_len, int causal, int window, float softcap,
                float scale, float* __restrict__ lse, int lse_stride) {
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
  if constexpr (LSE) {
    if (lane % 4 == 0) {
      float* lp = lse + (size_t)qh * lse_stride;
      if (row_a < Sq) lp[row_a] = m_a + logf(fmaxf(l_a, 1e-20f));
      if (row_b < Sq) lp[row_b] = m_b + logf(fmaxf(l_b, 1e-20f));
    }
  }
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

template <int HD, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int lse_stride, int B, int H, int G, int Sq, int Skv, int q_offset,
                   int kv_len, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int K = H / G;
  cudaError_t err = sm90::encode_bf16_3d(&tq, q, HD, Sq, (uint64_t)B * H, BOX, BOX);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tk, k, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tv, v, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err != cudaSuccess) return err;
  constexpr int smem = Layout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<HD, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma<HD, LSE><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, G, Sq, q_offset, kv_len, causal, window,
      softcap, scale, lse, lse_stride);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_lse(const void* q, const void* k, const void* v, void* o, void* lse,
                       int lse_stride, int B, int H, int G, int Sq, int Skv, int q_offset,
                       int kv_len, int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
  if (lse == nullptr)
    return launch<HD, false>(q, k, v, o, nullptr, 0, B, H, G, Sq, Skv, q_offset, kv_len, causal,
                             window, softcap, scale, stream);
  return launch<HD, true>(q, k, v, o, static_cast<float*>(lse), lse_stride, B, H, G, Sq, Skv,
                          q_offset, kv_len, causal, window, softcap, scale, stream);
}

}  // namespace wgmma_route

// ---------------------------------------------------------------------------
// the backward (bf16 at hd 64 and 128: the wgmma route's domain)
// ---------------------------------------------------------------------------

namespace attn_bwd {

using wgmma_route::BOX;
using wgmma_route::LOG2E;
constexpr int BK = 128;                 // keys a block: two consumer warpgroups of 64
constexpr int STAGES = 2;               // (Q, dO, LSE, D) tiles in flight (a third, or a
                                        // second dQ part buffer, measured no faster)
constexpr int NTHREADS = 3 * 128;       // two consumer warpgroups, one producer warpgroup
// registers a thread after setmaxnreg: the producer gives back what the
// consumers' dK and dV accumulators (128 a thread) and S, dP (64) take; 9
// warps would leave 168 a thread (3 warps on one SM sub-partition's 16384)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// the padded rows of LSE, D and the dQ accumulator: a multiple of every BM
constexpr int PAD = 128;
// kv heads a group of blocks takes, key block by key block: the 132 blocks
// in flight lie in one or two groups, whose Q, dO and dQ (3 MB a head at S
// 2048, hd 128) stay in L2, and each group's longest causal blocks start
// first. Key block fastest over single heads ran 2 % slower (the last
// head's longest block started last), key block slowest 1.5x slower (every
// head's Q, dO and dQ in flight at once)
constexpr int HEAD_GROUP = 16;

template <int HD>
struct Cfg {
  static constexpr int CB = HD / BOX;                // 64-column boxes across a row
  static constexpr int BM = HD == 128 ? 64 : 128;    // query rows an iteration
  static constexpr int KV_BYTES = CB * BK * 128;     // a K or V tile of BK keys
  static constexpr int QT_BYTES = CB * BM * 128;     // a Q or dO tile of BM rows
  static constexpr int DS_BYTES = BK * BM * 2;       // dS^T (keys x queries) in bf16
  static constexpr int DQ_BYTES = BM * HD * 4;       // the dQ tile in f32
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int DS_OFF = DO_OFF + STAGES * QT_BYTES;  // two buffers, by iteration
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int LSE_OFF = DQ_OFF + DQ_BYTES;
  static constexpr int D_OFF = LSE_OFF + STAGES * BM * 4;
  static constexpr int BAR_OFF = D_OFF + STAGES * BM * 4;
  static constexpr int N_BARS = 1 + 2 * STAGES;      // k and v; full, empty per stage
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + the 1024-byte alignment
};

// D = rowsum(dO * O) in f32 over the padded rows (0 past Sq), and the f32
// dQ accumulator zeroed (rows x HD floats, as many as the padded rows hold)
template <int HD>
__global__ void __launch_bounds__(256)
attn_bwd_dot_do_o(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ dd, float* __restrict__ dqacc, int Sq, int Sqp) {
  constexpr int TPR = HD / 8;  // threads a row, 8 elements each
  const size_t t = (size_t)blockIdx.x * 256 + threadIdx.x;
  const size_t row = t / TPR;
  const int part = t % TPR;
  const size_t bh = row / Sqp;
  const int r = row % Sqp;
  float acc = 0.f;
  if (r < Sq) {
    const size_t at = ((size_t)bh * Sq + r) * HD + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 x = __bfloat1622float2(a2[m]), y = __bfloat1622float2(c2[m]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) dd[row] = acc;
  float4* z = reinterpret_cast<float4*>(dqacc + row * HD + part * 8);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// what P and dS of one consumer thread's tile need beyond the registers
struct Tile {
  int row0;  // the query row of the thread's first column (q0 + its column pair)
  int key_a;  // its first key row (the second is key_a + 8)
  int Sq, Skv, q_offset, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(y - LSE) of the scaled (and, with CAP, capped) scores y in st, 0
// where masked (MASK: rows past Sq, keys past Skv, causal, window); dS =
// P (dP - D), through the soft-cap's tanh (1 - (y / cap)^2), times the
// scale: the gradient of the raw scores, in dp. Both rounded to bf16 pairs
// as the A operands of dV and dK (k-step kk holds queries 16 kk .. + 15).
template <int BM, bool CAP, bool MASK>
__device__ __forceinline__ void p_ds(float (&st)[BM / 2], float (&dp)[BM / 2],
                                     const float* ls, const float* ds, int cq, const Tile& t,
                                     uint32_t (&pa)[BM / 16][4], uint32_t (&da)[BM / 16][4]) {
  const float sl = t.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + cq);
    const float m0 = l2.x * LOG2E, m1 = l2.y * LOG2E;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p, y = 0.f;
      if constexpr (CAP) {
        y = tanhf(st[i] * t.scale / t.softcap) * t.softcap;
        p = ex2(fmaf(y, LOG2E, (e & 1) ? -m1 : -m0));
      } else {
        p = ex2(fmaf(st[i], sl, (e & 1) ? -m1 : -m0));
      }
      if constexpr (MASK) {
        const int row = t.row0 + 8 * j + (e & 1), key = t.key_a + ((e & 2) ? 8 : 0);
        const int pos = row + t.q_offset;
        bool ok = row < t.Sq && key < t.Skv;
        if (t.causal) ok = ok && key <= pos;
        if (t.window > 0) ok = ok && pos - key < t.window;
        p = ok ? p : 0.f;
      }
      float g = p * t.scale * (dp[i] - ((e & 1) ? d2.y : d2.x));
      if constexpr (CAP) g *= 1.f - (y / t.softcap) * (y / t.softcap);
      st[i] = p;
      dp[i] = g;
    }
#pragma unroll
    for (int r = 2 * (j % 2); r < 2 * (j % 2) + 2; ++r) {
      pa[j / 2][r] = sm90::pack_bf16(st[8 * (j / 2) + 2 * r], st[8 * (j / 2) + 2 * r + 1]);
      da[j / 2][r] = sm90::pack_bf16(dp[8 * (j / 2) + 2 * r], dp[8 * (j / 2) + 2 * r + 1]);
    }
  }
}

// One block per (batch, kv head, BK keys). The producer loads K and V once,
// then the (Q, dO, LSE, D) tiles of every (query head of this kv head,
// query block that sees these keys) into a ring. Warpgroup wg owns keys
// 64 wg .. 64 wg + 63 of the block and, per tile, computes S^T = K Q^T and
// dP^T = V dO^T (keys x queries, the accumulator fragment's rows are keys),
// P = exp(S - LSE) and dS = P (dP - D) in registers, dV += P^T dO and
// dK += dS^T Q with P and dS as register A operands; dS^T goes to shared
// memory (128-byte swizzled, queries contiguous) and each warpgroup
// computes a 64 x 64 part of dQ = dS K from it, adds that part into the
// f32 accumulator with one bulk reduce-add, in the accumulator fragment's
// order (attn_bwd_dq_convert puts it back in rows).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_main(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ dd,
              float* __restrict__ dqacc, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int H, int G, int Sq, int Skv, int Sqp,
              int q_offset, int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int BM = C::BM, CB = C::CB;
  constexpr int NS = BM / 2;   // S^T, dP^T registers a thread: 64 keys x BM queries
  constexpr int NA = HD / 2;   // dK, dV registers a thread: 64 keys x HD
  constexpr int KS = BM / 16;  // k-steps of the products over the queries
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  uint8_t* const sp = smem_raw + (sb - raw);  // sb as a generic pointer
  const uint32_t bar_kv = sb + C::BAR_OFF;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };
  auto k_at = [&](int c) { return sb + C::K_OFF + c * BK * 128; };
  auto v_at = [&](int c) { return sb + C::V_OFF + c * BK * 128; };
  auto q_at = [&](int s, int c) { return sb + C::Q_OFF + s * C::QT_BYTES + c * BM * 128; };
  auto do_at = [&](int s, int c) { return sb + C::DO_OFF + s * C::QT_BYTES + c * BM * 128; };

  // blocks in launch order take groups of HEAD_GROUP kv heads (kvh = b * K +
  // kv head), key block by key block within a group: the heads in flight
  // share L2, and each group's longest causal blocks start first
  const int nk = gridDim.x, lin = blockIdx.y * nk + blockIdx.x;
  const int g0 = lin / (HEAD_GROUP * nk) * HEAD_GROUP;
  const int gsz = min(HEAD_GROUP, (int)gridDim.y - g0), in_g = lin % (HEAD_GROUP * nk);
  const int k0 = in_g / gsz * BK, kvh = g0 + in_g % gsz;
  const int K = H / G, b = kvh / K, h0 = b * H + (kvh % K) * G;  // its first query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the query blocks whose rows see any of keys [k0, k0 + BK)
  int i_begin = 0, i_end = (Sq + BM - 1) / BM;
  if (causal) i_begin = max(0, k0 - q_offset) / BM;
  if (window > 0) {
    const int r_max = k0 + BK - 1 + window - 1 - q_offset;  // the last row that sees key k0 + BK - 1
    i_end = r_max < 0 ? 0 : min(i_end, r_max / BM + 1);
  }
  const int nqb = max(0, i_end - i_begin);
  const int n_it = G * nqb;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full(s), 1);
      sm90::mbar_init(bar_empty(s), 8);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread issues the loads
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0 && n_it > 0) {
      sm90::mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
      for (int c = 0; c < CB; ++c) {
        sm90::tma_load_3d(k_at(c), &tk, bar_kv, c * BOX, k0, kvh);
        sm90::tma_load_3d(v_at(c), &tv, bar_kv, c * BOX, k0, kvh);
      }
      for (int it = 0; it < n_it; ++it) {
        const int qh = h0 + it / nqb, q0 = (i_begin + it % nqb) * BM, s = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(bar_empty(s), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(bar_full(s), 2 * C::QT_BYTES + 2 * BM * 4);
        for (int c = 0; c < CB; ++c) {
          sm90::tma_load_3d(q_at(s, c), &tq, bar_full(s), c * BOX, q0, qh);
          sm90::tma_load_3d(do_at(s, c), &tdo, bar_full(s), c * BOX, q0, qh);
        }
        const size_t row = (size_t)qh * Sqp + q0;
        sm90::bulk_load(sb + C::LSE_OFF + s * BM * 4, lse + row, BM * 4, bar_full(s));
        sm90::bulk_load(sb + C::D_OFF + s * BM * 4, dd + row, BM * 4, bar_full(s));
      }
    }
    return;
  }

  // a consumer warpgroup: keys kw0 .. kw0 + 63
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int kw0 = k0 + wg * 64;
  const int rr = (warp % 4) * 16 + lane / 4;  // this thread's key rows rr and rr + 8
  const int key_a = kw0 + rr, key_b = key_a + 8;
  const int cq = 2 * (lane % 4);              // and its column pair in each 8
  const uint32_t kv_rows = wg * 64 * 128;     // the warpgroup's rows in a K or V box

  float dva[NA], dka[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dva[i] = dka[i] = 0.f;

  if (n_it > 0) sm90::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int qh = h0 + it / nqb, qb = i_begin + it % nqb, q0 = qb * BM, s = it % STAGES;
    sm90::mbar_wait(bar_full(s), (it / STAGES) & 1);

    float st[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dp[i] = 0.f;
    sm90::fence_regs(st);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // S^T = K Q^T
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t a = sm90::desc_sw128(k_at(c) + kv_rows + off, 16, 1024);
      const uint64_t b = sm90::desc_sw128(q_at(s, c) + off, 16, 1024);
      if constexpr (BM == 64) sm90::wgmma_ss_m64n64k16<0, 0>(st, a, b, kk == 0);
      else sm90::wgmma_ss_m64n128k16(st, a, b, kk == 0);
    }
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // dP^T = V dO^T
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t a = sm90::desc_sw128(v_at(c) + kv_rows + off, 16, 1024);
      const uint64_t b = sm90::desc_sw128(do_at(s, c) + off, 16, 1024);
      if constexpr (BM == 64) sm90::wgmma_ss_m64n64k16<0, 0>(dp, a, b, kk == 0);
      else sm90::wgmma_ss_m64n128k16(dp, a, b, kk == 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dp);

    // P and dS, by the instance of this tile's soft-cap and masking (branches
    // inside the unrolled loop cut it into blocks that hide no latency)
    const float* ls = reinterpret_cast<const float*>(sp + C::LSE_OFF + s * BM * 4);
    const float* ds = reinterpret_cast<const float*>(sp + C::D_OFF + s * BM * 4);
    const bool masked = kw0 + 64 > Skv || q0 + BM > Sq ||
                        (causal && kw0 + 63 > q0 + q_offset) ||
                        (window > 0 && q0 + BM - 1 + q_offset - kw0 >= window);
    const Tile t{q0 + cq, key_a, Sq, Skv, q_offset, causal, window, softcap, scale};
    uint32_t pa[KS][4], da[KS][4];
    if (softcap > 0.f) {
      if (masked) p_ds<BM, true, true>(st, dp, ls, ds, cq, t, pa, da);
      else p_ds<BM, true, false>(st, dp, ls, ds, cq, t, pa, da);
    } else {
      if (masked) p_ds<BM, false, true>(st, dp, ls, ds, cq, t, pa, da);
      else p_ds<BM, false, false>(st, dp, ls, ds, cq, t, pa, da);
    }
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      sm90::fence_regs(pa[kk]);
      sm90::fence_regs(da[kk]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // dV += P^T dO, dO the MN-major B
      const uint64_t db = sm90::desc_sw128(do_at(s, 0) + kk * 16 * 128, BM * 128, 1024);
      if constexpr (HD == 128) sm90::wgmma_rs_m64n128k16_tb(dva, pa[kk], db);
      else sm90::wgmma_rs_m64n64k16_tb(dva, pa[kk], db);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // dK += dS^T Q
      const uint64_t db = sm90::desc_sw128(q_at(s, 0) + kk * 16 * 128, BM * 128, 1024);
      if constexpr (HD == 128) sm90::wgmma_rs_m64n128k16_tb(dka, da[kk], db);
      else sm90::wgmma_rs_m64n64k16_tb(dka, da[kk], db);
    }
    sm90::wgmma_commit();

    // dS^T into shared memory: keys are rows, BM / 64 boxes of 64 query
    // columns (128 bytes), 128-byte swizzled as TMA would write them
    const uint32_t dsb = C::DS_OFF + (it & 1) * C::DS_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = wg * 64 + rr + 8 * (r & 1);
        const int col = 16 * kk + 8 * (r >> 1) + cq;
        const int cc = col % 64;
        const uint32_t off = (col / 64) * (BK * 128) + key * 128 +
                             (((cc / 8) ^ (key % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(sp + dsb + off) = da[kk][r];
      }
    sm90::fence_proxy_async();
    if (tid == 0) sm90::bulk_wait_read<0>();  // the last reduce has read this warpgroup's dQ part
    sm90::named_bar_sync(1, 256);             // both halves of dS^T are written

    // this warpgroup's 64 x 64 of dQ = dS K over the block's BK keys: at hd 128
    // its 64 columns of the head dim, at hd 64 its 64 of the 128 query rows
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a_at = sb + dsb + (HD == 128 ? 0 : wg * BK * 128) + kk * 16 * 128;
      const uint32_t b_at = k_at(HD == 128 ? wg : 0) + kk * 16 * 128;
      sm90::wgmma_ss_m64n64k16<1, 1>(dq, sm90::desc_sw128(a_at, BK * 128, 1024),
                                     sm90::desc_sw128(b_at, BK * 128, 1024), kk == 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // the register operands were read until here
      sm90::fence_regs(pa[kk]);
      sm90::fence_regs(da[kk]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar_empty(s));  // Q, dO, LSE and D are read

    float* stage = reinterpret_cast<float*>(sp + C::DQ_OFF) + wg * 4096;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      reinterpret_cast<float4*>(stage)[j * 128 + tid] =
          make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(2 + wg, 128);
    if (tid == 0) {
      float* dst = dqacc + ((size_t)qh * (Sqp / BM) + qb) * (BM * HD) + wg * 4096;
      sm90::bulk_reduce_add_f32(dst, sm90::smem_u32(stage), 4096 * 4);
      sm90::bulk_commit();
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();

  // dK and dV in bf16, rows past Skv masked (the scale is in dS)
  __nv_bfloat16* ka = dk + ((size_t)kvh * Skv + key_a) * HD + cq;
  __nv_bfloat16* va = dv + ((size_t)kvh * Skv + key_a) * HD + cq;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (key_a < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(ka + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j], dka[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(va + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
    }
    if (key_b < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(ka + 8 * HD + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2], dka[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(va + 8 * HD + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// dq in bf16 from the f32 accumulator: each float4 of it is one consumer
// thread's 4 registers of a 64 x 64 dQ part, at rows (row, row + 8) and
// columns (col, col + 1) of the fragment
template <int HD>
__global__ void __launch_bounds__(256)
attn_bwd_dq_convert(const float* __restrict__ dqacc, __nv_bfloat16* __restrict__ dq, int Sq,
                    int Sqp, size_t n4) {
  constexpr int BM = Cfg<HD>::BM;
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= n4) return;
  const size_t tile = e / (BM * HD / 4);  // (head, query block)
  const int f = e % (BM * HD / 4);
  const int nq = Sqp / BM;
  const size_t bh = tile / nq;
  const int q0 = (tile % nq) * BM;
  const int w = f / 1024, j = f % 1024 / 128, t = f % 128;
  const int row = (t / 32) * 16 + (t % 32) / 4, col = j * 8 + 2 * (t % 4);
  const int q = q0 + (HD == 128 ? row : 64 * w + row), c = HD == 128 ? 64 * w + col : col;
  const float4 x = reinterpret_cast<const float4*>(dqacc)[e];
  __nv_bfloat16* out = dq + ((size_t)bh * Sq + q) * HD + c;
  if (q < Sq) *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x.x, x.y);
  if (q + 8 < Sq)
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * HD) = __floats2bfloat162_rn(x.z, x.w);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* dd, void* dqacc, void* dq, void* dk, void* dv, int B,
                   int H, int G, int Sq, int Skv, int Sqp, int q_offset, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const size_t rows = (size_t)B * H * Sqp;  // a multiple of PAD: the grids below are whole
  attn_bwd_dot_do_o<HD><<<rows * (HD / 8) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(dd), static_cast<float*>(dqacc), Sq, Sqp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  const int K = H / G;
  err = sm90::encode_bf16_3d(&tq, q, HD, Sq, (uint64_t)B * H, BOX, C::BM);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tdo, dout, HD, Sq, (uint64_t)B * H, BOX, C::BM);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tk, k, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err == cudaSuccess) err = sm90::encode_bf16_3d(&tv, v, HD, Skv, (uint64_t)B * K, BOX, BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_main<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + BK - 1) / BK, B * K);  // blocks of HEAD_GROUP heads (attn_bwd_main)
  attn_bwd_main<HD><<<grid, NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<float*>(dqacc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, G, Sq, Skv, Sqp, q_offset, causal, window, softcap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = rows * HD / 4;
  attn_bwd_dq_convert<HD><<<(n4 + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dqacc), static_cast<__nv_bfloat16*>(dq), Sq, Sqp, n4);
  return cudaGetLastError();
}

}  // namespace attn_bwd

}  // namespace

// q (B, H, Sq, hd); k, v (B, H / G, Skv, hd); o (B, H, Sq, hd); all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16. route: 0 = fma (f32
// or bf16, hd 64, 128 or 256), 1 = wgmma (bf16 at hd 64 or 128, q, k, v
// 16-byte aligned); any other combination returns cudaErrorInvalidValue.
// lse: null, or (wgmma route only) f32 (B, H, lse_stride) that takes each
// row's log-sum-exp (rows < Sq). window <= 0 means no window; softcap <= 0
// means no soft-cap. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int lse_stride, int dtype, int route, int B, int H,
                                   int G, int Sq, int Skv, int hd, int q_offset, int kv_len,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || (hd != 64 && hd != 128) || (lse != nullptr && lse_stride < Sq))
      return cudaErrorInvalidValue;
    if (hd == 64)
      return wgmma_route::launch_lse<64>(q, k, v, o, lse, lse_stride, B, H, G, Sq, Skv, q_offset,
                                         kv_len, causal, window, softcap, scale, s);
    return wgmma_route::launch_lse<128>(q, k, v, o, lse, lse_stride, B, H, G, Sq, Skv, q_offset,
                                        kv_len, causal, window, softcap, scale, s);
  }
  if (route != 0 || lse != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return fma_route::launch_hd<float>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal,
                                 window, softcap, scale, s);
  if (dtype == 1)
    return fma_route::launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len,
                                         causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

// The backward of the wgmma route's forward (bf16, hd 64 or 128): q, o, dout
// and dq (B, H, Sq, hd), k, v, dk and dv (B, H / G, Skv, hd), bf16,
// contiguous, 16-byte aligned; lse (the forward's) and dd (scratch) f32 (B,
// H, Sqp), dqacc f32 scratch of B * H * Sqp * hd, Sqp a multiple of 128 and
// >= Sq. Three launches on `stream`: D = rowsum(dout * o) (and dqacc
// zeroed), the main kernel, dq from dqacc. Any other combination returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dd, void* dqacc,
                                   void* dq, void* dk, void* dv, int B, int H, int G, int Sq,
                                   int Skv, int Sqp, int hd, int q_offset, int causal, int window,
                                   float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sqp < Sq || Sqp % attn_bwd::PAD || G < 1 || H % G) return cudaErrorInvalidValue;
  if (hd == 64)
    return attn_bwd::launch<64>(q, k, v, o, lse, dout, dd, dqacc, dq, dk, dv, B, H, G, Sq, Skv,
                                Sqp, q_offset, causal, window, softcap, scale, s);
  if (hd == 128)
    return attn_bwd::launch<128>(q, k, v, o, lse, dout, dd, dqacc, dq, dk, dv, B, H, G, Sq, Skv,
                                 Sqp, q_offset, causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
