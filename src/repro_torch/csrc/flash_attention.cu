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
// 4.3e10 FLOP against 50 MB of q, k, v and o, some 850 FLOP per byte,
// far above the H100's ~295 bf16 tensor-core FLOP per byte of HBM. The
// design here does both products as f32 FMAs on the CUDA cores (~67 TFLOP/s
// at most, a fifteenth of the tensor-core rate), with operands read from
// shared memory, so it is bound by FMA issue and shared-memory bandwidth
// well above the tensor-core bound. Moving the products onto wgmma with
// TMA-fed tiles is the way to the bound.
//
// Design. The TPU kernel's sequential KV grid axis, which carried (m, l,
// acc) in VMEM scratch, becomes a loop inside one thread block: each block
// owns one (q tile, head, batch) and nothing carries between blocks. The
// TPU's dead-block skip becomes the bounds of that loop. The Q tile and one
// K and V tile at a time sit in (dynamic) shared memory as f32; each of the
// 256 threads computes a 4 x 4 micro-tile of S = Q K^T and keeps 4 rows of
// the output accumulator in registers. Rows >= Sq and columns >= Skv are
// masked here, so the caller pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads: 16 x 16, each 4 rows x 4 columns of S
constexpr float NEG_INF = -1e30f;

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

}  // namespace

// q (B, H, Sq, hd); k, v (B, H / G, Skv, hd); o (B, H, Sq, hd); all
// contiguous, of one dtype: 0 = float32, 1 = bfloat16. window <= 0 means no
// window; softcap <= 0 means no soft-cap. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int G, int Sq, int Skv, int hd,
                                   int q_offset, int kv_len, int causal, int window,
                                   float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal, window,
                            softcap, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Skv, q_offset, kv_len, causal,
                                    window, softcap, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
