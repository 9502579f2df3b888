// Mamba-2 SSD chunk scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py::
// ssd_scan_fwd (pallas_call at :73). It computes what that kernel computes,
// in f32: for each (batch b, head h) and chunk of q steps, with
// a = -exp(A_log[h]) * dt, ca = cumsum(a) over the chunk and
// xdt = x * dt,
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(ca_i - ca_j) xdt[j]
//         + exp(ca_i) C_i . h                       (the carried state)
//   h    <- exp(ca_last) h + sum_j exp(ca_last - ca_j) xdt[j] (x) B_j
// where head h reads the B / C group h / (H / G). It returns y in x's
// dtype and the final (P, N) state in f32.
//
// What bounds it on this card: bytes, at the least. At the Mamba2-780M
// prefill (B = 1, S = 2048, H = 48, P = 64, N = 128, G = 1, q = 256) x and
// y are 12.6 MB each in bf16 and the state 1.6 MB (28.2 MB in all, 8.4 us
// at 3.35 TB/s), against about 4.9e9 FLOP over the causal pairs, which
// tensor cores would finish in 5.0 us.
// This design does its products as f32 FMAs from shared memory on the CUDA
// cores, so it is bound by FMA throughput and shared-memory reads well above
// the byte bound; moving the products onto wgmma is the way to the bound.
//
// Design. The TPU kernel's grid (B, H, n_chunks) carried the state in VMEM
// across the sequential chunk axis; CUDA blocks run in no order, so here a
// block loops over the chunks itself and keeps its state rows in shared
// memory. Rows of the state are independent (y[:, p] needs only x[:, p]
// and state row p), so the grid also splits P in blocks of PB rows:
// (P / PB, H, B) gives 192 blocks at the prefill's shape, where (H, B)
// alone gives 48 for 132 SMs. Splitting P would repeat the group's C.B^T
// product in every block, so a first kernel (ssd_cb) computes it once per
// (batch, chunk, group) into a scratch buffer the wrapper allocates; the
// scan reads it back from L2. One chunk's q x q score tile at q = 256 is
// 256 KB in f32, above the 227 KB a block may have, so the scan takes it in
// tiles of TI rows. The decay exp(ca_i - ca_j) is formed only for j <= i
// (for j > i it overflows), so no inf ever meets a zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads of either kernel
constexpr int PB = 16;       // state rows (of P) per scan block
constexpr int TI = 2 * NT / PB;  // chunk rows per score tile: 2 outputs a thread
constexpr int TB = 32;       // chunk rows of B per step of the state update
constexpr int TC = 64;       // C.B^T tile (16 x 16 threads, 4 x 4 each)
constexpr int KC = 32;       // state width (of N) per step of the C.B^T tile
constexpr int MAX_Q = 256;   // the largest chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// cb[(b, c, g)][i][j] = C[b, c q + i, g, :] . B[b, c q + j, g, :] for the
// tiles on or below the diagonal (the scan never reads the others).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb, int S,
       int G, int N, int q, int nc) {
  __shared__ float Cs[TC][KC + 1];
  __shared__ float Bs[TC][KC + 1];
  const int i0 = blockIdx.y * TC, j0 = blockIdx.z * TC;
  if (j0 > i0 + TC - 1) return;  // wholly above the diagonal
  const int z = blockIdx.x;      // (b nc + c) G + g
  const int g = z % G, c = (z / G) % nc, b = z / (G * nc);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row0 = (size_t)b * S + (size_t)c * q;  // first step of the chunk

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += KC) {
    for (int e = tid; e < TC * KC; e += NT) {
      const int r = e / KC, d = e % KC, n = n0 + d;
      const bool in_n = n < N;
      Cs[r][d] = (i0 + r < q && in_n) ? to_f32(Cm[((row0 + i0 + r) * G + g) * N + n]) : 0.f;
      Bs[r][d] = (j0 + r < q && in_n) ? to_f32(Bm[((row0 + j0 + r) * G + g) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < KC; ++d) {
      float ca[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ca[i] = Cs[ty + 16 * i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[tx + 16 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ca[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + (size_t)z * q * q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col < q) out[(size_t)r * q + col] = acc[i][j];
    }
  }
}

size_t scan_smem_bytes(int q, int N) {
  return sizeof(float) * (4 * (size_t)q + (size_t)q * PB + (size_t)PB * (N + 1) +
                          (size_t)TI * (q + 1) + (size_t)(TI > TB ? TI : TB) * (N + 1) + NT / 32);
}

// One block: batch b = blockIdx.z, head h = blockIdx.y, state rows
// p0 .. p0 + PB - 1 with p0 = blockIdx.x * PB; loops over the chunks.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ cb, T* __restrict__ y,
               float* __restrict__ state, int S, int H, int P, int G, int N, int q) {
  extern __shared__ float smem[];
  float* ca = smem;              // q: cumulative decay ca_i
  float* el = ca + q;            // q: exp(ca_last - ca_j)
  float* eca = el + q;           // q: exp(ca_i)
  float* dts = eca + q;          // q: dt_j
  float* xdt = dts + q;          // q x PB: x * dt
  float* hs = xdt + q * PB;      // PB x (N + 1): the carried state rows
  float* Ss = hs + PB * (N + 1); // TI x (q + 1): one row tile of the scores
  float* Ts = Ss + TI * (q + 1); // max(TI, TB) x (N + 1): rows of C or of B
  float* wsum = Ts + (TI > TB ? TI : TB) * (N + 1);  // NT / 32 warp totals

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = S / q;
  const float A = -expf(A_log[h]);
  const int QS = q + 1, NS = N + 1;

  for (int o = tid; o < PB * N; o += NT) hs[(o / N) * NS + o % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t row0 = (size_t)b * S + (size_t)c * q;  // first step of the chunk
    // 1. decays: an inclusive scan of a = A dt over the chunk (q <= NT)
    float dv = 0.f, v = 0.f;
    if (tid < q) {
      dv = dt[(row0 + tid) * H + h];
      v = A * dv;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < NT / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NT / 32; off <<= 1) {
        const float up = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += up;
      }
      if (lane < NT / 32) wsum[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v += wsum[warp - 1];
    if (tid < q) {
      ca[tid] = v;
      dts[tid] = dv;
    }
    __syncthreads();
    const float ca_last = ca[q - 1];
    if (tid < q) {
      el[tid] = expf(ca_last - ca[tid]);
      eca[tid] = expf(ca[tid]);
    }
    for (int e = tid; e < q * PB; e += NT) {
      const int j = e / PB, pp = e % PB, p = p0 + pp;
      xdt[e] = p < P ? to_f32(x[((row0 + j) * H + h) * P + p]) * dts[j] : 0.f;
    }
    __syncthreads();

    // 2. y, a tile of TI rows at a time (reads the state of the chunk before)
    const float* cbz = cb + ((size_t)(b * nc + c) * G + g) * q * q;
    for (int i0 = 0; i0 < q; i0 += TI) {
      const int jn = min(i0 + TI, q);  // columns that can be live for these rows
      for (int e = tid; e < TI * jn; e += NT) {
        const int r = e / jn, j = e % jn, i = i0 + r;
        float s = 0.f;
        if (i < q && j <= i) s = cbz[(size_t)i * q + j] * expf(ca[i] - ca[j]);
        Ss[r * QS + j] = s;
      }
      for (int e = tid; e < TI * N; e += NT) {
        const int r = e / N, n = e % N, i = i0 + r;
        Ts[r * NS + n] = i < q ? to_f32(Cm[((row0 + i) * G + g) * N + n]) : 0.f;
      }
      __syncthreads();
      const int pp = tid % PB, p = p0 + pp;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = tid / PB + k * (NT / PB), i = i0 + r;
        if (i >= q) continue;
        float intra = 0.f, inter = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(Ss[r * QS + j], xdt[j * PB + pp], intra);
        for (int n = 0; n < N; ++n) inter = fmaf(Ts[r * NS + n], hs[pp * NS + n], inter);
        if (p < P) store(&y[((row0 + i) * H + h) * P + p], intra + eca[i] * inter);
      }
      __syncthreads();
    }

    // 3. the state: decay what is carried, add this chunk's inputs
    const float e_last = expf(ca_last);
    for (int o = tid; o < PB * N; o += NT) hs[(o / N) * NS + o % N] *= e_last;
    for (int j0 = 0; j0 < q; j0 += TB) {
      const int jn = min(TB, q - j0);
      for (int e = tid; e < jn * N; e += NT) {
        const int r = e / N, n = e % N;
        Ts[r * NS + n] = to_f32(Bm[((row0 + j0 + r) * G + g) * N + n]);
      }
      __syncthreads();
      for (int o = tid; o < PB * N; o += NT) {
        const int pp = o / N, n = o % N;
        float acc = 0.f;
        for (int r = 0; r < jn; ++r)
          acc = fmaf(xdt[(j0 + r) * PB + pp] * el[j0 + r], Ts[r * NS + n], acc);
        hs[pp * NS + n] += acc;
      }
      __syncthreads();
    }
  }

  for (int o = tid; o < PB * N; o += NT) {
    const int pp = o / N, n = o % N, p = p0 + pp;
    if (p < P) state[(((size_t)b * H + h) * P + p) * N + n] = hs[pp * NS + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, void* y, void* state, void* cb, int B, int S, int H, int P,
                   int G, int N, int q, cudaStream_t stream) {
  const int nc = S / q;
  if (nc > 0) {
    const dim3 grid(B * nc * G, (q + TC - 1) / TC, (q + TC - 1) / TC);
    ssd_cb<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                                       static_cast<float*>(cb), S, G, N, q, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = scan_smem_bytes(q, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_chunk_scan<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(cb), static_cast<T*>(y), static_cast<float*>(state), S, H, P, G,
      N, q);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), Bm / Cm (B, S, G, N) of one dtype (0 = float32,
// 1 = bfloat16); dt (B, S, H) and A_log (H,) float32; y (B, S, H, P) in x's
// dtype; state (B, H, P, N) float32; cb a float32 scratch of
// B * (S / q) * G * q * q. All contiguous; 0 < q <= 256, S % q == 0,
// H % G == 0. Launches on `stream` and returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                            const void* Cm, void* y, void* state, void* cb, int dtype, int B,
                            int S, int H, int P, int G, int N, int q, void* stream) {
  if (q <= 0 || q > MAX_Q || S % q != 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A_log, Bm, Cm, y, state, cb, B, S, H, P, G, N, q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, y, state, cb, B, S, H, P, G, N, q, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
