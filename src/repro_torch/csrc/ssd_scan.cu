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
// What bounds it on this card: bytes. At the Mamba2-780M prefill (B = 1,
// S = 2048, H = 48, P = 64, N = 128, G = 1, q = 256) x and y are 12.6 MB
// each in bf16 and the state 1.6 MB (28.2 MB in all, 8.4 us at 3.35 TB/s),
// against about 4.9e9 FLOP over the causal pairs, 5.0 us on the tensor
// cores.
//
// What the first design lost. It carried the state across the chunks as
// the TPU kernel does, in a loop inside each of 192 blocks, and ran every
// product as f32 FMAs with both operands read from shared memory: the
// intra-chunk sum a serial j <= i loop of one thread per output, the state
// update the same. That took 1.62 ms, 193x the bound; its FMA floor alone
// is 4.9e9 / 67e12 = 0.073 ms.
//
// This design runs the chunked SSD as four launches, the products in
// parallel over (batch, chunk, head) on the tensor cores, and only an
// elementwise recurrence across the chunks:
//   1. ssd_cb: C.B^T per (batch, chunk, group), on and below the diagonal
//      64 x 64 tiles only, f32, into a scratch the scan reads from L2;
//   2. ssd_chunk_state: per (batch, chunk, head), the chunk's own state
//      s_c[p, n] = sum_j x[j, p] w_j B[j, n], w_j = dt_j exp(ca_last - ca_j),
//      a (P x q).(q x N) product; it also writes ca_last, and the chunk's
//      ca and dt contiguous, so the scan reads them without a strided load
//      or a scan of its own;
//   3. ssd_state_pass: per (batch, head) and element of P * N, for c in
//      order: hprev[c] = h, h = exp(ca_last_c) h + s_c (in place of s_c);
//      writes the final state;
//   4. ssd_chunk_scan: per (batch, chunk, head) and 64-row tile of the
//      chunk (the tiles with the most work first), y = (CB o decay o dt) . x
//      over the tiles on or below the diagonal, plus exp(ca_i) C . hprev^T.
//      The decay exp(ca_i - ca_j) is formed only for j <= i (for j > i it
//      overflows), so no inf meets a zero.
// Each product block (4 warps) computes a 64 x 64 output tile with mma.sync
// m16n8k16 bf16, f32 accumulation, over K chunks of 64: a chunk is loaded
// into registers with 16-byte loads while the chunk before it is on the
// tensor cores, then written to shared memory as bf16 in its source layout;
// fragments come by 4-byte loads where K is contiguous, by ldmatrix.trans
// where it is not (x and B, whose rows are steps of the chunk).
//
// Precision: every product keeps the f32-inside accuracy of the first
// design. Operands that are bf16 inputs (x, B, C in bf16) are exact as bf16.
// Every f32 operand (the decayed scores, w_j B, hprev, and x, B, C in f32)
// goes in as a pair hi = bf16(v), lo = bf16(v - hi), about 16 bits of
// mantissa, and a product takes hi.hi + hi.lo + lo.hi: two mma where one
// side is exact, three where neither is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TT = 64;       // rows, columns and K chunk of every product tile
constexpr int LD = TT + 8;   // shared row stride in bf16: 36 words, conflict-free fragments
constexpr int NT = 128;      // threads of a product block: 4 warps of 16 rows
constexpr int NT_PASS = 256; // threads of the state pass
constexpr int MAX_Q = 256;   // the largest chunk (two chunk steps a thread in the decay scan)

// (first, second) at dst[0], dst[1], of which the first n are in bounds
__device__ __forceinline__ void store2(float* dst, float first, float second, int n) {
  if (n >= 2 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(first, second);
  } else {
    if (n > 0) dst[0] = first;
    if (n > 1) dst[1] = second;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float first, float second, int n) {
  if (n >= 2 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(first, second);
  } else {
    if (n > 0) dst[0] = __float2bfloat16(first);
    if (n > 1) dst[1] = __float2bfloat16(second);
  }
}

// the two operand tiles of one K chunk, each as bf16 hi and lo parts
struct Tiles {
  __nv_bfloat16 ah[TT * LD], al[TT * LD], bh[TT * LD], bl[TT * LD];
};

// --- staging: global -> registers (in flight during the previous chunk's
// products) -> bf16 hi / lo parts in shared memory -----------------------------

// eight consecutive elements of a row as loaded, not yet converted
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
};

// src[0 .. 7], of which the first n are in bounds (zeros beyond): one or two
// 16-byte loads where the eight are in bounds and aligned
__device__ __forceinline__ Raw8<float> load8(const float* src, int n) {
  Raw8<float> r;
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    r.a = __ldg(reinterpret_cast<const float4*>(src));
    r.b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  } else {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? src[i] : 0.f;
    r.a = make_float4(v[0], v[1], v[2], v[3]);
    r.b = make_float4(v[4], v[5], v[6], v[7]);
  }
  return r;
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* src, int n) {
  Raw8<__nv_bfloat16> r;
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    r.a = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < n ? (uint32_t)s[2 * i] : 0u) |
             (2 * i + 1 < n ? (uint32_t)s[2 * i + 1] << 16 : 0u);
    r.a = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// (first, second) as a bf16 pair, and (if LO) the rest of each as another
template <bool LO>
__device__ __forceinline__ void split2(float first, float second, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(first, second);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if (LO) lo = sm90::pack_bf16(first - __low2float(h), second - __high2float(h));
}

// v[0 .. 7] as bf16 hi (and lo) parts at hi[idx ..], lo[idx ..] (16-byte stores)
template <bool LO>
__device__ __forceinline__ void put8(__nv_bfloat16* hi, __nv_bfloat16* lo, int idx,
                                     const float (&v)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split2<LO>(v[2 * i], v[2 * i + 1], h[i], l[i]);
  *reinterpret_cast<uint4*>(hi + idx) = make_uint4(h[0], h[1], h[2], h[3]);
  if (LO) *reinterpret_cast<uint4*>(lo + idx) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <class A, class B>
struct Both {
  A a;
  B b;
};

// A 64 x 64 operand tile whose rows are rows of the source, k contiguous:
// four groups of eight a thread, group u = tid + NT m at row u / 8, k 8 (u % 8).
template <typename T>
struct Direct {
  Raw8<T> g[4];
};
// rows and column groups of a Direct tile
__device__ __forceinline__ int direct_row(int m) { return (threadIdx.x + NT * m) / 8; }
__device__ __forceinline__ int direct_k(int m) { return 8 * ((threadIdx.x + NT * m) % 8); }

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of each matrix, the
// pair (rows 2 (l % 4), 2 (l % 4) + 1; column l / 4)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(p))
               : "memory");
}

// This warp's A fragments (rows 16 warp .., k 16 ks ..) of a tile stored
// [m][k] (K_MAJOR: 4-byte loads) or [k][m] (ldmatrix.trans)
template <bool K_MAJOR>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (K_MAJOR) {
    const int idx = (warp * 16 + (lane >> 2)) * LD + ks * 16 + 2 * (lane & 3);
    a[0] = *reinterpret_cast<const uint32_t*>(tile + idx);
    a[1] = *reinterpret_cast<const uint32_t*>(tile + idx + 8 * LD);
    a[2] = *reinterpret_cast<const uint32_t*>(tile + idx + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(tile + idx + 8 * LD + 8);
  } else {
    const int k = ks * 16 + (lane & 7) + 8 * (lane >> 4);
    ldsm_x4_trans(a, tile + k * LD + warp * 16 + 8 * ((lane >> 3) & 1));
  }
}

// B fragments of the n-tiles nt and nt + 1 (b[0], b[1] and b[2], b[3]) of a
// tile stored [n][k] (K_MAJOR) or [k][n]
template <bool K_MAJOR>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const __nv_bfloat16* tile, int ks,
                                        int nt) {
  const int lane = threadIdx.x & 31;
  if (K_MAJOR) {
    const int idx = (nt * 8 + (lane >> 2)) * LD + ks * 16 + 2 * (lane & 3);
    b[0] = *reinterpret_cast<const uint32_t*>(tile + idx);
    b[1] = *reinterpret_cast<const uint32_t*>(tile + idx + 8);
    b[2] = *reinterpret_cast<const uint32_t*>(tile + idx + 8 * LD);
    b[3] = *reinterpret_cast<const uint32_t*>(tile + idx + 8 * LD + 8);
  } else {
    const int k = ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    ldsm_x4_trans(b, tile + k * LD + nt * 8 + 8 * (lane >> 4));
  }
}

// acc (this warp's 16 rows x 64 columns) += A . B over one K chunk, A and B
// each stored K-major ([m][k], [n][k]) or MN-major ([k][m], [k][n]);
// hi.hi, plus hi.lo where B has a lo part, plus lo.hi where A has one
template <bool A_LO, bool B_LO, bool A_K = true, bool B_K = true>
__device__ __forceinline__ void mma_chunk(const Tiles& t, float (&acc)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < TT / 16; ++ks) {
    uint32_t ah[4], al[4];
    frag_a<A_K>(ah, t.ah, ks);
    if (A_LO) frag_a<A_K>(al, t.al, ks);
#pragma unroll
    for (int nt = 0; nt < TT / 8; nt += 2) {
      uint32_t bh[4], bl[4];
      frag_b2<B_K>(bh, t.bh, ks, nt);
      if (B_LO) frag_b2<B_K>(bl, t.bl, ks, nt);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sm90::mma_bf16_16816(acc[nt + u], ah, bh[2 * u], bh[2 * u + 1]);
        if (B_LO) sm90::mma_bf16_16816(acc[nt + u], ah, bl[2 * u], bl[2 * u + 1]);
        if (A_LO) sm90::mma_bf16_16816(acc[nt + u], al, bh[2 * u], bh[2 * u + 1]);
      }
    }
  }
}

// The K chunks 0 .. n - 1 of one product: chunk c + 1's loads are in flight
// while chunk c's products run. load(c) returns the chunk's registers,
// put(c, regs) writes them to the tiles.
template <bool A_LO, bool B_LO, bool A_K = true, bool B_K = true, class Load, class Put>
__device__ __forceinline__ void run_chunks(Tiles& t, float (&acc)[8][4], int n, Load load,
                                           Put put) {
  if (n <= 0) return;
  auto regs = load(0);
  for (int c = 0; c < n; ++c) {
    __syncthreads();  // the tiles' last products are done
    put(c, regs);
    __syncthreads();
    if (c + 1 < n) regs = load(c + 1);
    mma_chunk<A_LO, B_LO, A_K, B_K>(t, acc);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// The chunk's cumulative decay: ca[i] = sum_{i' <= i} A dt[i'] and
// dts[i] = dt[i] for i < q (0 beyond), dt read with stride H. Two steps a
// thread (q <= 2 NT), a warp scan, then the warps' totals.
__device__ void chunk_decay(const float* __restrict__ dt, int H, float A, int q, float* ca,
                            float* dts, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = 2 * tid;
  const float d0 = i0 < q ? dt[(size_t)i0 * H] : 0.f;
  const float d1 = i0 + 1 < q ? dt[(size_t)(i0 + 1) * H] : 0.f;
  const float a0 = A * d0, a1 = A * d1;
  float v = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += wsum[w];
  const float c0 = excl + a0;
  ca[i0] = i0 < q ? c0 : 0.f;
  ca[i0 + 1] = i0 + 1 < q ? c0 + a1 : 0.f;
  dts[i0] = d0;
  dts[i0 + 1] = d1;
  __syncthreads();
}

// 1. cb[(b, c, g)][i][j] = C[b, c q + i, g, :] . B[b, c q + j, g, :] on the
// 64 x 64 tiles on or below the diagonal (the scan reads no other).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb, int S, int G,
       int N, int q, int nc) {
  constexpr bool LO = sizeof(T) == 4;
  const int ti = blockIdx.y, tj = blockIdx.z;
  if (tj > ti) return;
  __shared__ Tiles t;
  const int z = blockIdx.x;  // (b nc + c) G + g
  const int g = z % G, c = (z / G) % nc, b = z / (G * nc);
  const size_t row0 = (size_t)b * S + (size_t)c * q;
  float acc[8][4];
  zero(acc);
  auto load = [&](int kc) {
    Direct<T> ca, cbt;  // rows of C (i) and of B (j)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = direct_row(m), n = kc * TT + direct_k(m);
      const int i = ti * TT + r, j = tj * TT + r;
      ca.g[m] = load8(Cm + ((row0 + i) * G + g) * N + n, i < q ? N - n : 0);
      cbt.g[m] = load8(Bm + ((row0 + j) * G + g) * N + n, j < q ? N - n : 0);
    }
    return Both<Direct<T>, Direct<T>>{ca, cbt};
  };
  auto put = [&](int, const Both<Direct<T>, Direct<T>>& regs) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int idx = direct_row(m) * LD + direct_k(m);
      float v[8];
      unpack8(regs.a.g[m], v);
      put8<LO>(t.ah, t.al, idx, v);
      unpack8(regs.b.g[m], v);
      put8<LO>(t.bh, t.bl, idx, v);
    }
  };
  run_chunks<LO, LO>(t, acc, (N + TT - 1) / TT, load, put);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = cb + (size_t)z * q * q;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ti * TT + warp * 16 + lane / 4 + (e & 2) * 4;
      const int j = tj * TT + nt * 8 + 2 * (lane & 3) + (e & 1);
      if (i < q && j < q) out[(size_t)i * q + j] = acc[nt][e];
    }
}

// 2. s[(b, c, h)][p][n] = sum_j x[j, p] w_j B[j, n], w_j = dt_j exp(ca_last -
// ca_j), for the 64 x 64 tile (p0, n0); ca_last[(b, c, h)] beside it, and
// the chunk's decays ca and steps dt, contiguous, for the scan.
template <typename T>
__global__ void __launch_bounds__(NT, 4)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ ca_last_out,
                float* __restrict__ decay, int S, int H, int P, int G, int N, int q, int nc) {
  constexpr bool LO = sizeof(T) == 4;
  __shared__ Tiles t;
  __shared__ float ca[MAX_Q], w[MAX_Q], wsum[NT / 32];
  const int z = blockIdx.x;  // (b nc + c) H + h
  const int h = z % H, c = (z / H) % nc, b = z / (H * nc);
  const int g = h / (H / G);
  const int p0 = blockIdx.y * TT, n0 = blockIdx.z * TT;
  const size_t row0 = (size_t)b * S + (size_t)c * q;
  chunk_decay(dt + row0 * H + h, H, -expf(A_log[h]), q, ca, w, wsum);
  const float ca_last = ca[q - 1];
  const bool first = blockIdx.y == 0 && blockIdx.z == 0;  // writes the chunk's decays
  float* dz = decay + (size_t)z * 2 * q;
  for (int j = threadIdx.x; j < q; j += NT) {
    if (first) {
      dz[j] = ca[j];
      dz[q + j] = w[j];
    }
    w[j] *= expf(ca_last - ca[j]);
  }
  if (threadIdx.x == 0 && first) ca_last_out[z] = ca_last;

  float acc[8][4];
  zero(acc);
  // A: x as [j][p]; B: w_j B as [j][n] (both MN-major)
  auto load = [&](int kc) {
    Direct<T> xa, bb;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = kc * TT + direct_row(m), p = p0 + direct_k(m), n = n0 + direct_k(m);
      xa.g[m] = load8(x + ((row0 + j) * H + h) * P + p, j < q ? P - p : 0);
      bb.g[m] = load8(Bm + ((row0 + j) * G + g) * N + n, j < q ? N - n : 0);
    }
    return Both<Direct<T>, Direct<T>>{xa, bb};
  };
  auto put = [&](int kc, const Both<Direct<T>, Direct<T>>& regs) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = direct_row(m), idx = r * LD + direct_k(m);
      const float wj = kc * TT + r < q ? w[kc * TT + r] : 0.f;
      float v[8];
      unpack8(regs.a.g[m], v);
      put8<LO>(t.ah, t.al, idx, v);
      unpack8(regs.b.g[m], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= wj;
      put8<true>(t.bh, t.bl, idx, v);
    }
  };
  run_chunks<LO, true, false, false>(t, acc, (q + TT - 1) / TT, load, put);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out = states + (size_t)z * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + warp * 16 + lane / 4 + (e & 2) * 4;
      const int n = n0 + nt * 8 + 2 * (lane & 3) + (e & 1);
      if (p < P && n < N) out[(size_t)p * N + n] = acc[nt][e];
    }
}

// 3. Across the chunks, per (batch, head) and element of the P x N state:
// hprev[c] = h (written over s_c), h = exp(ca_last_c) h + s_c; the final h
// is the state out. Only the multiply-add is sequential: the chunks' loads
// go out AHEAD at a time.
__global__ void __launch_bounds__(NT_PASS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ ca_last,
               float* __restrict__ state, int H, int PN, int nc) {
  const int e = blockIdx.x * NT_PASS + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  constexpr int AHEAD = 8;  // chunks whose loads are in flight at once
  float hv = 0.f;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float s[AHEAD], el[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const size_t z = ((size_t)b * nc + c0 + k) * H + h;
      s[k] = c0 + k < nc ? states[z * PN + e] : 0.f;
      el[k] = c0 + k < nc ? ca_last[z] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k >= nc) break;
      states[(((size_t)b * nc + c0 + k) * H + h) * PN + e] = hv;
      hv = expf(el[k]) * hv + s[k];
    }
  }
  state[((size_t)b * H + h) * PN + e] = hv;
}

// 4. y for the rows ti * 64 .. of chunk c and the columns p0 .. p0 + 63:
// exp(ca_i) C_i . hprev[p] + sum_{j <= i} CB[i, j] exp(ca_i - ca_j) dt_j x[j, p].
template <typename T>
__global__ void __launch_bounds__(NT, 4)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ decay,
               const T* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ hprev, T* __restrict__ y, int S, int H, int P, int G,
               int N, int q, int nc) {
  constexpr bool LO = sizeof(T) == 4;
  __shared__ Tiles t;
  __shared__ float ca[MAX_Q], dts[MAX_Q];
  const int z = blockIdx.x;  // (b nc + c) H + h
  const int h = z % H, c = (z / H) % nc, b = z / (H * nc);
  const int g = h / (H / G);
  const int ti = gridDim.y - 1 - blockIdx.y;  // the row tiles with the most tiles start first
  const int p0 = blockIdx.z * TT;
  const size_t row0 = (size_t)b * S + (size_t)c * q;
  const float* dz = decay + (size_t)z * 2 * q;  // from ssd_chunk_state
  for (int i = threadIdx.x; i < MAX_Q; i += NT) {
    ca[i] = i < q ? dz[i] : 0.f;
    dts[i] = i < q ? dz[q + i] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i_a = ti * TT + warp * 16 + lane / 4, i_b = i_a + 8;  // this thread's rows
  float acc[8][4];
  zero(acc);
  if (c > 0) {  // the carried state (zero in the first chunk): A = C [i][n], B = hprev [p][n]
    const float* hp = hprev + (size_t)z * P * N;
    auto load = [&](int kc) {
      Direct<T> cc;
      Direct<float> hh;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = direct_row(m), n = kc * TT + direct_k(m);
        const int i = ti * TT + r, p = p0 + r;
        cc.g[m] = load8(Cm + ((row0 + i) * G + g) * N + n, i < q ? N - n : 0);
        hh.g[m] = load8(hp + (size_t)p * N + n, p < P ? N - n : 0);
      }
      return Both<Direct<T>, Direct<float>>{cc, hh};
    };
    auto put = [&](int, const Both<Direct<T>, Direct<float>>& regs) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int idx = direct_row(m) * LD + direct_k(m);
        float v[8];
        unpack8(regs.a.g[m], v);
        put8<LO>(t.ah, t.al, idx, v);
        unpack8(regs.b.g[m], v);
        put8<true>(t.bh, t.bl, idx, v);
      }
    };
    run_chunks<LO, true>(t, acc, (N + TT - 1) / TT, load, put);
    const float e_a = i_a < q ? expf(ca[i_a]) : 0.f, e_b = i_b < q ? expf(ca[i_b]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= e_a;
      acc[nt][1] *= e_a;
      acc[nt][2] *= e_b;
      acc[nt][3] *= e_b;
    }
  }

  // the chunk's own inputs, over the tiles on or below the diagonal:
  // A = CB exp(ca_i - ca_j) dt_j as [i][j], B = x as [j][p] (MN-major)
  const float* cbz = cb + ((size_t)(b * nc + c) * G + g) * q * q;
  auto load = [&](int tj) {
    Direct<float> ss;
    Direct<T> xx;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = ti * TT + direct_row(m), j = tj * TT + direct_k(m);
      ss.g[m] = load8(cbz + (size_t)i * q + j, i < q ? min(q, i + 1) - j : 0);
      const int jx = tj * TT + direct_row(m), p = p0 + direct_k(m);
      xx.g[m] = load8(x + ((row0 + jx) * H + h) * P + p, jx < q ? P - p : 0);
    }
    return Both<Direct<float>, Direct<T>>{ss, xx};
  };
  auto put = [&](int tj, const Both<Direct<float>, Direct<T>>& regs) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = direct_row(m), i = ti * TT + r, j0 = tj * TT + direct_k(m);
      float v[8];
      unpack8(regs.a.g[m], v);
      const float ci = i < q ? ca[i] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + e;  // j <= i < q: the decay is at most 1 (__expf: 1e-6 relative)
        v[e] = (i < q && j <= i) ? v[e] * __expf(ci - ca[j]) * dts[j] : 0.f;
      }
      put8<true>(t.ah, t.al, r * LD + direct_k(m), v);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float v[8];
      unpack8(regs.b.g[m], v);
      put8<LO>(t.bh, t.bl, direct_row(m) * LD + direct_k(m), v);
    }
  };
  run_chunks<true, LO, true, false>(t, acc, ti + 1, load, put);

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? i_b : i_a, p = p0 + nt * 8 + 2 * (lane & 3);
      if (i < q)
        store2(&y[((row0 + i) * H + h) * P + p], acc[nt][2 * r], acc[nt][2 * r + 1], P - p);
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, void* y, void* state, void* work, int B, int S, int H, int P,
                   int G, int N, int q, cudaStream_t stream) {
  const int nc = S / q;
  const int tq = (q + TT - 1) / TT;
  float* cb = static_cast<float*>(work);
  float* states = cb + (size_t)B * nc * G * q * q;
  float* ca_last = states + (size_t)B * nc * H * P * N;
  float* decay = ca_last + (size_t)B * nc * H;
  cudaError_t err;
  if (nc > 0) {
    ssd_cb<T><<<dim3(B * nc * G, tq, tq), NT, 0, stream>>>(
        static_cast<const T*>(Bm), static_cast<const T*>(Cm), cb, S, G, N, q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_chunk_state<T><<<dim3(B * nc * H, (P + TT - 1) / TT, (N + TT - 1) / TT), NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A_log), static_cast<const T*>(Bm), states, ca_last, decay, S, H,
        P, G, N, q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_state_pass<<<dim3((P * N + NT_PASS - 1) / NT_PASS, H, B), NT_PASS, 0, stream>>>(
      states, ca_last, static_cast<float*>(state), H, P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 0) {
    ssd_chunk_scan<T><<<dim3(B * nc * H, tq, (P + TT - 1) / TT), NT, 0, stream>>>(
        static_cast<const T*>(x), decay, static_cast<const T*>(Cm), cb, states,
        static_cast<T*>(y), S, H, P, G, N, q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x (B, S, H, P), Bm / Cm (B, S, G, N) of one dtype (0 = float32,
// 1 = bfloat16); dt (B, S, H) and A_log (H,) float32; y (B, S, H, P) in x's
// dtype; state (B, H, P, N) float32; work a float32 scratch of
// B * (S / q) * (G * q * q + H * P * N + H + 2 * H * q) floats: C.B^T of
// every (batch, chunk, group), each (batch, chunk, head)'s own state and then
// its incoming one, its total decay, and its decays and steps. All
// contiguous; 0 < q <= 256,
// S % q == 0, H % G == 0. Launches on `stream` and returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                            const void* Cm, void* y, void* state, void* work, int dtype, int B,
                            int S, int H, int P, int G, int N, int q, void* stream) {
  if (q <= 0 || q > MAX_Q || S % q != 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A_log, Bm, Cm, y, state, work, B, S, H, P, G, N, q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, y, state, work, B, S, H, P, G, N, q, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
