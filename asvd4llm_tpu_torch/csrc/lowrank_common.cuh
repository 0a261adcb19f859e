// Pieces shared by the low-rank kernels: conversions, the bf16 tensor-core
// step, grid splitting and the bias finish (fused_lowrank.cu,
// fused_lowrank_q8.cu, fused_lowrank_q4.cu); the staging of X and the
// CUDA-core NT products over a weight "decoder" that yields W[n, k] as f32
// (the quantized kernels' f32 forms, and bf16 shapes their tensor-core
// forms do not take).
//
// Every product here is "NT": acc[M, N] += X[M, K] · W[N, K]ᵀ, split over K
// across the grid, partial sums meeting in a scratch of fixed-point
// accumulators (Acc below; fused_lowrank.cu's design note explains why).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace lrq {

using bf16 = __nv_bfloat16;

constexpr int kSms = 132;
constexpr int kSkinnyMaxM = 16;  // M at or below it takes the decode forms

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Split-K partial sums meet in a zeroed scratch of 64-bit fixed-point
// accumulators, in units of 2^-32, through integer atomics. Integer
// addition is associative, so a sum does not depend on the order in which
// the blocks finish, as an f32 atomicAdd's does: two runs of a decode step,
// eager or replayed from a CUDA graph, give the same bits and the same
// tokens. Range ±2^31; each partial is rounded to a multiple of 2^-32
// (about 2.3e-10), finer than f32 rounds any partial above 2^-9.
using Acc = unsigned long long;

__device__ __forceinline__ void acc_add(Acc* a, float v) {
  atomicAdd(a, static_cast<Acc>(__float2ll_rn(v * 4294967296.0f)));
}

// The accumulator's value, rounded once to f32 (the scale is a power of 2).
__device__ __forceinline__ float acc_value(Acc a) {
  return __ll2float_rn(static_cast<long long>(a)) * 2.3283064365386963e-10f;
}
__device__ __forceinline__ float to_f32(Acc v) { return acc_value(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024); the
// result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Split the reduction so that the grid holds about `per_sm` blocks per SM,
// in chunks that are a multiple of `step` and at least `min_steps` steps.
inline int k_chunk_for(int K, int base_blocks, int per_sm, int step, int min_steps) {
  int splits = cdiv(per_sm * kSms, base_blocks);
  splits = std::max(1, std::min(splits, cdiv(K, min_steps * step)));
  return cdiv(cdiv(K, splits), step) * step;
}

// ------------------------------------------------------------ conversions

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte i of u (0..255) as the float 2^23 + u: the byte becomes the low
// mantissa bits of 0x4B000000. One byte permute instead of a conversion.
__device__ __forceinline__ float byte_magic(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + i));
}

// Four signed int8 codes (one 32-bit word, lowest byte first) as two bf16
// pairs, exactly: (v + 128) as an unsigned byte, through the magic float.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  const float off = 8388608.f + 128.f;
  p01 = pack_bf16(byte_magic(u, 0) - off, byte_magic(u, 1) - off);
  p23 = pack_bf16(byte_magic(u, 2) - off, byte_magic(u, 3) - off);
}

// Four 4-bit codes (the low or high nibbles of one 32-bit word of packed
// bytes, lowest byte first) dequantized as code·scale − zero_scale in f32,
// each product and difference rounded as the plain version rounds them.
__device__ __forceinline__ void q4x4_dequant(uint32_t nibbles, float s, float z, float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = __fsub_rn(__fmul_rn(byte_magic(nibbles, i) - 8388608.f, s), z);
}
__device__ __forceinline__ void q4x4_to_bf16(uint32_t nibbles, float s, float z, uint32_t& p01,
                                             uint32_t& p23) {
  float d[4];
  q4x4_dequant(nibbles, s, z, d);
  p01 = pack_bf16(d[0], d[1]);
  p23 = pack_bf16(d[2], d[3]);
}

// c += A(16x16, row) · B(16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

// X[row, k..k+7] of a bf16 matrix whose rows hold K values, as eight bf16
// in 16 bytes; columns at or past K read as 0. `vec` says every row starts
// 16-byte aligned (K % 8 == 0 and X aligned).
__device__ __forceinline__ uint4 load_x8(const bf16* X, size_t row, int k, int K, bool vec) {
  const bf16* p = X + row * (size_t)K + k;
  if (vec && k + 8 <= K) return ld16(p);
  __align__(16) bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k + i < K ? p[i] : __float2bfloat16_rn(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// ------------------------------------------------- CUDA-core NT products

// Weight decoders: W(n, k) is the f32 value of row n, logical column k.
struct DecI8 {  // int8 codes, raw (the q8 products multiply raw codes)
  const int8_t* w;
  int ld;
  __device__ __forceinline__ float operator()(int n, int k) const {
    return (float)w[(size_t)n * ld + k];
  }
};

struct DecQ4 {  // packed 4-bit codes, dequantized (split-half, 512-column tiles)
  const uint8_t* w;
  const float* sc;
  const float* zs;
  int ld;     // bytes per row
  int ngrp;   // scale groups per row
  int group;
  __device__ __forceinline__ float operator()(int n, int k) const {
    const int in_tile = k & 511;
    const uint8_t b = w[(size_t)n * ld + (k >> 9) * 256 + (in_tile & 255)];
    const int code = in_tile < 256 ? (b & 15) : (b >> 4);
    const size_t gi = (size_t)n * ngrp + k / group;
    return __fsub_rn(__fmul_rn((float)code, sc[gi]), zs[gi]);
  }
};

constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 4;                       // W rows per warp
constexpr int kGemvBlockRows = kGemvWarps * kGemvRows;
constexpr int kGemvChunk = 512;                    // K per block

// M <= 16: the block's K chunk of X sits in shared memory as f32; lanes
// stride over k, each warp owns kGemvRows rows of W.
template <typename TX, typename Dec, int MM>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_dec(const TX* __restrict__ X, int Kx, Dec W, Acc* __restrict__ acc, int M, int N, int K) {
  __shared__ float xs[MM * kGemvChunk];
  const int k0 = blockIdx.y * kGemvChunk;
  const int kn = min(kGemvChunk, K - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kGemvBlockRows + warp * kGemvRows;
  for (int i = threadIdx.x; i < M * kn; i += blockDim.x) {
    const int m = i / kn, k = i - m * kn;
    xs[m * kGemvChunk + k] = k0 + k < Kx ? to_f32(X[(size_t)m * Kx + k0 + k]) : 0.f;
  }
  __syncthreads();
  float s[kGemvRows][MM];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m) s[r][m] = 0.f;
  for (int k = lane; k < kn; k += 32) {
    float w[kGemvRows];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) w[r] = n0 + r < N ? W(n0 + r, k0 + k) : 0.f;
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (m < M) {
        const float xv = xs[m * kGemvChunk + k];
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r) s[r][m] = fmaf(w[r], xv, s[r][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (m < M && n0 + r < N) {
        const float v = warp_sum(s[r][m]);
        if (lane == 0) acc_add(&acc[(size_t)m * N + n0 + r], v);
      }
    }
}

constexpr int kNtThreads = 256;  // 16 x 16
constexpr int kNtBK = 32;
constexpr int kNtBM = 64;
constexpr int kNtBN = 64;

// M > 16: a 16x16-thread block computes a 64 x 64 output tile over the K
// slice of this blockIdx.z.
template <typename TX, typename Dec>
__global__ void __launch_bounds__(kNtThreads)
nt_dec(const TX* __restrict__ X, int Kx, Dec W, Acc* __restrict__ acc, int M, int N, int K,
       int k_chunk) {
  constexpr int TM = kNtBM / 16, TN = kNtBN / 16;
  __shared__ float xs[kNtBK][kNtBM + 1];
  __shared__ float ws[kNtBK][kNtBN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kNtBM, n0 = blockIdx.x * kNtBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float c[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kNtBK) {
    for (int i = tid; i < kNtBM * kNtBK; i += kNtThreads) {
      const int r = i / kNtBK, kk = i % kNtBK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < k_end && k < Kx) ? to_f32(X[(size_t)m * Kx + k]) : 0.f;
    }
    for (int i = tid; i < kNtBN * kNtBK; i += kNtThreads) {
      const int r = i / kNtBK, kk = i % kNtBK;
      const int n = n0 + r, k = k0 + kk;
      ws[kk][r] = (n < N && k < k_end) ? W(n, k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kNtBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) acc_add(&acc[(size_t)m * N + n], c[i][j]);
    }
  }
}

// acc[M, N] += X[M, Kx] · W[N, K]ᵀ on the CUDA cores, X zero past column Kx.
template <typename TX, typename Dec>
void launch_cuda_cores(const TX* X, int Kx, Dec W, Acc* acc, int M, int N, int K,
                       cudaStream_t s) {
  if (M <= kSkinnyMaxM) {
    const dim3 grid(cdiv(N, kGemvBlockRows), cdiv(K, kGemvChunk));
    const int b = kGemvWarps * 32;
    if (M <= 1) gemv_dec<TX, Dec, 1><<<grid, b, 0, s>>>(X, Kx, W, acc, M, N, K);
    else if (M <= 2) gemv_dec<TX, Dec, 2><<<grid, b, 0, s>>>(X, Kx, W, acc, M, N, K);
    else if (M <= 4) gemv_dec<TX, Dec, 4><<<grid, b, 0, s>>>(X, Kx, W, acc, M, N, K);
    else if (M <= 8) gemv_dec<TX, Dec, 8><<<grid, b, 0, s>>>(X, Kx, W, acc, M, N, K);
    else gemv_dec<TX, Dec, 16><<<grid, b, 0, s>>>(X, Kx, W, acc, M, N, K);
    return;
  }
  const int base = cdiv(N, kNtBN) * cdiv(M, kNtBM);
  const int k_chunk = k_chunk_for(K, base, 2, kNtBK, 4);
  const dim3 grid(cdiv(N, kNtBN), cdiv(M, kNtBM), cdiv(K, k_chunk));
  nt_dec<TX, Dec><<<grid, kNtThreads, 0, s>>>(X, Kx, W, acc, M, N, K, k_chunk);
}

// ------------------------------------------------ tensor-core tile shapes

constexpr int kSkinnyWarps = 4;                  // each warp owns 16 rows of W
constexpr int kSkinnyRows = kSkinnyWarps * 16;   // W rows per block
constexpr int kSkinnySub = 512;                  // logical K per pass
constexpr int kSkinnyLd = kSkinnySub + 8;        // xs row stride: 1040 bytes, so the
                                                 // rows an 8-lane phase reads fall
                                                 // on different banks
constexpr int kTile = 64;                        // output rows and columns per block
constexpr int kTileK = 64;                       // logical K per stage
constexpr int kTileLd = kTileK + 8;              // bf16 stage row stride (WMMA: multiple of 8)
constexpr int kTileCLd = kTile + 4;              // f32 epilogue row stride

// Store the skinny form's accumulators: c[mt][j] is W row `row` (+8 for
// j >= 2), X row mt*8 + 2t + (j & 1).
__device__ __forceinline__ void skinny_store(const float (&c)[2][4], Acc* acc, int row, int t,
                                             int m_tiles, int M, int N) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = row + (j >= 2 ? 8 : 0);
      const int m = mt * 8 + 2 * t + (j & 1);
      if (mt < m_tiles && m < M && n < N) acc_add(&acc[(size_t)m * N + n], c[mt][j]);
    }
}

// y = round(acc + bias); bias may be null.
template <typename T>
__global__ void finalize_bias(const Acc* __restrict__ acc, const T* __restrict__ bias,
                              T* __restrict__ y, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float v = acc_value(acc[i]);
  if (bias != nullptr) v += to_f32(bias[i % N]);
  y[i] = from_f32<T>(v);
}

}  // namespace lrq
