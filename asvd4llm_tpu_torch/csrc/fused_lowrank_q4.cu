// Fused low-rank linear with packed 4-bit factors for Hopper (sm_90a):
//   y = (x · dq(B4)ᵀ) · dq(A4)ᵀ + bias,
//   dq(W)[r, k] = code(r, k)·scale[r, k/group] − zero_scale[r, k/group].
//
// Replaces asvd4llm_tpu/ops/pallas_lowrank.py::_fused_2d_q4 (body
// `_q4_kernel`, public wrapper `fused_lowrank_apply_q4`), the decode-time
// apply of an int4-deployed SVDLinear (M <= 1024 tokens).
//
// Layout (asvd4llm_tpu/ops/quant.py pack_int4, kept byte for byte): rows
// are cut into 512-column tiles; in each tile the low nibble of packed
// byte c is column c and the high nibble is column c + 256. R and K are
// padded to multiples of 512 at quantization time (Rp, Kp); padded groups
// have scale 0 and zero_scale 0 and dequantize to exactly 0.
//
// Semantics kept from the TPU kernel (and its dequantize-then-matmul
// oracle): each code is dequantized in f32 and rounded once to the io type
// before the product; t = x · dq(B4)ᵀ accumulates in f32 and is rounded
// once to the io type; y = t · dq(A4)ᵀ in f32, plus bias, one rounding.
// (The TPU kernel dequantizes bf16 tiles in bf16 arithmetic, which differs
// from this by at most one bf16 ulp per weight.)
//
// What bounds it on this card: bytes at decode shapes. The codes are
// (Rp·Kp + N·Rp)/2 bytes, plus 8 bytes of f32 scales per row and group
// (12.5% more at group 128). At M = 1024 the tensor cores bound it.
//
// Design (kernel 1's, fused_lowrank.cu, with a dequantization in front of
// every product):
//   * the scales change along k every `group` columns, so a code cannot be
//     multiplied raw and corrected afterwards as in the q8 kernel: every
//     lane dequantizes its codes in registers before the MMA;
//   * the split-half layout needs no unshuffle: the k order of a dot
//     product is free, so a lane's 16 packed bytes give codes at columns
//     c..c+15 (low nibbles) and c+256..c+271 (high nibbles), and X is read
//     at those same columns;
//   * bf16, M <= 16 (`skinny_q4`): mma.sync m16n8k16 with the operands
//     swapped, one 512-column tile per pass (256 packed bytes a row), X
//     staged in shared memory; each 16-byte load feeds eight MMAs, four for
//     its low nibbles and four for its high nibbles;
//   * bf16, M > 16 (`tiled_q4`): 64 x 64 output tiles on WMMA; a stage is
//     32 packed bytes a row, dequantized into shared memory as 64 bf16
//     columns (the 32 low-nibble columns, then their 32 high-nibble
//     partners) with X staged in the same order;
//   * f32: the CUDA-core forms of lowrank_common.cuh, dequantizing each
//     code as they load it.
//   X is never read past its K columns (K <= Kp): those columns read as 0.
//   Every `group` that is a multiple of 16 and divides 256 is taken, so a
//   16-column run of codes never crosses a group.

#include <mma.h>

#include "lowrank_common.cuh"

namespace {

using namespace lrq;

struct Q4 {  // one packed factor: rows of `ld` bytes, scales [rows, ngrp]
  const uint8_t* w;
  const float* sc;
  const float* zs;
  int ld;
  int ngrp;
  int group;
};

// The 16 low and 16 high nibbles of a 16-byte load as 8 + 8 bf16 pairs
// (pair p of `lo` is columns c+2p, c+2p+1; of `hi`, the same + 256).
__device__ __forceinline__ void q4x16_to_bf16(const uint4& v, float s_lo, float z_lo, float s_hi,
                                              float z_hi, uint32_t (&lo)[8], uint32_t (&hi)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q4x4_to_bf16(w[i] & 0x0F0F0F0Fu, s_lo, z_lo, lo[2 * i], lo[2 * i + 1]);
    q4x4_to_bf16((w[i] >> 4) & 0x0F0F0F0Fu, s_hi, z_hi, hi[2 * i], hi[2 * i + 1]);
  }
}

// acc[M, N] += X[M, Kx] · dq(W)[N, 2P]ᵀ over the packed-column chunk of this
// blockIdx.y (a multiple of 256 bytes: whole 512-column tiles), M <= 16.
//
// Lane (g, t) of the warp owning W rows r0..r0+15 loads, per tile, rows
// r0 + g and r0 + g + 8 at packed columns 64i + 16t (i = 0..3). Its low
// nibbles are tile columns 64i+16t.., its high nibbles the same + 256; each
// set of 16 feeds four MMAs exactly as the int8 kernel's 16 codes do.
__global__ void __launch_bounds__(kSkinnyWarps * 32)
skinny_q4(const bf16* __restrict__ X, int Kx, Q4 W, float* __restrict__ acc, int M, int N,
          int P, int p_chunk, bool xvec) {
  __shared__ __align__(16) bf16 xs[16 * kSkinnyLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * kSkinnyRows + warp * 16 + g;  // and row + 8
  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  const int m_tiles = M > 8 ? 2 : 1;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const bool in0 = row < N, in1 = row + 8 < N;

  float c[2][4] = {};
  for (int p0 = p_begin; p0 < p_end; p0 += kSkinnySub / 2) {
    const int kbase = p0 * 2;  // first logical column of this tile
    uint4 q0[4], q1[4];
    float s0[4][2], z0[4][2], s1[4][2], z1[4][2];  // [chunk][low, high half]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pc = i * 64 + t * 16;
      q0[i] = in0 ? ld16(W.w + (size_t)row * W.ld + p0 + pc) : zero;
      q1[i] = in1 ? ld16(W.w + (size_t)(row + 8) * W.ld + p0 + pc) : zero;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = (kbase + h * 256 + pc) / W.group;
        const size_t i0 = (size_t)row * W.ngrp + gi, i1 = (size_t)(row + 8) * W.ngrp + gi;
        s0[i][h] = in0 ? W.sc[i0] : 0.f;
        z0[i][h] = in0 ? W.zs[i0] : 0.f;
        s1[i][h] = in1 ? W.sc[i1] : 0.f;
        z1[i][h] = in1 ? W.zs[i1] : 0.f;
      }
    }
    __syncthreads();  // the previous pass is done with xs
    for (int i = threadIdx.x; i < 16 * (kSkinnySub / 8); i += blockDim.x) {
      const int m = i / (kSkinnySub / 8), k = (i % (kSkinnySub / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + m * kSkinnyLd + k) =
          m < M ? load_x8(X, m, kbase + k, Kx, xvec) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a_lo[8], a_hi[8], b_lo[8], b_hi[8];  // a: row g, b: row g + 8
      q4x16_to_bf16(q0[i], s0[i][0], z0[i][0], s0[i][1], z0[i][1], a_lo, a_hi);
      q4x16_to_bf16(q1[i], s1[i][0], z1[i][0], s1[i][1], z1[i][1], b_lo, b_hi);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < m_tiles) {
          const bf16* xr = xs + (mt * 8 + g) * kSkinnyLd + i * 64 + t * 16;
          uint4 x0 = ld16(xr), x1 = ld16(xr + 8);
          mma16816(c[mt], a_lo[0], b_lo[0], a_lo[1], b_lo[1], x0.x, x0.y);
          mma16816(c[mt], a_lo[2], b_lo[2], a_lo[3], b_lo[3], x0.z, x0.w);
          mma16816(c[mt], a_lo[4], b_lo[4], a_lo[5], b_lo[5], x1.x, x1.y);
          mma16816(c[mt], a_lo[6], b_lo[6], a_lo[7], b_lo[7], x1.z, x1.w);
          x0 = ld16(xr + 256);
          x1 = ld16(xr + 264);
          mma16816(c[mt], a_hi[0], b_hi[0], a_hi[1], b_hi[1], x0.x, x0.y);
          mma16816(c[mt], a_hi[2], b_hi[2], a_hi[3], b_hi[3], x0.z, x0.w);
          mma16816(c[mt], a_hi[4], b_hi[4], a_hi[5], b_hi[5], x1.x, x1.y);
          mma16816(c[mt], a_hi[6], b_hi[6], a_hi[7], b_hi[7], x1.z, x1.w);
        }
      }
    }
  }
  skinny_store(c, acc, row, t, m_tiles, M, N);
}

// The same product for M > 16: a 64 x 64 output tile per block on WMMA.
// Stage s covers packed columns p0..p0+31 of one tile: shared-memory column
// j < 32 is logical column kbase + (p0 % 256) + j, column 32 + j is that
// + 256, for W and X alike.
__global__ void __launch_bounds__(128)
tiled_q4(const bf16* __restrict__ X, int Kx, Q4 W, float* __restrict__ acc, int M, int N,
         int P, int p_chunk, bool xvec) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 xs[kTile * kTileLd];
  __shared__ __align__(32) bf16 ws[kTile * kTileLd];
  __shared__ __align__(32) float cs[kTile * kTileCLd];
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int p_begin = blockIdx.z * p_chunk;
  const int p_end = min(P, p_begin + p_chunk);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int p0 = p_begin; p0 < p_end; p0 += kTileK / 2) {
    const int klo = (p0 / 256) * 512 + p0 % 256;  // logical column of smem column 0
    for (int i = threadIdx.x; i < kTile * (kTileK / 8); i += blockDim.x) {
      const int r = i / (kTileK / 8), j = (i % (kTileK / 8)) * 8;
      const int k = j < 32 ? klo + j : klo + 256 + j - 32;
      *reinterpret_cast<uint4*>(xs + r * kTileLd + j) =
          m0 + r < M ? load_x8(X, m0 + r, k, Kx, xvec) : zero;
    }
    for (int i = threadIdx.x; i < kTile * 2; i += blockDim.x) {
      const int r = i / 2, j = (i % 2) * 16, n = n0 + r;
      uint32_t lo[8] = {}, hi[8] = {};
      if (n < N) {
        const uint4 v = ld16(W.w + (size_t)n * W.ld + p0 + j);
        const size_t gl = (size_t)n * W.ngrp + (klo + j) / W.group;
        const size_t gh = (size_t)n * W.ngrp + (klo + 256 + j) / W.group;
        q4x16_to_bf16(v, W.sc[gl], W.zs[gl], W.sc[gh], W.zs[gh], lo, hi);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + r * kTileLd + j);
      dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dst = reinterpret_cast<uint4*>(ws + r * kTileLd + 32 + j);
      dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * kTileLd + kk, kTileLd);
        wmma::load_matrix_sync(b[i], ws + (wn + 16 * i) * kTileLd + kk, kTileLd);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kTileCLd + wn + 16 * j, c[i][j], kTileCLd,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, col = i % kTile;
    if (m0 + r < M && n0 + col < N)
      atomicAdd(&acc[(size_t)(m0 + r) * N + n0 + col], cs[r * kTileCLd + col]);
  }
}

// t = round(acc) to T.
template <typename T>
__global__ void round_t(const float* __restrict__ acc, T* __restrict__ t, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) t[i] = from_f32<T>(acc[i]);
}

// acc[M, N] += X[M, Kx] · dq(W)[N, 2P]ᵀ.
template <typename T>
void launch_nt(const T* X, int Kx, const Q4& W, float* acc, int M, int N, int P,
               cudaStream_t s) {
  if (sizeof(T) != 2 || !aligned16(W.w) || W.ld % 16 != 0) {
    launch_cuda_cores<T>(X, Kx, DecQ4{W.w, W.sc, W.zs, W.ld, W.ngrp, W.group}, acc, M, N,
                         2 * P, s);
    return;
  }
  const bf16* Xb = reinterpret_cast<const bf16*>(X);
  const bool xvec = Kx % 8 == 0 && aligned16(X);
  if (M <= kSkinnyMaxM) {
    const int rows = cdiv(N, kSkinnyRows);
    const int p_chunk = k_chunk_for(P, rows, 4, kSkinnySub / 2, 1);
    skinny_q4<<<dim3(rows, cdiv(P, p_chunk)), kSkinnyWarps * 32, 0, s>>>(
        Xb, Kx, W, acc, M, N, P, p_chunk, xvec);
    return;
  }
  const int base = cdiv(N, kTile) * cdiv(M, kTile);
  const int p_chunk = k_chunk_for(P, base, 2, kTileK / 2, 4);
  tiled_q4<<<dim3(cdiv(N, kTile), cdiv(M, kTile), cdiv(P, p_chunk)), 128, 0, s>>>(
      Xb, Kx, W, acc, M, N, P, p_chunk, xvec);
}

template <typename T>
int run(const T* x, const Q4& B, const Q4& A, const T* bias, T* y, float* scratch, T* t, int M,
        int K, int Rp, int Kp, int N, cudaStream_t s) {
  float* t_acc = scratch;                  // [M, Rp]
  float* y_acc = t_acc + (size_t)M * Rp;   // [M, N]
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(float) * (size_t)M * (Rp + N), s);
  if (err != cudaSuccess) return (int)err;
  launch_nt<T>(x, K, B, t_acc, M, Rp, Kp / 2, s);       // acc = x · dq(B4)ᵀ
  const size_t nt = (size_t)M * Rp;
  round_t<T><<<(unsigned)((nt + 255) / 256), 256, 0, s>>>(t_acc, t, nt);
  launch_nt<T>(t, Rp, A, y_acc, M, N, Rp / 2, s);       // acc = T(t) · dq(A4)ᵀ
  const size_t total = (size_t)M * N;
  finalize_bias<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(y_acc, bias, y, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [M,K] (K <= Kp) and y [M,N] of the io
// type; b4 [Rp, Kp/2] packed codes with bsc/bzs [Rp, Kp/group] f32; a4
// packed codes, N rows of Rp/2 bytes, with asc/azs [N, Rp/group] f32; bias
// [N] of the io type or null; Rp and Kp multiples of 512; group a multiple
// of 16 dividing 256. scratch holds M·(Rp+N) f32 values, t M·Rp values of
// the io type. Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fused_lowrank_q4_launch(const void* x, const void* b4, const void* bsc,
                                       const void* bzs, const void* a4, const void* asc,
                                       const void* azs, const void* bias, void* y,
                                       void* scratch, void* t, int M, int K, int Rp, int Kp,
                                       int N, int group, int dtype, void* stream) {
  if (Rp % 512 != 0 || Kp % 512 != 0 || group % 16 != 0 || 256 % group != 0 || K > Kp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Q4 B{static_cast<const uint8_t*>(b4), static_cast<const float*>(bsc),
             static_cast<const float*>(bzs), Kp / 2, Kp / group, group};
  const Q4 A{static_cast<const uint8_t*>(a4), static_cast<const float*>(asc),
             static_cast<const float*>(azs), Rp / 2, Rp / group, group};
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(x), B, A, static_cast<const float*>(bias),
                      static_cast<float*>(y), scr, static_cast<float*>(t), M, K, Rp, Kp, N, s);
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(x), B, A, static_cast<const bf16*>(bias),
                     static_cast<bf16*>(y), scr, static_cast<bf16*>(t), M, K, Rp, Kp, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_lowrank_q4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
