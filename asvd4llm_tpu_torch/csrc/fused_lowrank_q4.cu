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
// Forms, chosen by the wrapper (`ops/fused_lowrank_q.py::_form_q4`) and
// passed in:
//   * "wgmma_tiled" (bf16, M > 16, K a multiple of 8, 16-byte aligned
//     operands): two launches of `gemm_nt_q4` below, kernel 1's TMA-fed
//     wgmma GEMM (gemm_sm90.cuh) with a dequantizing converter in front of
//     the products. Stage 1 writes t = T(x · dq(B4)ᵀ) over all Rp rows of B4
//     (padded rows have scale 0, so t's padded columns are exactly 0);
//     stage 2 writes y = T(T(t) · dq(A4)ᵀ + bias) with its k loop over Rp.
//     A producer warp keeps TMA loads of X's bf16 stage and W's packed bytes
//     (uint8, no swizzle) a ring's depth ahead. A ring stage is 64 packed
//     bytes of each W row: their low nibbles are logical columns
//     [c, c + 64) of a 512-column pack tile, their high nibbles
//     [c + 256, c + 320), so X's stage is two 64-column TMA boxes at exactly
//     those columns and each half is one gemm_nt k-step with its own W tile
//     (the k order of a dot product is free: nothing is unshuffled). The
//     consumer warpgroups dequantize each half (code·scale − zero_scale in
//     f32, rounded once to bf16: the plain version's arithmetic, so no
//     correction follows the products) into the 128-byte swizzle that TMA
//     would have written, where gemm_nt's wgmma descriptors read it; the
//     converted tiles rotate over three buffers, so that the conversion of
//     one half overlaps the products of the previous one. A 16-column run of
//     codes never crosses a group, so each converter thread reads one
//     (scale, zero_scale) pair per row and half, before it waits for the
//     stage. The epilogue adds the bias in f32 and rounds once. No memset,
//     atomics or finishing launches: t leaves stage 1 as bf16.
//   * The split-K forms (the first design), for everything else, summing
//     in a scratch of fixed-point accumulators (lrq::Acc: integer atomics,
//     the same bits whatever order the blocks finish in) that `round_t` and
//     `finalize_bias` finish:
//     - "mma_skinny" (bf16, M <= 16, `skinny_q4`): mma.sync m16n8k16 with the
//       operands swapped, one 512-column tile per pass (256 packed bytes a
//       row), X staged in shared memory; each 16-byte load feeds eight
//       MMAs, four for its low nibbles and four for its high nibbles;
//     - "wmma_tiled" (bf16, M > 16, shapes the wgmma form does not take,
//       `tiled_q4`): 64 x 64 output tiles on WMMA; a stage is 32 packed bytes
//       a row, dequantized into shared memory as 64 bf16 columns (the 32
//       low-nibble columns, then their 32 high-nibble partners) with X
//       staged in the same order;
//     - "cuda_cores" (f32, or codes not 16-byte aligned): the CUDA-core
//       forms of lowrank_common.cuh, dequantizing each code as they load it.
//   Every lane of the split-K forms dequantizes its codes in registers
//   before the MMA (the scales change along k every `group` columns, so a
//   code cannot be multiplied raw and corrected afterwards as in the q8
//   kernel). X is never read past its K columns (K <= Kp): those columns
//   read as 0. Every `group` that is a multiple of 16 and divides 256 is
//   taken, so a 16-column run of codes never crosses a group.
// Known costs of the wgmma form, for later work: as in kernel 3, every row
// tile of X converts the same W stage again (8 times at M = 1024), and the
// conversion is a multiply, a subtract and a rounding per code; the rows of
// B4 that pad R up to 512 are computed, though their columns of t are 0.

#include <mma.h>

#include "gemm_sm90.cuh"
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
skinny_q4(const bf16* __restrict__ X, int Kx, Q4 W, Acc* __restrict__ acc, int M, int N,
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
tiled_q4(const bf16* __restrict__ X, int Kx, Q4 W, Acc* __restrict__ acc, int M, int N,
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
      acc_add(&acc[(size_t)(m0 + r) * N + n0 + col], cs[r * kTileCLd + col]);
  }
}

// t = round(acc) to T.
template <typename T>
__global__ void round_t(const Acc* __restrict__ acc, T* __restrict__ t, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) t[i] = from_f32<T>(acc_value(acc[i]));
}

// acc[M, N] += X[M, Kx] · dq(W)[N, 2P]ᵀ.
template <typename T>
void launch_nt(const T* X, int Kx, const Q4& W, Acc* acc, int M, int N, int P,
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
  Acc* t_acc = reinterpret_cast<Acc*>(scratch);  // [M, Rp]
  Acc* y_acc = t_acc + (size_t)M * Rp;   // [M, N]
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(Acc) * (size_t)M * (Rp + N), s);
  if (err != cudaSuccess) return (int)err;
  launch_nt<T>(x, K, B, t_acc, M, Rp, Kp / 2, s);       // acc = x · dq(B4)ᵀ
  const size_t nt = (size_t)M * Rp;
  round_t<T><<<(unsigned)((nt + 255) / 256), 256, 0, s>>>(t_acc, t, nt);
  launch_nt<T>(t, Rp, A, y_acc, M, N, Rp / 2, s);       // acc = T(t) · dq(A4)ᵀ
  const size_t total = (size_t)M * N;
  finalize_bias<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(y_acc, bias, y, M, N);
  return (int)cudaGetLastError();
}

// ---- the wgmma form ("wgmma_tiled") ----------------------------------------

constexpr int kBK = sm90::kBK;           // packed bytes of a ring stage, and the
                                         // logical columns of each of its halves
constexpr int kRowBytes = sm90::kRowBytes;

// Ring depth of gemm_nt_q4: three converted bf16 W tiles [BN][64], then as
// many (X [2][BM][64] bf16, W4 [BN][64] bytes) ring stages as fit in about
// 220 KB, at most 4 (2 at 128 x 256, 3 at 128 x 176 or 192, 4 at 128 x 128).
__host__ __device__ constexpr int q4_stages(int BM, int BN) {
  return (220 * 1024 - 3 * BN * kRowBytes) / (2 * BM * kRowBytes + BN * kBK) < 4
             ? (220 * 1024 - 3 * BN * kRowBytes) / (2 * BM * kRowBytes + BN * kBK)
             : 4;
}

__host__ __device__ constexpr size_t q4_smem_bytes(int BM, int BN) {
  return 1024 + 3 * (size_t)BN * kRowBytes
         + (size_t)q4_stages(BM, BN) * (2 * BM * kRowBytes + BN * kBK + 16);
}

// out[M, N] = round(X[M, Kx] · dq(W4)[N, 2P]ᵀ (+ bias)) in bf16, f32
// accumulation; W4 rows of P packed bytes (P a multiple of 256), sc/zs
// [N, ngrp] f32. gemm_nt (gemm_sm90.cuh) with a dequantizing converter:
//   * ring stage kt holds W4's packed bytes [64kt, 64kt + 64) of the block's
//     BN rows and X's two 64-column boxes at the logical columns of their
//     low and high nibbles, (kt/4)·512 + (kt%4)·64 and that + 256;
//   * half-step i = 2kt + h: the consumer warpgroups dequantize half h (low
//     or high nibbles) into converted buffer i % 3, a proxy fence and a
//     barrier of the consumers make it visible to wgmma, then each runs the
//     four k16 products of its 64 rows against it. Buffer i % 3 was last
//     read by the products of half-step i − 3, which both warpgroups
//     finished (wait_group 1 in half-step i − 2) before the barrier of
//     half-step i − 1;
//   * a ring stage is free once the products of its high half are done,
//     which wait_group 1 of the next half-step shows.
// TMA fills X and W4 past M, Kx and N with zeros, and converter rows past N
// take scale 0, so ragged edges add 0.
template <int NC, int BN>
__global__ void __launch_bounds__(NC * 128 + 32)
gemm_nt_q4(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w4,
           bf16* __restrict__ out, const float* __restrict__ sc, const float* __restrict__ zs,
           const bf16* __restrict__ bias, int M, int N, int P, int ngrp, int group) {
  constexpr int BM = 64 * NC, S = q4_stages(64 * NC, BN), NT = NC * 128;
  constexpr int J = (BN * 4 + NT - 1) / NT;  // 16-byte code chunks a thread converts per half
  extern __shared__ __align__(128) unsigned char q4_smem[];
  unsigned char* base = sm90::align1024(q4_smem);
  bf16* wb = reinterpret_cast<bf16*>(base);                            // [3][BN][64]
  bf16* xs = wb + 3 * (size_t)BN * kBK;                                // [S][2][BM][64]
  uint8_t* w4 = reinterpret_cast<uint8_t*>(xs + (size_t)S * 2 * BM * kBK);  // [S][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(w4 + (size_t)S * BN * kBK);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = P / kBK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * NC);  // lane 0 of every consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % S;
        if (kt >= S) sm90::mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * BM * kRowBytes + BN * kBK);
        const int col = (kt / 4) * 512 + (kt % 4) * kBK;  // the low nibbles' first column
        bf16* x0 = xs + (size_t)s * 2 * BM * kBK;
        sm90::tma_load_2d(x0, &map_x, col, m0, &full[s]);
        sm90::tma_load_2d(x0 + (size_t)BM * kBK, &map_x, col + 256, m0, &full[s]);
        sm90::tma_load_2d(w4 + (size_t)s * BN * kBK, &map_w4, kt * kBK, n0, &full[s]);
      }
    }
    return;
  }

  const int cc = threadIdx.x % 4;  // the thread's 16-byte chunk of each code row
  float acc[BN / 2];               // written first by the first products
  float scl[J][2], zsc[J][2];      // (scale, zero_scale) of the thread's rows, both halves
  for (int i = 0; i < 2 * KT; ++i) {
    const int kt = i >> 1, h = i & 1, s = kt % S;
    if (h == 0) {
      // this stage's scales, loaded before the wait for its bytes
      const int col = (kt / 4) * 512 + (kt % 4) * kBK + cc * 16;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = n0 + (threadIdx.x + j * NT) / 4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t gi = (size_t)n * ngrp + (col + hh * 256) / group;
          const bool in = n < N && threadIdx.x + j * NT < BN * 4;
          scl[j][hh] = in ? __ldg(sc + gi) : 0.f;
          zsc[j][hh] = in ? __ldg(zs + gi) : 0.f;
        }
      }
      sm90::mbar_wait(&full[s], (kt / S) & 1);
    }
    const uint8_t* src = w4 + (size_t)s * BN * kBK;
    bf16* dst = wb + (size_t)(i % 3) * BN * kBK;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int it = threadIdx.x + j * NT;
      if (it < BN * 4) {
        const int n = it / 4;
        const uint4 v = *reinterpret_cast<const uint4*>(src + n * kBK + cc * 16);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        const float sj = h ? scl[j][1] : scl[j][0], zj = h ? zsc[j][1] : zsc[j][0];
        uint32_t p[8];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          q4x4_to_bf16((h ? w[q] >> 4 : w[q]) & 0x0F0F0F0Fu, sj, zj, p[2 * q], p[2 * q + 1]);
        *reinterpret_cast<uint4*>(dst + n * kBK + (((2 * cc) ^ (n % 8)) * 8)) =
            make_uint4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<uint4*>(dst + n * kBK + (((2 * cc + 1) ^ (n % 8)) * 8)) =
            make_uint4(p[4], p[5], p[6], p[7]);
      }
    }
    sm90::fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    sm90::wgmma_fence();
    const uint64_t da = sm90::desc_sw128(xs + ((size_t)(2 * s + h) * BM + wg * 64) * kBK);
    const uint64_t db = sm90::desc_sw128(dst);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_k16<BN>(acc, sm90::desc_k(da, kk), sm90::desc_k(db, kk), i > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous half-step's products are done
    if (h == 0 && i > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % S]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  sm90::store_bias_round<NC, BN>(acc, base, out, bias, M, N, m0, n0);
}

template <int NC, int BN>
cudaError_t launch_q4_tile(const CUtensorMap& mx, const CUtensorMap& mw, bf16* out, const Q4& W,
                           const bf16* bias, int M, int N, cudaStream_t stream) {
  const size_t bytes = q4_smem_bytes(64 * NC, BN);
  const cudaError_t err = sm90::allow_smem(gemm_nt_q4<NC, BN>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 64 * NC - 1) / (64 * NC), (N + BN - 1) / BN);
  gemm_nt_q4<NC, BN><<<grid, NC * 128 + 32, bytes, stream>>>(mx, mw, out, W.sc, W.zs, bias, M,
                                                             N, W.ld, W.ngrp, W.group);
  return cudaGetLastError();
}

// out[M, N] = T(X[M, Kx] · dq(W)[N, :]ᵀ (+ bias)) through gemm_nt_q4, with
// gemm_nt's tile choice: X bf16 with Kx a multiple of 8, W's N rows of
// W.ld packed bytes (a multiple of 256), both 16-byte aligned.
cudaError_t launch_gemm_nt_q4(const bf16* X, int Kx, const Q4& W, int N, bf16* out,
                              const bf16* bias, int M, cudaStream_t stream) {
  const int NC = M >= 128 ? 2 : 1;
  const int BN = sm90::gemm_tile_n(M, N, 64 * NC);
  CUtensorMap mx, mw;
  cudaError_t err = sm90::encode_rows(&mx, X, M, Kx, 64 * NC);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)W.ld, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)W.ld};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)BN};
  err = sm90::encode_map(&mw, 2, W.w, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  switch (NC * 1000 + BN) {
    case 2256: return launch_q4_tile<2, 256>(mx, mw, out, W, bias, M, N, stream);
    case 2192: return launch_q4_tile<2, 192>(mx, mw, out, W, bias, M, N, stream);
    case 2176: return launch_q4_tile<2, 176>(mx, mw, out, W, bias, M, N, stream);
    case 2128: return launch_q4_tile<2, 128>(mx, mw, out, W, bias, M, N, stream);
    case 1256: return launch_q4_tile<1, 256>(mx, mw, out, W, bias, M, N, stream);
    case 1192: return launch_q4_tile<1, 192>(mx, mw, out, W, bias, M, N, stream);
    case 1176: return launch_q4_tile<1, 176>(mx, mw, out, W, bias, M, N, stream);
    default: return launch_q4_tile<1, 128>(mx, mw, out, W, bias, M, N, stream);
  }
}

// The wgmma form: t = T(x · dq(B4)ᵀ) into `t` [M, Rp], then
// y = T(T(t) · dq(A4)ᵀ + bias).
int run_sm90(const bf16* x, const Q4& B, const Q4& A, const bf16* bias, bf16* y, bf16* t, int M,
             int K, int Rp, int N, cudaStream_t s) {
  if (M <= kSkinnyMaxM || K % 8 != 0 || !aligned16(x) || !aligned16(B.w) || !aligned16(A.w) ||
      !aligned16(t))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_gemm_nt_q4(x, K, B, Rp, t, nullptr, M, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_nt_q4(t, Rp, A, N, y, bias, M, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [M,K] (K <= Kp) and y [M,N] of the io
// type; b4 [Rp, Kp/2] packed codes with bsc/bzs [Rp, Kp/group] f32; a4
// packed codes, N rows of Rp/2 bytes, with asc/azs [N, Rp/group] f32; bias
// [N] of the io type or null; Rp and Kp multiples of 512; group a multiple
// of 16 dividing 256. t holds M·Rp values of the io type. form: 0 = the
// split-K forms (scratch holds M·(Rp+N) 64-bit accumulators, 2·M·(Rp+N)
// f32 values, zeroed here), 1 = the
// wgmma form (bf16 only; scratch unused). Returns cudaGetLastError() after
// the launches (0 = success), cudaErrorInvalidValue for a form the shape
// does not allow.
extern "C" int fused_lowrank_q4_launch(const void* x, const void* b4, const void* bsc,
                                       const void* bzs, const void* a4, const void* asc,
                                       const void* azs, const void* bias, void* y,
                                       void* scratch, void* t, int M, int K, int Rp, int Kp,
                                       int N, int group, int form, int dtype, void* stream) {
  if (Rp % 512 != 0 || Kp % 512 != 0 || group % 16 != 0 || 256 % group != 0 || K > Kp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Q4 B{static_cast<const uint8_t*>(b4), static_cast<const float*>(bsc),
             static_cast<const float*>(bzs), Kp / 2, Kp / group, group};
  const Q4 A{static_cast<const uint8_t*>(a4), static_cast<const float*>(asc),
             static_cast<const float*>(azs), Rp / 2, Rp / group, group};
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return run_sm90(static_cast<const bf16*>(x), B, A, static_cast<const bf16*>(bias),
                    static_cast<bf16*>(y), static_cast<bf16*>(t), M, K, Rp, N, s);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
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
