// Fused low-rank linear with int8 factors for Hopper (sm_90a):
//   y = (x · dq(B8)ᵀ) · dq(A8)ᵀ + bias,  dq(W)[r, k] = scale[r]·(W8[r, k] − zero[r]).
//
// Replaces asvd4llm_tpu/ops/pallas_lowrank.py::_fused_2d_q8 (body
// `_q8_kernel`, public wrapper `fused_lowrank_apply_q8`), the decode-time
// apply of an int8-deployed SVDLinear (M <= 1024 tokens).
//
// Semantics kept from the TPU kernel:
//   * the products multiply RAW codes (int8 values are exact in bf16, and
//     bf16 x bf16 products are exact in f32), accumulated in f32 over all
//     of K;
//   * B's per-row dequantization is applied once, after the whole K sum:
//       t[m, r] = bsc[r]·acc[m, r] − (bsc[r]·bzp[r])·rowsum(x)[m];
//   * t is rounded ONCE to the io type, and stage 2's zero-point term uses
//     the row sums of that rounded t:
//       y[m, n] = asc[n]·(t·A8ᵀ)[m, n] − (asc[n]·azp[n])·rowsum(t)[m] + bias[n],
//     with one rounding to the io type at the end.
//
// What bounds it on this card: bytes at decode shapes. The codes are
// R·K + N·R bytes (half of kernel 1's bf16 factors: a Llama-2-7B q_proj at
// R = 1920 is 15.7 MB) against M·R·(K+N) multiply-adds, far below the
// ridge for M <= 16. At M = 1024 the tensor cores bound it.
//
// Forms, chosen by the wrapper (`ops/fused_lowrank_q.py::_form_q8`) and
// passed in:
//   * "wgmma_tiled" (bf16, M > 16, K and R multiples of 8, code rows
//     16-byte aligned: ldb and lda multiples of 16): two launches of
//     `sm90::gemm_nt_i8` (gemm_sm90.cuh), kernel 1's TMA-fed wgmma GEMM with
//     the int8 codes loaded by TMA next to the bf16 X stage and converted to
//     bf16 in shared memory by the consumer warpgroups (the byte permute
//     into a magic float of the decode form, written in the 128-byte
//     swizzle the wgmma descriptors expect), each stage while the tensor
//     cores run the previous one's products; one conversion of a W stage
//     serves the whole 128-row X tile. Stage 1
//     computes acc = x·B8ᵀ over all of K and rowsum(x) from the x stages it
//     streams anyway (a 64 x 8 wgmma against ones beside each product); its
//     epilogue applies B's correction and rounds t once to bf16. Stage 2
//     computes t·A8ᵀ over R and rowsum(t) of the rounded values the same
//     way, applies A's correction, adds the bias in f32 and rounds once. No
//     memset, atomics, row-sum or finishing launches. The codes reach the
//     tensor cores as bf16, where they are exact.
//   * The split-K forms, for everything else: kernel 1's earlier design
//     (fused_lowrank.cu) with the dequantization moved out of the products.
//     Split-K partial sums meet in a zeroed scratch of fixed-point
//     accumulators (lrq::Acc: integer atomics, the same bits whatever order
//     the blocks finish in), so the B correction and the rounding of t
//     cannot happen per split: they run in a small launch (`finish_t`) that
//     reads the finished sums,
//     writes the rounded t and its row sums. rowsum(x) is its own small
//     launch over all of K. Both spread each row over many blocks. The A
//     correction and the bias run in the finishing launch. The products:
//     - "mma_skinny" (bf16, M <= 16, `skinny_i8`): mma.sync m16n8k16 with the operands
//       swapped (16 W rows on the MMA's 16-row side). A lane's 16-byte load
//       holds 16 codes of one row (not 8 bf16 values): it converts them in
//       registers to eight bf16 pairs (a byte permute into a magic float,
//       one subtract, one pack) and feeds four MMAs; X is read from shared
//       memory at the same 16 columns, so W and X see one permutation of k.
//     - "wmma_tiled" (bf16, M > 16, ranks or code rows the wgmma form does
//       not take): 64 x 64 output tiles on WMMA, 64-deep stages; the codes
//       are converted to bf16 on their way into shared memory.
//     - "cuda_cores" (f32, and bf16 shapes whose code rows are not 16-byte
//       aligned or whose K is not a multiple of 16): the CUDA-core forms of
//       lowrank_common.cuh.
// Known costs of the wgmma form, for later work: the conversion sets its
// time (every row tile of x converts the same W stage again, 8 times at
// M = 1024, and its 48 KB of shared-memory traffic a stage at 128 x 256 come
// on top of the products' own); three converter warps running stages ahead
// of the consumers were slower. A register-sourced A operand (W·xᵀ, the
// codes converted straight into wgmma's A registers) would drop the
// converted tile's stores, but rowsum(x) would then leave the tensor cores.

#include <mma.h>

#include "gemm_sm90.cuh"
#include "lowrank_common.cuh"

namespace {

using namespace lrq;

// acc[M, N] += X[M, K] · W8[N, K]ᵀ over the K chunk of this blockIdx.y, for
// M <= 16, bf16 X, K % 16 == 0 and 16-byte aligned code rows.
//
// Lane (g = lane / 4, t = lane % 4) of the warp owning W rows r0..r0+15
// loads rows r0 + g and r0 + g + 8 at columns 16t..16t+15 of each 64-wide
// block. Pair p (p = 0..7) of those 16 codes is physical column 16t + 2p;
// MMA s (s = 0..3) takes pairs 2s and 2s + 1 as its logical columns
// {2t, 2t+1} and {2t+8, 2t+9}, and the lane's X fragment is the same
// physical columns of X, so both operands see one permutation of k.
__global__ void __launch_bounds__(kSkinnyWarps * 32)
skinny_i8(const bf16* __restrict__ X, const int8_t* __restrict__ W, int ldw,
          Acc* __restrict__ acc, int M, int N, int K, int k_chunk, bool xvec) {
  __shared__ __align__(16) bf16 xs[16 * kSkinnyLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * kSkinnyRows + warp * 16 + g;  // and row + 8
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int m_tiles = M > 8 ? 2 : 1;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float c[2][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kSkinnySub) {
    const int kn = min(kSkinnySub, k_end - k0);  // a multiple of 16
    uint4 lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = i * 64 + t * 16;
      lo[i] = (row < N && k < kn) ? ld16(W + (size_t)row * ldw + k0 + k) : zero;
      hi[i] = (row + 8 < N && k < kn) ? ld16(W + (size_t)(row + 8) * ldw + k0 + k) : zero;
    }
    __syncthreads();  // the previous pass is done with xs
    for (int i = threadIdx.x; i < 16 * (kSkinnySub / 8); i += blockDim.x) {
      const int m = i / (kSkinnySub / 8), k = (i % (kSkinnySub / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + m * kSkinnyLd + k) =
          (m < M && k < kn) ? load_x8(X, m, k0 + k, K, xvec) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i * 64 >= kn) break;
      uint32_t a[8], b[8];
      i8x4_to_bf16(lo[i].x, a[0], a[1]);
      i8x4_to_bf16(lo[i].y, a[2], a[3]);
      i8x4_to_bf16(lo[i].z, a[4], a[5]);
      i8x4_to_bf16(lo[i].w, a[6], a[7]);
      i8x4_to_bf16(hi[i].x, b[0], b[1]);
      i8x4_to_bf16(hi[i].y, b[2], b[3]);
      i8x4_to_bf16(hi[i].z, b[4], b[5]);
      i8x4_to_bf16(hi[i].w, b[6], b[7]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < m_tiles) {
          const bf16* xr = xs + (mt * 8 + g) * kSkinnyLd + i * 64 + t * 16;
          const uint4 x0 = ld16(xr), x1 = ld16(xr + 8);
          mma16816(c[mt], a[0], b[0], a[1], b[1], x0.x, x0.y);
          mma16816(c[mt], a[2], b[2], a[3], b[3], x0.z, x0.w);
          mma16816(c[mt], a[4], b[4], a[5], b[5], x1.x, x1.y);
          mma16816(c[mt], a[6], b[6], a[7], b[7], x1.z, x1.w);
        }
      }
    }
  }
  skinny_store(c, acc, row, t, m_tiles, M, N);
}

// The same product for M > 16: a 64 x 64 output tile per block, warp w
// computing rows 32·(w/2).. and columns 32·(w%2).. as 2 x 2 WMMA fragments.
__global__ void __launch_bounds__(128)
wmma_tiled(const bf16* __restrict__ X, const int8_t* __restrict__ W, int ldw,
         Acc* __restrict__ acc, int M, int N, int K, int k_chunk, bool xvec) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 xs[kTile * kTileLd];
  __shared__ __align__(32) bf16 ws[kTile * kTileLd];
  __shared__ __align__(32) float cs[kTile * kTileCLd];
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * (kTileK / 8); i += blockDim.x) {
      const int r = i / (kTileK / 8), k = (i % (kTileK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + r * kTileLd + k) =
          (m0 + r < M && k0 + k < k_end) ? load_x8(X, m0 + r, k0 + k, K, xvec) : zero;
    }
    for (int i = threadIdx.x; i < kTile * (kTileK / 16); i += blockDim.x) {
      const int r = i / (kTileK / 16), k = (i % (kTileK / 16)) * 16;
      const uint4 v = (n0 + r < N && k0 + k < k_end)
                          ? ld16(W + (size_t)(n0 + r) * ldw + k0 + k) : zero;
      uint4 p0, p1;
      i8x4_to_bf16(v.x, p0.x, p0.y);
      i8x4_to_bf16(v.y, p0.z, p0.w);
      i8x4_to_bf16(v.z, p1.x, p1.y);
      i8x4_to_bf16(v.w, p1.z, p1.w);
      *reinterpret_cast<uint4*>(ws + r * kTileLd + k) = p0;
      *reinterpret_cast<uint4*>(ws + r * kTileLd + k + 8) = p1;
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

// The two small launches below run on a (chunk, row) grid with one atomic
// per block: a grid of only M blocks (one per row) took 4-18 us at decode
// shapes, as long as a product stage.
constexpr int kSumThreads = 256;
constexpr int kSumPerThread = 8;

// sums[m] += Σ_k x[m, k] in f32 over this block's chunk of K (sums zeroed).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
row_sums(const T* __restrict__ x, Acc* __restrict__ sums, int K) {
  const T* row = x + (size_t)blockIdx.y * K;
  const int k0 = blockIdx.x * kSumThreads * kSumPerThread + threadIdx.x;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < kSumPerThread; ++i) {
    const int k = k0 + i * kSumThreads;
    if (k < K) v += to_f32(row[k]);
  }
  v = block_sum(v);
  if (threadIdx.x == 0) acc_add(&sums[blockIdx.y], v);
}

// t = bsc·acc − (bsc·bzp)·xsum, rounded once to T, for one r per thread;
// tsum[m] += Σ_r t over the block (tsum zeroed).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
finish_t(const Acc* __restrict__ acc, const Acc* __restrict__ xsum,
         const float* __restrict__ bsc, const float* __restrict__ bzp, T* __restrict__ t,
         Acc* __restrict__ tsum, int R) {
  const int m = blockIdx.y, r = blockIdx.x * kSumThreads + threadIdx.x;
  float v = 0.f;
  if (r < R) {
    const size_t i = (size_t)m * R + r;
    const T q = from_f32<T>(acc_value(acc[i]) * bsc[r] - acc_value(xsum[m]) * (bsc[r] * bzp[r]));
    t[i] = q;
    v = to_f32(q);
  }
  v = block_sum(v);
  if (threadIdx.x == 0) acc_add(&tsum[m], v);
}

// y = round(asc·acc − (asc·azp)·tsum + bias); bias may be null.
template <typename T>
__global__ void finish_y(const Acc* __restrict__ acc, const Acc* __restrict__ tsum,
                         const float* __restrict__ asc, const float* __restrict__ azp,
                         const T* __restrict__ bias, T* __restrict__ y, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float v = acc_value(acc[i]) * asc[n] - acc_value(tsum[m]) * (asc[n] * azp[n]);
  if (bias != nullptr) v += to_f32(bias[n]);
  y[i] = from_f32<T>(v);
}

// acc[M, N] += X[M, K] · W8[N, K]ᵀ (raw codes, W8 rows `ldw` apart).
template <typename T>
void launch_nt(const T* X, const int8_t* W, int ldw, Acc* acc, int M, int N, int K,
               cudaStream_t s) {
  const bool tensor_cores = sizeof(T) == 2 && K % 16 == 0 && ldw % 16 == 0 && aligned16(W);
  if (!tensor_cores) {
    launch_cuda_cores<T>(X, K, DecI8{W, ldw}, acc, M, N, K, s);
    return;
  }
  const bf16* Xb = reinterpret_cast<const bf16*>(X);
  const bool xvec = K % 8 == 0 && aligned16(X);
  if (M <= kSkinnyMaxM) {
    const int rows = cdiv(N, kSkinnyRows);
    const int k_chunk = k_chunk_for(K, rows, 4, kSkinnySub, 1);
    skinny_i8<<<dim3(rows, cdiv(K, k_chunk)), kSkinnyWarps * 32, 0, s>>>(
        Xb, W, ldw, acc, M, N, K, k_chunk, xvec);
    return;
  }
  const int base = cdiv(N, kTile) * cdiv(M, kTile);
  const int k_chunk = k_chunk_for(K, base, 2, kTileK, 4);
  wmma_tiled<<<dim3(cdiv(N, kTile), cdiv(M, kTile), cdiv(K, k_chunk)), 128, 0, s>>>(
      Xb, W, ldw, acc, M, N, K, k_chunk, xvec);
}

template <typename T>
int run(const T* x, const int8_t* b8, const float* bsc, const float* bzp, const int8_t* a8,
        const float* asc, const float* azp, const T* bias, T* y, float* scratch, T* t, int M,
        int K, int R, int N, int ldb, int lda, cudaStream_t s) {
  Acc* t_acc = reinterpret_cast<Acc*>(scratch);  // [M, R]
  Acc* y_acc = t_acc + (size_t)M * R;    // [M, N]
  Acc* xsum = y_acc + (size_t)M * N;     // [M]
  Acc* tsum = xsum + M;                  // [M]
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(Acc) * (size_t)M * (R + N + 2), s);
  if (err != cudaSuccess) return (int)err;
  row_sums<T><<<dim3(cdiv(K, kSumThreads * kSumPerThread), M), kSumThreads, 0, s>>>(x, xsum, K);
  launch_nt<T>(x, b8, ldb, t_acc, M, R, K, s);             // acc = x · B8ᵀ
  finish_t<T><<<dim3(cdiv(R, kSumThreads), M), kSumThreads, 0, s>>>(t_acc, xsum, bsc, bzp, t,
                                                                  tsum, R);
  launch_nt<T>(t, a8, lda, y_acc, M, N, R, s);             // acc = T(t) · A8ᵀ
  const size_t total = (size_t)M * N;
  finish_y<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(y_acc, tsum, asc, azp, bias, y,
                                                              M, N);
  return (int)cudaGetLastError();
}

// Sixteen int8 codes as sixteen bf16 values, exactly (gemm_nt_i8's Cvt):
// each code through the magic float of i8x4_to_bf16, then the high halves
// of two floats packed by one byte permute (an integer of magnitude <= 128
// has no f32 mantissa bits below bf16's, so truncation is exact).
struct CodesToBf16 {
  __device__ __forceinline__ static void four(uint32_t w, uint32_t& p01, uint32_t& p23) {
    const uint32_t u = w ^ 0x80808080u;
    const float off = 8388608.f + 128.f;
    const uint32_t f0 = __float_as_uint(byte_magic(u, 0) - off);
    const uint32_t f1 = __float_as_uint(byte_magic(u, 1) - off);
    const uint32_t f2 = __float_as_uint(byte_magic(u, 2) - off);
    const uint32_t f3 = __float_as_uint(byte_magic(u, 3) - off);
    p01 = __byte_perm(f0, f1, 0x7632);
    p23 = __byte_perm(f2, f3, 0x7632);
  }
  __device__ __forceinline__ void operator()(uint4 v, uint4& lo, uint4& hi) const {
    four(v.x, lo.x, lo.y);
    four(v.y, lo.z, lo.w);
    four(v.z, hi.x, hi.y);
    four(v.w, hi.z, hi.w);
  }
};

// The wgmma form: t = T(bsc·(x·B8ᵀ) − bsc·bzp·rowsum(x)) into `t` [M, R],
// then y = T(asc·(t·A8ᵀ) − asc·azp·rowsum(t) + bias).
int run_sm90(const bf16* x, const int8_t* b8, const float* bsc, const float* bzp,
             const int8_t* a8, const float* asc, const float* azp, const bf16* bias, bf16* y,
             bf16* t, int M, int K, int R, int N, int ldb, int lda, cudaStream_t s) {
  if (M <= kSkinnyMaxM || K % 8 != 0 || R % 8 != 0 || ldb % 16 != 0 || lda % 16 != 0 ||
      !aligned16(x) || !aligned16(b8) || !aligned16(a8) || !aligned16(t))
    return (int)cudaErrorInvalidValue;
  const auto* B8 = reinterpret_cast<const uint8_t*>(b8);
  const auto* A8 = reinterpret_cast<const uint8_t*>(a8);
  cudaError_t err =
      sm90::launch_gemm_nt_i8<CodesToBf16>(x, B8, ldb, t, bsc, bzp, nullptr, M, R, K, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sm90::launch_gemm_nt_i8<CodesToBf16>(t, A8, lda, y, asc, azp, bias, M, N, R, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [M,K] and y [M,N] of the io type;
// b8 int8 codes, R rows `ldb` apart (ldb >= K), bsc/bzp [R] f32; a8 int8
// codes, N rows `lda` apart (lda >= R), asc/azp [N] f32; bias [N] of the io
// type or null; t holds M·R values of the io type. form: 0 = the split-K
// forms (scratch holds M·(R+N+2) 64-bit accumulators, 2·M·(R+N+2) f32
// values, zeroed here), 1 = the wgmma
// form (bf16 only; scratch unused). Returns cudaGetLastError() after the
// launches (0 = success), cudaErrorInvalidValue for a form the shape does
// not allow.
extern "C" int fused_lowrank_q8_launch(const void* x, const void* b8, const void* bsc,
                                       const void* bzp, const void* a8, const void* asc,
                                       const void* azp, const void* bias, void* y,
                                       void* scratch, void* t, int M, int K, int R, int N,
                                       int ldb, int lda, int form, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return run_sm90(static_cast<const bf16*>(x), static_cast<const int8_t*>(b8),
                    static_cast<const float*>(bsc), static_cast<const float*>(bzp),
                    static_cast<const int8_t*>(a8), static_cast<const float*>(asc),
                    static_cast<const float*>(azp), static_cast<const bf16*>(bias),
                    static_cast<bf16*>(y), static_cast<bf16*>(t), M, K, R, N, ldb, lda, s);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  const auto* B8 = static_cast<const int8_t*>(b8);
  const auto* A8 = static_cast<const int8_t*>(a8);
  const auto* Bsc = static_cast<const float*>(bsc);
  const auto* Bzp = static_cast<const float*>(bzp);
  const auto* Asc = static_cast<const float*>(asc);
  const auto* Azp = static_cast<const float*>(azp);
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(x), B8, Bsc, Bzp, A8, Asc, Azp,
                      static_cast<const float*>(bias), static_cast<float*>(y), scr,
                      static_cast<float*>(t), M, K, R, N, ldb, lda, s);
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(x), B8, Bsc, Bzp, A8, Asc, Azp,
                     static_cast<const bf16*>(bias), static_cast<bf16*>(y), scr,
                     static_cast<bf16*>(t), M, K, R, N, ldb, lda, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_lowrank_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
