// Fused low-rank linear for Hopper (sm_90a): y = (x · Bᵀ) · Aᵀ + bias.
//
// Replaces asvd4llm_tpu/ops/pallas_lowrank.py::_fused_2d (body `_kernel`,
// public wrapper `fused_lowrank_apply`), SVDLinear's forward at decode and
// PPL-window shapes (M <= 1024 tokens).
//
// Semantics kept from the TPU kernel:
//   t = x · Bᵀ accumulated in f32;
//   t is rounded ONCE to A's type before the second product (`_kernel:87`);
//   y = t · Aᵀ accumulated in f32, bias (already in the io type) added in
//   f32, one rounding to the io type at the end.
//
// What bounds it on this card: bytes at decode shapes. The factors are
// R·K + N·R elements (a Llama-2-7B q_proj at R=1920 is ~31.5 MB of bf16)
// against M·R·(K+N) multiply-adds, far below the ~295 FLOP/byte ridge for
// M <= 16, so what matters there is streaming A and B once at full rate.
// At M = 1024 the products are above the ridge and the tensor cores bound
// it (q_proj: 32.2 GFLOP, 32.6 us at 989 TFLOP/s).
//
// Forms, chosen by the wrapper (`ops/fused_lowrank.py::_form`) and passed in:
//   * "wgmma_tiled" (bf16, M > 16, K and R multiples of 8, 16-byte aligned
//     operands): two launches of `sm90::gemm_nt` (gemm_sm90.cuh), a
//     TMA-fed wgmma GEMM with a 4- to 6-stage ring, output tiles of 128
//     rows (64 below M = 128) and 128, 176, 192 or 256 columns (whichever
//     ends its last wave first), one producer warp and one or two consumer
//     warpgroups, the row tiles of one weight tile side by side in the grid
//     so that the weight streams through L2 once. Stage 1 writes t already rounded to bf16 (half the bytes of
//     an f32 t, and exactly the TPU kernel's `t_acc.astype(a.dtype)`);
//     stage 2 adds the bias in f32 and rounds once. No split over K, no
//     atomics, no memset, no finishing launch: at q_proj M=1024 the two
//     stages have 120 tiles of 128 x 128 and 128 of 128 x 256 for 132 SMs.
//   * The split-K forms, for everything else, in two NT products
//     C[M, N] += X[M, K] · W[N, K]ᵀ split over K across the grid, the
//     partial sums meeting in one zeroed scratch of 64-bit fixed-point
//     accumulators (lrq::Acc: integer atomics, so the sums do not depend on
//     the order the blocks finish in and a decode is reproducible bit for
//     bit), t, then y, and a last small launch adding the bias and
//     rounding; stage 2 reads t's accumulators and rounds each to A's type
//     as it loads it:
//     - "mma_skinny" (bf16, M <= 16, aligned): mma.sync m16n8k16 with the
//       operands swapped, so 16 rows of W fill the MMA's 16-row side and
//       the few rows of X its 8-wide side. Each lane loads 16 bytes of two
//       W rows straight into registers as its A fragment: the k order inside
//       a 32-wide block is permuted identically for W and X, which a dot
//       product allows. X is staged in shared memory as bf16. At decode
//       shapes it is at parity with cuBLAS.
//     - "wmma_tiled" (bf16, M > 16, K aligned but R not a multiple of 8,
//       e.g. the KV-target ranks 819/409): stage 1 on 64 x 64 WMMA tiles,
//       stage 2 on the CUDA cores.
//     - "cuda_cores" (f32, and bf16 rows that are not 16-byte aligned):
//       `gemv_splitk` for M <= 16, `nt_gemm_splitk` above, since the tensor
//       cores would round f32 inputs to TF32.
//   The products of two bf16 values are exact in f32, so the tensor-core
//   forms differ from the plain version only in the order of the sums.
// Known costs of the wgmma form, for later work: the epilogue stores
// 4-byte pairs straight from the accumulators (rows of 16 bytes per warp
// instruction) and does not overlap the next tile's loads (one block per
// SM, no persistent tile loop); a stage whose tiles do not divide into
// whole waves idles SMs in its last one (no stream-K); below M ~ 512 the
// grid does not fill the card (no split over K).

#include <mma.h>

#include "gemm_sm90.cuh"
#include "lowrank_common.cuh"

namespace {

using lrq::Acc;
using lrq::acc_add;
using lrq::aligned16;
using lrq::cdiv;
using lrq::from_f32;
using lrq::k_chunk_for;
using lrq::mma16816;
using lrq::pack_bf16;
using lrq::to_f32;
using lrq::warp_sum;

constexpr int kGemvMaxM = 16;  // M at or below it takes the decode forms

// X's value rounded to W's type (the identity where the types agree; stage
// 2 of a bf16 call reads the f32 t and must see `t.astype(a.dtype)`).
template <typename TW, typename TX>
__device__ __forceinline__ float x_as_w(TX v) { return to_f32(from_f32<TW>(to_f32(v))); }

// ------------------------------------------------------- tensor-core forms

// Eight consecutive values at p as eight bf16 in 16 bytes; f32 values are
// rounded to nearest even.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8_bf16(const Acc* p) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const ulonglong2 a = reinterpret_cast<const ulonglong2*>(p)[i];
    v[2 * i] = lrq::acc_value(a.x);
    v[2 * i + 1] = lrq::acc_value(a.y);
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

constexpr int kSkinnyWarps = 4;                 // each warp owns 16 rows of W
constexpr int kSkinnyRows = kSkinnyWarps * 16;  // W rows per block
constexpr int kSkinnySub = 256;                 // K per pass (8 blocks of 32)
constexpr int kSkinnyLd = kSkinnySub + 32;      // xs row stride: 576 bytes, so the
                                                // two rows one 8-lane phase reads
                                                // fall on different banks

// acc[M, N] += X[M, K] · W[N, K]ᵀ over the K chunk of this blockIdx.y, for
// M <= 16, bf16 W, K % 8 == 0 and 16-byte aligned rows.
//
// Lane (g = lane / 4, t = lane % 4) of a warp owning W rows r0..r0+15 loads
// W[r0 + g] and W[r0 + g + 8] at columns 8t..8t+7 of each 32-wide block.
// Those 8 values are the lane's logical A-fragment columns {2t, 2t+1,
// 2t+8, 2t+9} of two m16n8k16 steps; the lane's B fragment (X row g, the
// same logical columns) is the same 8 columns of X, so both operands see one
// permutation of k.
template <typename TX>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
mma_skinny(const TX* __restrict__ X, const __nv_bfloat16* __restrict__ W,
           Acc* __restrict__ acc, int M, int N, int K, int k_chunk) {
  __shared__ __align__(16) __nv_bfloat16 xs[16 * kSkinnyLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x * kSkinnyRows + warp * 16 + g;  // and row + 8
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int m_tiles = M > 8 ? 2 : 1;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float c[2][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kSkinnySub) {
    const int kn = min(kSkinnySub, k_end - k0);  // a multiple of 8
    // the warp's share of W is requested before X is staged
    uint4 lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = i * 32 + t * 8;
      lo[i] = (row < N && k < kn) ? load8_bf16(W + (size_t)row * K + k0 + k) : zero;
      hi[i] = (row + 8 < N && k < kn) ? load8_bf16(W + (size_t)(row + 8) * K + k0 + k) : zero;
    }
    __syncthreads();  // the previous pass is done with xs
    for (int i = threadIdx.x; i < 16 * (kSkinnySub / 8); i += blockDim.x) {
      const int m = i / (kSkinnySub / 8), k = (i % (kSkinnySub / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + m * kSkinnyLd + k) =
          (m < M && k < kn) ? load8_bf16(X + (size_t)m * K + k0 + k) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i * 32 >= kn) break;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < m_tiles) {
          const uint4 xv = *reinterpret_cast<const uint4*>(
              xs + (mt * 8 + g) * kSkinnyLd + i * 32 + t * 8);
          mma16816(c[mt], lo[i].x, hi[i].x, lo[i].y, hi[i].y, xv.x, xv.y);
          mma16816(c[mt], lo[i].z, hi[i].z, lo[i].w, hi[i].w, xv.z, xv.w);
        }
      }
    }
  }
  // c[mt][j]: W row `row` (+8 for j >= 2), X row mt*8 + 2t + (j & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = row + (j >= 2 ? 8 : 0);
      const int m = mt * 8 + 2 * t + (j & 1);
      if (mt < m_tiles && m < M && n < N) acc_add(&acc[(size_t)m * N + n], c[mt][j]);
    }
}

constexpr int kTile = 64;             // output rows and columns per block
constexpr int kTileK = 32;            // reduction depth per stage
constexpr int kTileLd = kTileK + 8;   // bf16 stage row stride (WMMA: multiple of 8)
constexpr int kTileCLd = kTile + 4;   // f32 epilogue row stride

// The same product for M > 16 (bf16 W, K % 8 == 0, 16-byte aligned rows):
// a 64 x 64 output tile per block, warp w computing rows 32·(w/2).. and
// columns 32·(w%2).. as 2 x 2 WMMA fragments.
template <typename TX>
__global__ void __launch_bounds__(128)
wmma_tiled(const TX* __restrict__ X, const __nv_bfloat16* __restrict__ W,
           Acc* __restrict__ acc, int M, int N, int K, int k_chunk) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[kTile * kTileLd];
  __shared__ __align__(32) __nv_bfloat16 ws[kTile * kTileLd];
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
      const bool kin = k0 + k < k_end;
      *reinterpret_cast<uint4*>(xs + r * kTileLd + k) =
          (m0 + r < M && kin) ? load8_bf16(X + (size_t)(m0 + r) * K + k0 + k) : zero;
      *reinterpret_cast<uint4*>(ws + r * kTileLd + k) =
          (n0 + r < N && kin) ? load8_bf16(W + (size_t)(n0 + r) * K + k0 + k) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
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

// --------------------------------------------------------- CUDA-core forms

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 32;        // reduction depth per shared-memory stage
constexpr int kBN = 64;        // output columns per block

// acc[M, N] += X[M, K] · W[N, K]ᵀ over the K slice of this blockIdx.z: a
// 16x16-thread block computes a BM x 64 output tile.
template <typename TX, typename TW, int BM>
__global__ void __launch_bounds__(kThreads)
nt_gemm_splitk(const TX* __restrict__ X, const TW* __restrict__ W,
               Acc* __restrict__ acc, int M, int N, int K, int k_chunk) {
  constexpr int TM = BM / 16;
  constexpr int TN = kBN / 16;
  __shared__ float xs[kBK][BM + 1];
  __shared__ float ws[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float c[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < k_end) ? x_as_w<TW>(X[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int n = n0 + r, k = k0 + kk;
      ws[kk][r] = (n < N && k < k_end) ? to_f32(W[(size_t)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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

// M <= kGemvMaxM: the X chunk sits in shared memory as f32; each warp
// streams kGemvRows rows of W at once with VEC-wide loads (16 bytes a lane
// where the layout allows), so every X value read from shared memory serves
// kGemvRows rows. Lane partial sums meet in a warp reduction and one
// accumulator add per (m, n).
constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 4;                       // W rows per warp pass
constexpr int kGemvBlockRows = kGemvWarps * kGemvRows;
constexpr int kGemvChunk = 512;                    // K per block (x: M·2 KB of smem)

// VEC consecutive values of T held in registers as loaded, widened to f32
// on use.
template <int VEC, typename T> struct Slot;
template <> struct Slot<4, float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  }
};
template <typename T> struct Slot<1, T> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ void zero() { raw = from_f32<T>(0.f); }
  __device__ __forceinline__ void get(float* out) const { out[0] = to_f32(raw); }
};

template <typename TX, typename TW, int MM, int VEC>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_splitk(const TX* __restrict__ X, const TW* __restrict__ W,
            Acc* __restrict__ acc, int M, int N, int K) {
  constexpr int IT = kGemvChunk / (32 * VEC);  // lane passes over a chunk
  __shared__ float xs[MM * kGemvChunk];
  const int k0 = blockIdx.y * kGemvChunk;
  const int kn = min(kGemvChunk, K - k0);      // kn % VEC == 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kGemvBlockRows + warp * kGemvRows;

  // The warp's whole share of W for this chunk is requested before X is
  // staged, so the two memory round trips overlap.
  Slot<VEC, TW> w[IT][kGemvRows];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int k = (it * 32 + lane) * VEC;
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      if (n0 + r < N && k < kn) w[it][r].load(W + (size_t)(n0 + r) * K + k0 + k);
      else w[it][r].zero();
    }
  }
  for (int i = threadIdx.x; i < M * kn; i += blockDim.x) {
    const int m = i / kn, k = i - m * kn;
    xs[m * kGemvChunk + k] = x_as_w<TW>(X[(size_t)m * K + k0 + k]);
  }
  __syncthreads();

  float s[kGemvRows][MM];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < MM; ++m) s[r][m] = 0.f;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int k = (it * 32 + lane) * VEC;
    if (k >= kn) break;
    float wf[kGemvRows][VEC];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) w[it][r].get(wf[r]);
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (m < M) {
        float xv[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) xv[v] = xs[m * kGemvChunk + k + v];
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) s[r][m] = fmaf(wf[r][v], xv[v], s[r][m]);
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

// ---------------------------------------------------------------- launches

template <typename TX, typename TW, int MM, int VEC>
void launch_gemv_mm(const TX* X, const TW* W, Acc* acc, int M, int N, int K,
                    cudaStream_t stream) {
  const dim3 grid(cdiv(N, kGemvBlockRows), cdiv(K, kGemvChunk));
  gemv_splitk<TX, TW, MM, VEC><<<grid, kGemvWarps * 32, 0, stream>>>(X, W, acc, M, N, K);
}

template <typename TX, typename TW, int VEC>
void launch_gemv(const TX* X, const TW* W, Acc* acc, int M, int N, int K,
                 cudaStream_t stream) {
  if (M <= 1) launch_gemv_mm<TX, TW, 1, VEC>(X, W, acc, M, N, K, stream);
  else if (M <= 2) launch_gemv_mm<TX, TW, 2, VEC>(X, W, acc, M, N, K, stream);
  else if (M <= 4) launch_gemv_mm<TX, TW, 4, VEC>(X, W, acc, M, N, K, stream);
  else if (M <= 8) launch_gemv_mm<TX, TW, 8, VEC>(X, W, acc, M, N, K, stream);
  else launch_gemv_mm<TX, TW, 16, VEC>(X, W, acc, M, N, K, stream);
}

// acc[M, N] += X · Wᵀ on the CUDA cores (f32 W).
template <typename TX>
void launch_nt(const TX* X, const float* W, Acc* acc, int M, int N, int K,
               cudaStream_t stream) {
  if (M <= kGemvMaxM) {
    if (K % 4 == 0 && aligned16(W)) launch_gemv<TX, float, 4>(X, W, acc, M, N, K, stream);
    else launch_gemv<TX, float, 1>(X, W, acc, M, N, K, stream);
    return;
  }
  const int base = cdiv(N, kBN) * cdiv(M, 64);
  const int k_chunk = k_chunk_for(K, base, 2, kBK, 4);
  const dim3 grid(cdiv(N, kBN), cdiv(M, 64), cdiv(K, k_chunk));
  nt_gemm_splitk<TX, float, 64><<<grid, kThreads, 0, stream>>>(X, W, acc, M, N, K, k_chunk);
}

// acc[M, N] += X · Wᵀ for bf16 W: on the tensor cores where every row of X
// and W starts 16-byte aligned, on the CUDA cores otherwise.
template <typename TX>
void launch_nt(const TX* X, const __nv_bfloat16* W, Acc* acc, int M, int N, int K,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (K % 8 != 0 || !aligned16(W) || !aligned16(X)) {
    if (M <= kGemvMaxM) {
      launch_gemv<TX, bf16, 1>(X, W, acc, M, N, K, stream);
      return;
    }
    const int base = cdiv(N, kBN) * cdiv(M, 64);
    const int k_chunk = k_chunk_for(K, base, 2, kBK, 4);
    const dim3 grid(cdiv(N, kBN), cdiv(M, 64), cdiv(K, k_chunk));
    nt_gemm_splitk<TX, bf16, 64><<<grid, kThreads, 0, stream>>>(X, W, acc, M, N, K, k_chunk);
    return;
  }
  if (M <= kGemvMaxM) {
    const int rows = cdiv(N, kSkinnyRows);
    const int k_chunk = k_chunk_for(K, rows, 4, kSkinnySub, 1);
    mma_skinny<TX><<<dim3(rows, cdiv(K, k_chunk)), kSkinnyWarps * 32, 0, stream>>>(
        X, W, acc, M, N, K, k_chunk);
    return;
  }
  const int base = cdiv(N, kTile) * cdiv(M, kTile);
  const int k_chunk = k_chunk_for(K, base, 2, kTileK, 4);
  const dim3 grid(cdiv(N, kTile), cdiv(M, kTile), cdiv(K, k_chunk));
  wmma_tiled<TX><<<grid, 128, 0, stream>>>(X, W, acc, M, N, K, k_chunk);
}

template <typename T>
int run(const T* x, const T* b, const T* a, const T* bias, T* y, float* scratch, int M,
        int K, int R, int N, cudaStream_t stream) {
  Acc* t = reinterpret_cast<Acc*>(scratch);  // [M, R]
  Acc* y_acc = t + (size_t)M * R;            // [M, N]
  cudaError_t err = cudaMemsetAsync(t, 0, sizeof(Acc) * (size_t)M * (R + N), stream);
  if (err != cudaSuccess) return (int)err;
  launch_nt<T>(x, b, t, M, R, K, stream);        // t = x · Bᵀ
  launch_nt<Acc>(t, a, y_acc, M, N, R, stream);  // y = T(t) · Aᵀ
  const size_t total = (size_t)M * N;
  lrq::finalize_bias<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(y_acc, bias, y,
                                                                            M, N);
  return (int)cudaGetLastError();
}

// The wgmma form: t = T(x · Bᵀ) into `t_bf16` [M, R], then y = T(t · Aᵀ + bias).
int run_sm90(const __nv_bfloat16* x, const __nv_bfloat16* b, const __nv_bfloat16* a,
             const __nv_bfloat16* bias, __nv_bfloat16* y, __nv_bfloat16* t, int M, int K, int R,
             int N, cudaStream_t stream) {
  if (M <= kGemvMaxM || K % 8 != 0 || R % 8 != 0 || !aligned16(x) || !aligned16(b) ||
      !aligned16(a) || !aligned16(t))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* no_bias = nullptr;
  cudaError_t err = sm90::launch_gemm_nt(x, b, t, no_bias, M, R, K, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)sm90::launch_gemm_nt(t, a, y, bias, M, N, R, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [M,K], b [R,K], a [N,R], bias [N] or
// null, y [M,N] of the io type. form: 0 = the split-K forms (scratch holds
// M·(R+N) 64-bit accumulators, 2·M·(R+N) f32 values, 16-byte aligned), 1 =
// the wgmma form (bf16 only; scratch holds the
// bf16 t [M, R]). Returns cudaGetLastError() after the launches (0 =
// success), cudaErrorInvalidValue for a form the shape does not allow.
extern "C" int fused_lowrank_launch(const void* x, const void* b, const void* a,
                                    const void* bias, void* y, void* scratch, int M, int K,
                                    int R, int N, int dtype, int form, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return run_sm90(static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                    static_cast<const bf16*>(a), static_cast<const bf16*>(bias),
                    static_cast<bf16*>(y), static_cast<bf16*>(scratch), M, K, R, N, s);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(x), static_cast<const float*>(b),
                      static_cast<const float*>(a), static_cast<const float*>(bias),
                      static_cast<float*>(y), scr, M, K, R, N, s);
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                     static_cast<const bf16*>(a), static_cast<const bf16*>(bias),
                     static_cast<bf16*>(y), scr, M, K, R, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_lowrank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
