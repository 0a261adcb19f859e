// Latent-KV flash-decoding attention for Hopper (sm_90a).
//
// Replaces asvd4llm_tpu/ops/pallas_latent_attention.py::_latent_attention_core
// (bodies `_kernel` and `_online_tile`, public wrapper
// `latent_decode_attention`): one decode step of a layer whose k and v
// projections are low-rank and whose cache holds the rank-dim latents
// tk [B,T,Rk] and tv [B,T,Rv] instead of K and V.
//
// Per T tile, for every query head h of KV group g:
//   K     = tk_tile · A_k[g]ᵀ                (f32 accumulate, not re-rounded)
//   K     = rotate-half RoPE(K) with f32 cos/sin rows
//   l     = scale · q_h · K (+ tanh softcap), causal/sliding mask → -1e30
//   online softmax: m' = max(m, max l), c = exp(m - m'), p = exp(l - m'),
//                   den = den·c + Σp
//   s_h   = s_h·c + Σ_t T(p_t) · tv_t        (p rounded to tv's type, f32 sum)
// and at the end writes s_h / den as [B,H,Rv] f32. The A_v up-projection and
// the v bias stay in the wrapper, as in the JAX wrapper.
//
// What bounds it on this card: at MHA geometry, operations. Each tile's K
// up-projection costs 2·TT·Rk·hd per (b, group), i.e. 2·B·T·Rk·KV·hd for the
// step, against B·T·(Rk+Rv) + KV·hd·Rk elements read: about 2·KV·hd/2 = 4096
// FLOP per cache byte at KV=32, hd=128, far above the ~295 FLOP/byte ridge.
// At GQA the ratio shrinks by the group count, but stays compute-heavy.
//
// Design (simple and right first):
//   * One block per (KV group, batch row), a loop over 32-key tiles inside
//     the block takes the place of the TPU's sequential T grid axis; the
//     running max, denominator and numerator s [rep, Rv] live in shared
//     memory for the whole loop.
//   * The up-projection loops over Rk in chunks: A_k[g] at Rk=2048 is 512 KB
//     of bf16 and does not fit in shared memory, so each chunk of tk and
//     A_k[g] is staged, and the f32 K tile [32, hd] lands in shared memory
//     for RoPE and the logits. In bf16 it runs on the tensor cores (WMMA
//     16x16x16 bf16 fragments with f32 accumulators; the products of two
//     bf16 values are exact in f32, so only the summation order differs from
//     the plain version), 128-deep chunks, each warp owning hd/64 output
//     fragments; the next chunk is loaded into registers while the current
//     one is multiplied. In f32 it runs on the CUDA cores (the tensor cores would
//     round the inputs to TF32), 32-deep chunks.
//   * Tiles that hold no key in [pos - sliding + 1, pos] are skipped. Their
//     softmax weights are exactly 0 (exp(-1e30 - m) underflows) or are wiped
//     by the first live tile's exp(-1e30 - m) = 0 correction, so the result
//     equals that of visiting every tile; keys at or past T are masked and
//     never loaded, which equals the JAX wrapper's zero padding of T to the
//     tile without copying the cache.
//   * The logits, the softmax and s += p·tv run on the CUDA cores in f32.
// Known costs of this design, left for later work: the KV blocks of one
// batch row each read the whole tk/tv tile (from L2 after the first), and
// every T tile re-reads A_k[g] from L2; at B=1 MHA gives only 32 blocks for
// 132 SMs (a split-T pass would fix it); one chunk in flight, through
// registers, where cp.async or TMA with a deeper ring would keep more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>


namespace {

constexpr int kThreads = 256;
constexpr int kTT = 32;      // keys per tile (one per lane in the softmax)
constexpr int kRC = 32;      // Rk chunk of the f32 up-projection
constexpr int kKC = 128;     // Rk chunk of the bf16 (tensor-core) up-projection
constexpr int kLDB = kKC + 8;  // bf16 chunk row stride (a multiple of 8 for WMMA)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;  // query heads per KV group
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 K-tile row stride (WMMA stores need a multiple of 4)
__host__ __device__ constexpr int kt_ld(int HD) { return HD + 4; }

// Staging buffer of the up-projection chunks: f32 [kTT + HD][kRC + 1] or bf16
// [kTT + HD][kLDB], whichever is larger, rounded to 128 bytes.
__host__ __device__ constexpr size_t scratch_bytes(int HD) {
  return (((size_t)(kTT + HD) * (kRC + 1) * 4 > (size_t)(kTT + HD) * kLDB * 2
               ? (size_t)(kTT + HD) * (kRC + 1) * 4
               : (size_t)(kTT + HD) * kLDB * 2) + 127) / 128 * 128;
}

size_t smem_bytes(int HD, int rep, int Rv) {
  return scratch_bytes(HD)
         + 4 * ((size_t)kTT * kt_ld(HD)  // K tile
                + (size_t)rep * HD       // q
                + (size_t)rep * kTT      // logits / p
                + 3 * (size_t)rep        // m, den, correction
                + (size_t)rep * Rv);     // numerator s
}

// kt[kTT][HD + 4] = tk[t0 : t0 + kTT] · A_k[g]ᵀ in f32 on the CUDA cores.
template <int HD>
__device__ void up_project(const float* tk_b, const float* ak_g, int t0, int T_len, int Rk,
                           void* scratch, float* kt) {
  constexpr int RG = kThreads / HD;  // row groups
  constexpr int RPT = kTT / RG;      // K-tile rows per thread
  float* tks = static_cast<float*>(scratch);  // [kTT][kRC + 1]
  float* aks = tks + kTT * (kRC + 1);         // [HD][kRC + 1]
  const int tid = threadIdx.x;
  const int d = tid % HD;
  const int rg = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < Rk; k0 += kRC) {
    for (int i = tid; i < kTT * kRC; i += kThreads) {
      const int t = i / kRC, k = i % kRC;
      tks[t * (kRC + 1) + k] = (t0 + t < T_len && k0 + k < Rk)
                                   ? tk_b[(size_t)(t0 + t) * Rk + k0 + k] : 0.f;
    }
    for (int i = tid; i < HD * kRC; i += kThreads) {
      const int dd = i / kRC, k = i % kRC;
      aks[dd * (kRC + 1) + k] = (k0 + k < Rk) ? ak_g[(size_t)dd * Rk + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kRC; ++k) {
      const float av = aks[d * (kRC + 1) + k];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = fmaf(tks[(rg + RG * j) * (kRC + 1) + k], av, acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) kt[(rg + RG * j) * kt_ld(HD) + d] = acc[j];
}

// Eight bf16 values of row `row`, columns [col, col + 8), of a matrix with
// row stride ld; zero outside [0, n_rows) x [0, ld). One 16-byte load when
// ld % 8 == 0 (then a slot is all in or all out), else eight scalar loads.
__device__ __forceinline__ uint4 load_slot(const __nv_bfloat16* src, int ld, int row,
                                           int n_rows, int col, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row < n_rows && col < ld) {
    const __nv_bfloat16* p = src + (size_t)row * ld + col;
    if (vec) {
      v = *reinterpret_cast<const uint4*>(p);
    } else {
      __nv_bfloat16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = col + j < ld ? p[j] : __float2bfloat16_rn(0.f);
      memcpy(&v, e, sizeof v);
    }
  }
  return v;
}

// The same on the tensor cores for bf16 inputs (f32 accumulators). The next
// chunk's tk and A_k slots are loaded into registers while the tensor cores
// work on the current one, so the L2/HBM latency overlaps the products.
template <int HD>
__device__ void up_project(const __nv_bfloat16* tk_b, const __nv_bfloat16* ak_g, int t0,
                           int T_len, int Rk, void* scratch, float* kt) {
  using namespace nvcuda;
  constexpr int NT = (kTT / 16) * (HD / 16);        // 16x16 output fragments
  constexpr int ACC = (NT + kWarps - 1) / kWarps;   // fragments per warp
  constexpr int SPR = kKC / 8;                      // 8-wide slots per chunk row
  constexpr int SLOTS = (kTT + HD) * SPR / kThreads;  // slots per thread
  static_assert((kTT + HD) * SPR % kThreads == 0, "slots divide the block");
  __nv_bfloat16* buf = static_cast<__nv_bfloat16*>(scratch);  // [kTT + HD][kLDB]
  const int warp = threadIdx.x / 32;
  const bool vec = Rk % 8 == 0;

  // rows [0, kTT) of the chunk are tk rows t0.., rows [kTT, kTT + HD) A_k[g] rows
  uint4 regs[SLOTS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / SPR, c = k0 + (i % SPR) * 8;
      regs[j] = r < kTT ? load_slot(tk_b, Rk, t0 + r, T_len, c, vec)
                        : load_slot(ak_g, Rk, r - kTT, HD, c, vec);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) wmma::fill_fragment(c[i], 0.f);
  fetch(0);
  for (int k0 = 0; k0 < Rk; k0 += kKC) {
    __syncthreads();  // the previous chunk's products are done with buf
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(buf + (i / SPR) * kLDB + (i % SPR) * 8) = regs[j];
    }
    __syncthreads();
    if (k0 + kKC < Rk) fetch(k0 + kKC);
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int tile = warp + i * kWarps;
        if (tile < NT) {
          const int tr = tile / (HD / 16), tc = tile % (HD / 16);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, buf + tr * 16 * kLDB + kk, kLDB);
          wmma::load_matrix_sync(bm, buf + (kTT + tc * 16) * kLDB + kk, kLDB);
          wmma::mma_sync(c[i], a, bm, c[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < NT) {
      const int tr = tile / (HD / 16), tc = tile % (HD / 16);
      wmma::store_matrix_sync(kt + tr * 16 * kt_ld(HD) + tc * 16, c[i], kt_ld(HD),
                              wmma::mem_row_major);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
latent_decode_kernel(const T* __restrict__ q, const T* __restrict__ tk,
                     const T* __restrict__ tv, const T* __restrict__ a_k,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     float* __restrict__ out, int H, int KV, int T_len, int Rk, int Rv,
                     int pos, float scale, float softcap, int sliding) {
  constexpr int HALF = HD / 2;
  constexpr int LD = kt_ld(HD);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  void* scratch = smem_raw;                                      // up-projection chunks
  float* kt = reinterpret_cast<float*>(smem_raw + scratch_bytes(HD));  // [kTT][LD]
  float* qs = kt + kTT * LD;                 // [rep][HD]
  float* ps = qs + rep * HD;                 // [rep][kTT]
  float* ms = ps + rep * kTT;                // [rep]
  float* ls = ms + rep;                      // [rep]
  float* cs = ls + rep;                      // [rep]
  float* ss = cs + rep;                      // [rep][Rv]

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t head0 = (size_t)b * H + (size_t)g * rep;

  for (int i = tid; i < rep * HD; i += kThreads) qs[i] = to_f32(q[head0 * HD + i]);
  for (int i = tid; i < rep; i += kThreads) { ms[i] = kNeg; ls[i] = 0.f; cs[i] = 1.f; }
  for (int i = tid; i < rep * Rv; i += kThreads) ss[i] = 0.f;
  __syncthreads();

  const int t_hi = min(T_len, pos + 1);
  const int t_lo = sliding > 0 ? max(0, pos - sliding + 1) : 0;
  const T* tk_b = tk + (size_t)b * T_len * Rk;
  const T* tv_b = tv + (size_t)b * T_len * Rv;
  const T* ak_g = a_k + (size_t)g * HD * Rk;

  for (int t0 = (t_lo / kTT) * kTT; t0 < t_hi; t0 += kTT) {
    // 1) K tile = tk_tile · A_k[g]ᵀ, f32
    up_project<HD>(tk_b, ak_g, t0, T_len, Rk, scratch, kt);
    __syncthreads();

    // 2) rotate-half RoPE in f32
    for (int i = tid; i < kTT * HALF; i += kThreads) {
      const int t = i / HALF, dd = i % HALF;
      if (t0 + t >= T_len) continue;
      const float* cr = cos_t + (size_t)(t0 + t) * HD;
      const float* sr = sin_t + (size_t)(t0 + t) * HD;
      const float k1 = kt[t * LD + dd];
      const float k2 = kt[t * LD + dd + HALF];
      kt[t * LD + dd] = k1 * cr[dd] + (-k2) * sr[dd];
      kt[t * LD + dd + HALF] = k2 * cr[dd + HALF] + k1 * sr[dd + HALF];
    }
    __syncthreads();

    // 3) logits for the group's rep heads, softcap, mask
    for (int i = tid; i < rep * kTT; i += kThreads) {
      const int r = i / kTT, t = i % kTT;
      const int kp = t0 + t;
      float l = kNeg;
      if (kp <= pos && kp < T_len && (sliding <= 0 || kp > pos - sliding)) {
        float dot = 0.f;
        const float* qr = qs + r * HD;
        const float* kr = kt + t * LD;
#pragma unroll 8
        for (int e = 0; e < HD; ++e) dot = fmaf(qr[e], kr[e], dot);
        l = dot * scale;
        if (softcap > 0.f) l = softcap * tanhf(l / softcap);
      }
      ps[i] = l;
    }
    __syncthreads();

    // 4) online softmax, one warp per head
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float l = ps[r * kTT + lane];
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(l));
      const float corr = expf(m_prev - m_new);
      const float p = expf(l - m_new);
      const float sum = warp_sum(p);
      ps[r * kTT + lane] = to_f32(from_f32<T>(p));
      if (lane == 0) {
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();

    // 5) s = s·c + T(p) · tv_tile; each thread owns whole columns of s
    const int tn = min(kTT, T_len - t0);
    for (int v = tid; v < Rv; v += kThreads) {
      float a[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) a[r] = ss[r * Rv + v] * cs[r];
      for (int t = 0; t < tn; ++t) {
        const float x = to_f32(tv_b[(size_t)(t0 + t) * Rv + v]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) a[r] = fmaf(ps[r * kTT + t], x, a[r]);
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) ss[r * Rv + v] = a[r];
    }
    __syncthreads();
  }

  for (int i = tid; i < rep * Rv; i += kThreads) {
    const int r = i / Rv;
    out[head0 * Rv + i] = ss[i] / ls[r];
  }
}

template <typename T, int HD>
int launch(const void* q, const void* tk, const void* tv, const void* a_k,
           const float* cos_t, const float* sin_t, float* out, int B, int H, int KV,
           int T_len, int Rk, int Rv, int pos, float scale, float softcap, int sliding,
           cudaStream_t stream) {
  const int rep = H / KV;
  const size_t bytes = smem_bytes(HD, rep, Rv);
  auto kernel = latent_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KV, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(tk), static_cast<const T*>(tv),
      static_cast<const T*>(a_k), cos_t, sin_t, out, H, KV, T_len, Rk, Rv, pos, scale,
      softcap, sliding);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int HD, const void* q, const void* tk, const void* tv, const void* a_k,
                const float* c, const float* s, float* out, int B, int H, int KV, int T_len,
                int Rk, int Rv, int pos, float scale, float softcap, int sliding,
                cudaStream_t st) {
  switch (HD) {
    case 32:
      return launch<T, 32>(q, tk, tv, a_k, c, s, out, B, H, KV, T_len, Rk, Rv, pos, scale, softcap, sliding, st);
    case 64:
      return launch<T, 64>(q, tk, tv, a_k, c, s, out, B, H, KV, T_len, Rk, Rv, pos, scale, softcap, sliding, st);
    case 128:
      return launch<T, 128>(q, tk, tv, a_k, c, s, out, B, H, KV, T_len, Rk, Rv, pos, scale, softcap, sliding, st);
    case 256:
      return launch<T, 256>(q, tk, tv, a_k, c, s, out, B, H, KV, T_len, Rk, Rv, pos, scale, softcap, sliding, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs; the wrapper refuses shapes above
// the 232,448-byte opt-in limit before launching.
extern "C" long long latent_attention_smem_bytes(int head_dim, int rep, int Rv) {
  return (long long)smem_bytes(head_dim, rep, Rv);
}

// dtype: 0 = float32, 1 = bfloat16 (q, tk, tv, a_k all of it); cos/sin
// [T, HD] f32; out [B, H, Rv] f32. Returns cudaGetLastError() (0 = success).
extern "C" int latent_attention_launch(const void* q, const void* tk, const void* tv,
                                       const void* a_k, const void* cos_t, const void* sin_t,
                                       void* out, int B, int H, int KV, int HD, int T_len,
                                       int Rk, int Rv, int pos, float scale, float softcap,
                                       int sliding, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch_hd<float>(HD, q, tk, tv, a_k, c, s, o, B, H, KV, T_len, Rk, Rv, pos,
                              scale, softcap, sliding, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, q, tk, tv, a_k, c, s, o, B, H, KV, T_len, Rk, Rv,
                                      pos, scale, softcap, sliding, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
