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
// Design (simple and right first; the tile body is in flash_decode.cuh, shared
// with the paged kernels 5 and 6):
//   * One block per (KV group, batch row), a loop over 32-key tiles inside
//     the block takes the place of the TPU's sequential T grid axis; the
//     running max, denominator and numerator s [rep, Rv] live in shared
//     memory for the whole loop. Each tile's key rows are named in a row table
//     in shared memory (here consecutive rows of the flat cache).
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
//   * The logits, the softmax and s += p·tv run on the CUDA cores in f32; the
//     tv loads of a tile are all in flight before the first product.
// Known costs of this design, left for later work: the KV blocks of one
// batch row each read the whole tk/tv tile (from L2 after the first), and
// every T tile re-reads A_k[g] from L2; at B=1 MHA gives only 32 blocks for
// 132 SMs (the split over keys of the paged kernel 6 would fix it); one
// chunk in flight, through registers, where cp.async or TMA with a deeper
// ring would keep more.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

size_t smem_bytes(int HD, int rep, int Rv) {
  return tile_smem_bytes(scratch_bytes(HD), kt_ld(HD), HD, rep, Rv);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
latent_decode_kernel(const T* __restrict__ q, const T* __restrict__ tk,
                     const T* __restrict__ tv, const T* __restrict__ a_k,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     float* __restrict__ out, int H, int KV, int T_len, int Rk, int Rv,
                     int pos, float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const Tile<T> s = carve<T>(smem_raw, scratch_bytes(HD), kt_ld(HD), HD, rep);
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t head0 = (size_t)b * H + (size_t)g * rep;

  tile_init(s, q + head0 * HD, HD, rep, Rv);
  __syncthreads();

  const int t_hi = min(T_len, pos + 1);
  const int t_lo = sliding > 0 ? max(0, pos - sliding + 1) : 0;
  const T* tk_b = tk + (size_t)b * T_len * Rk;
  const T* tv_b = tv + (size_t)b * T_len * Rv;
  const T* ak_g = a_k + (size_t)g * HD * Rk;
  const bool vec = Rk % 8 == 0 && reinterpret_cast<uintptr_t>(tk) % 16 == 0
                   && reinterpret_cast<uintptr_t>(a_k) % 16 == 0;

  for (int t0 = (t_lo / kTT) * kTT; t0 < t_hi; t0 += kTT) {
    if (tid < kTT) {
      const int t = t0 + tid;
      s.rows_k[tid] = t < t_hi ? tk_b + (size_t)t * Rk : nullptr;
      s.rows_v[tid] = t < t_hi ? tv_b + (size_t)t * Rv : nullptr;
    }
    __syncthreads();
    latent_tile<T, HD>(s, ak_g, cos_t, sin_t, Rk, Rv, rep, t0, t_hi, pos, sliding, scale,
                       softcap, vec);
  }
  tile_finish(s, out + head0 * Rv, Rv, rep);
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
