// Latent-KV flash-decoding attention for Hopper (sm_90a).
//
// Replaces asvd4llm_tpu/ops/pallas_latent_attention.py::_latent_attention_core
// (bodies `_kernel` and `_online_tile`, public wrapper
// `latent_decode_attention`): one decode step of a layer whose k and v
// projections are low-rank and whose cache holds the rank-dim latents
// tk [B,T,Rk] and tv [B,T,Rv] instead of K and V.
//
// For every query head h of KV group g, over the live keys
// [pos - sliding + 1, pos] of the row, where pos is one int32 in device
// memory (so a captured CUDA graph replays the step at each new position):
//   K     = tk · A_k[g]ᵀ                      (f32 accumulate, not re-rounded)
//   K     = rotate-half RoPE(K) with f32 cos/sin rows
//   l     = scale · q_h · K (+ tanh softcap), causal/sliding mask → -1e30
//   softmax over the keys, p rounded to tv's type for the numerator:
//   s_h   = Σ_t T(p_t) · tv_t / Σ_t p_t       (f32 sums)
// written as [B,H,Rv] f32. The A_v up-projection and the v bias stay in the
// wrapper, as in the JAX wrapper.
//
// What bounds it on this card: operations. The K up-projection of one step
// is one GEMM, [B·T keys, Rk] · [Rk, KV·hd] (18.25 GFLOP at B=4, T=544,
// Rk=1024, KV=32, hd=128), against B·T·(Rk+Rv) + KV·hd·Rk elements read:
// about 4096 FLOP per cache byte at MHA, far above the ~295 FLOP/byte ridge.
//
// Forms, chosen by the wrapper (`ops/latent_attention.py::_form`):
//   * "split_wgmma" (bf16, hd 64 or 128, Rk and Rv multiples of 8, 16-byte
//     aligned caches): the split tile of latent_split.cuh (shared with
//     kernel 6): one block per (128-key chunk, KV group, batch row), every
//     chunk of T launched whatever the position (the grid is a function of
//     shapes only); a block whose chunk holds no live key marks it empty
//     and exits, by kernel 6's rule (latent_split::dead_chunk). A producer warp
//     streams the chunk's tk rows (one TMA box of 128 rows of the row's
//     cache) and A_k[g] over Rk through a TMA ring, so A_k[g] is read once
//     per 128 keys instead of once per 32; two consumer warpgroups
//     up-project on wgmma, keep K in f32 registers with RoPE and q·K on the
//     accumulators, take the chunk's softmax and s = Σ T(p)·tv on mma.sync
//     over tv tiles streamed through the same ring.
//     The chunk's (max, den, s) go to a workspace and a second launch
//     (flash_decode::combine_chunks, shared with kernels 5 and 6) merges the
//     chunks, one thread per output value:
//     out = Σ_j exp(m_j − M)·s_j / Σ_j exp(m_j − M)·den_j. p is rounded
//     relative to its chunk's max instead of a running max; both are one
//     bf16 rounding of the same weights.
//   * "tile32" (f32, other head dims, ranks not multiples of 8): the form
//     on the tile body of flash_decode.cuh shared with kernels 5 and 6:
//     one block per (KV group, batch row), 32-key tiles in a serial loop
//     with an online softmax in shared memory; the up-projection on WMMA
//     (bf16) or the CUDA cores (f32) over staged Rk chunks; f32 logits,
//     softmax and s += p·tv on the CUDA cores. Tiles outside the window are
//     skipped; keys at or past T are masked and never loaded, which equals
//     the JAX wrapper's zero padding of T.
// Known costs of the split form, for later work: the 32 group blocks of a
// batch row at MHA each read the row's tk and tv chunk from L2 (the GEMM's
// shared operand is not shared in shared memory across groups); one block
// per SM (about 150 KB of shared memory), so RoPE, the logits and the
// softmax do not overlap another block's products.

#include "latent_split.cuh"

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
                     const int* __restrict__ pos_p, float* __restrict__ out, int H, int KV,
                     int T_len, int Rk, int Rv, float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const int pos = *pos_p;
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
           const float* cos_t, const float* sin_t, const int* pos, float* out, int B, int H,
           int KV, int T_len, int Rk, int Rv, float scale, float softcap, int sliding,
           cudaStream_t stream) {
  const int rep = H / KV;
  const size_t bytes = smem_bytes(HD, rep, Rv);
  auto kernel = latent_decode_kernel<T, HD>;
  cudaError_t err = sm90::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KV, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(tk), static_cast<const T*>(tv),
      static_cast<const T*>(a_k), cos_t, sin_t, pos, out, H, KV, T_len, Rk, Rv, scale,
      softcap, sliding);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int HD, const void* q, const void* tk, const void* tv, const void* a_k,
                const float* c, const float* s, const int* pos, float* out, int B, int H,
                int KV, int T_len, int Rk, int Rv, float scale, float softcap, int sliding,
                cudaStream_t st) {
  switch (HD) {
    case 32:
      return launch<T, 32>(q, tk, tv, a_k, c, s, pos, out, B, H, KV, T_len, Rk, Rv, scale, softcap, sliding, st);
    case 64:
      return launch<T, 64>(q, tk, tv, a_k, c, s, pos, out, B, H, KV, T_len, Rk, Rv, scale, softcap, sliding, st);
    case 128:
      return launch<T, 128>(q, tk, tv, a_k, c, s, pos, out, B, H, KV, T_len, Rk, Rv, scale, softcap, sliding, st);
    case 256:
      return launch<T, 256>(q, tk, tv, a_k, c, s, pos, out, B, H, KV, T_len, Rk, Rv, scale, softcap, sliding, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- the split form ("split_wgmma") -----------------------------------------

namespace ls = latent_split;

// Block (chunk j, group g, row b): the chunk's max, denominator and
// numerator s for the group's rep heads into ws_ml [B, KV, NS, rep, 2] and
// ws_s [B, KV, NS, rep, Rv], NS = cdiv(T, kChunk); the chunk's rows are rows
// 128j.. of the row's cache, one TMA box. A chunk outside the live keys of
// *pos_p is marked empty.
template <int HD>
__global__ void __launch_bounds__(ls::kThreads, 1)
latent_split_kernel(const __grid_constant__ CUtensorMap map_tk,
                    const __grid_constant__ CUtensorMap map_ak,
                    const __grid_constant__ CUtensorMap map_tv, const __nv_bfloat16* __restrict__ q,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    const int* __restrict__ pos_p, float* __restrict__ ws_s,
                    float* __restrict__ ws_ml, int H, int KV, int T_len, int Rk, int Rv,
                    float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const size_t split = ((size_t)b * KV + g) * gridDim.x + j;
  const int pos = *pos_p;
  const int t_lo = ls::window_lo(pos, sliding);
  const int c0 = j * ls::kChunk;
  if (ls::dead_chunk(c0, pos, t_lo, ws_ml + split * rep * 2, rep)) return;
  const ls::Smem s = ls::carve(smem_raw, HD, rep);
  const int KT = (Rk + sm90::kBK - 1) / sm90::kBK;  // ring steps of the up-projection
  const int VT = (Rv + sm90::kBK - 1) / sm90::kBK;  // then of the tv sum

  ls::setup(s, q + ((size_t)b * H + (size_t)g * rep) * HD, HD, rep);
  __syncthreads();
  if (threadIdx.x >= ls::kConsumers) {  // the producer warp
    if (threadIdx.x == ls::kConsumers)
      ls::produce<HD>(s, &map_tk, &map_ak, &map_tv, g, KT, VT,
                      [&](__nv_bfloat16* dst, const CUtensorMap* map, int col, uint64_t* bar) {
                        sm90::tma_load_3d(dst, map, col, c0, b, bar);
                      });
    return;
  }
  ls::consume<HD>(s, cos_t, sin_t, T_len, c0, t_lo, min(T_len, pos + 1), Rv, rep, KT, VT,
                  scale, softcap, ws_s + split * rep * Rv, ws_ml + split * rep * 2);
}

int n_chunks_of(int T_len) { return (T_len + ls::kChunk - 1) / ls::kChunk; }

// The split form: every chunk of T, then combine_chunks into out.
// ws holds B·KV·NS·rep·(Rv + 2) f32 values, NS = n_chunks_of(T).
template <int HD>
int launch_split(const void* q, const void* tk, const void* tv, const void* a_k,
                 const float* cos_t, const float* sin_t, const int* pos, float* ws, float* out,
                 int B, int H, int KV, int T_len, int Rk, int Rv, float scale, float softcap,
                 int sliding, cudaStream_t stream) {
  if (T_len <= 0 || Rk % 8 != 0 || Rv % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_tk, map_ak;
  const cuuint64_t dims[3] = {(cuuint64_t)Rk, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Rk * 2, (cuuint64_t)T_len * Rk * 2};
  const cuuint32_t box[3] = {(cuuint32_t)sm90::kBK, (cuuint32_t)ls::kChunk, 1};
  cudaError_t err = sm90::encode_map(&map_tk, 3, tk, dims, strides, box);
  if (err != cudaSuccess) return (int)err;
  err = sm90::encode_rows(&map_ak, a_k, KV * HD, Rk, HD);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_tv;
  const cuuint64_t dims_v[3] = {(cuuint64_t)Rv, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides_v[2] = {(cuuint64_t)Rv * 2, (cuuint64_t)T_len * Rv * 2};
  err = sm90::encode_map(&map_tv, 3, tv, dims_v, strides_v, box);
  if (err != cudaSuccess) return (int)err;
  const int rep = H / KV;
  const size_t bytes = ls::tail_offset(HD, rep);
  auto kernel = latent_split_kernel<HD>;
  err = sm90::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int NS = n_chunks_of(T_len);
  float* ws_s = ws;
  float* ws_ml = ws + (size_t)B * KV * NS * rep * Rv;
  kernel<<<dim3(NS, KV, B), ls::kThreads, bytes, stream>>>(
      map_tk, map_ak, map_tv, static_cast<const __nv_bfloat16*>(q), cos_t, sin_t, pos, ws_s,
      ws_ml, H, KV, T_len, Rk, Rv, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(ws_s, ws_ml, out, B, H, KV, NS, Rv, stream);
}

}  // namespace

// Shared memory (bytes) one block needs; the wrapper refuses shapes above
// the 232,448-byte opt-in limit before launching.
extern "C" long long latent_attention_smem_bytes(int head_dim, int rep, int Rv) {
  return (long long)smem_bytes(head_dim, rep, Rv);
}

// dtype: 0 = float32, 1 = bfloat16 (q, tk, tv, a_k all of it); cos/sin
// [T, HD] f32; pos one int32 in device memory, in [0, T) (not checked here);
// out [B, H, Rv] f32. form: 0 = "tile32", 1 = "split_wgmma" (bf16, HD 64 or
// 128; ws its workspace of B·KV·n_chunks·rep·(Rv + 2) f32 values, n_chunks =
// cdiv(T, 128), else both unused). No launch reads pos on the host, so a
// CUDA graph may capture them. Returns cudaGetLastError() (0 = success),
// cudaErrorInvalidValue for a form the shape does not allow.
extern "C" int latent_attention_launch(const void* q, const void* tk, const void* tv,
                                       const void* a_k, const void* cos_t, const void* sin_t,
                                       const void* pos, void* out, void* ws, int n_chunks,
                                       int B, int H, int KV, int HD, int T_len, int Rk, int Rv,
                                       float scale, float softcap, int sliding, int dtype,
                                       int form, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* p = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  if (form == 1) {
    float* w = static_cast<float*>(ws);
    if (dtype != 1 || n_chunks_of(T_len) != n_chunks) return (int)cudaErrorInvalidValue;
    if (HD == 64)
      return launch_split<64>(q, tk, tv, a_k, c, s, p, w, o, B, H, KV, T_len, Rk, Rv, scale,
                              softcap, sliding, st);
    if (HD == 128)
      return launch_split<128>(q, tk, tv, a_k, c, s, p, w, o, B, H, KV, T_len, Rk, Rv, scale,
                               softcap, sliding, st);
    return (int)cudaErrorInvalidValue;
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(HD, q, tk, tv, a_k, c, s, p, o, B, H, KV, T_len, Rk, Rv, scale,
                              softcap, sliding, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, q, tk, tv, a_k, c, s, p, o, B, H, KV, T_len, Rk, Rv,
                                      scale, softcap, sliding, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
