// Paged latent-KV flash-decoding attention for Hopper (sm_90a) — kernel 6.
//
// Replaces asvd4llm_tpu/ops/pallas_latent_attention.py::_paged_latent_core
// (bodies `_paged_kernel` and `_online_tile`, public wrapper
// `paged_latent_decode_attention`): one decode step of the serving engine
// over a layer whose cache holds rank-dim latents in page pools
// tk_pool [NP,P,Rk] and tv_pool [NP,P,Rv]. Row b of the batch decodes at its
// own position positions[b] (ragged) and owns the pages page_table[b, :].
// It computes what kernel 2 (latent_attention.cu) computes for a flat cache,
// with logical key t of row b at pool row page_table[b, t / P]·P + t % P:
//   K = tk·A_k[g]ᵀ (f32), rotate-half RoPE with the f32 cos/sin row of the
//   LOGICAL position t, online softmax over t ≤ positions[b] (and inside the
//   sliding window), s = Σ T(p)·tv / Σ p → out [B,H,Rv] f32.
// The A_v up-projection and the v bias stay in the wrapper.
//
// What bounds it on this card: operations, as for kernel 2. The K
// up-projection costs 2·live·Rk·KV·hd per row against live·(Rk + Rv) latent
// elements read: about KV·hd FLOP per byte in bf16, far above the ~295
// FLOP/byte ridge at MHA (KV·hd = 4096); at GQA still above it.
//
// Design: kernel 2's tile body (flash_decode.cuh) with a page table, and the
// keys of a row split over blocks (flash-decoding). Grid (KV group, row,
// 128-key chunk): a block walks its chunk's live keys in 32-key tiles, from
// the tile holding positions[b] − sliding + 1 (or 0), and leaves its running
// max, denominator and numerator in a workspace; a second launch combines a
// head's chunks (unsplit, the 1024-key rows' 32 tiles ran as one serial
// chain on one SM: 1.85 ms at the smoke's shapes, H100 at 700 W; 0.97 ms split). The
// block stages its row of the page table in shared memory once; before each
// tile, 32 threads resolve the tile's keys through it into the shared row
// tables, one lookup per key, so any page size works (the tests use P = 8
// and 16; the engine's automatic page at 7B width in bf16 is 256) and a tile
// may straddle pages. Pages past positions[b] / P are never read. A slot
// with no request (page table all 0, position 0) reads key 0 of the scratch
// page 0 and gives finite values, which the engine ignores. The TPU
// kernel's clamp of trailing logical pages to the last live page (a pipeline
// trick that skips their copies) has no counterpart: the loop ends at the
// row's last key. Known costs are kernel 2's: the KV blocks of a row each
// read its latent rows (from L2 after the first), every tile re-reads A_k[g]
// from L2, 255 registers (one block per SM) with a small spill.
//
// Page ids must lie in [0, NP) and positions in [0, MP·P): the engine
// guarantees both, and the kernel does not check them.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// the tile, then the block's row of the page table
size_t smem_bytes(int HD, int rep, int Rv, int MP) {
  return tile_smem_bytes(scratch_bytes(HD), kt_ld(HD), HD, rep, Rv) + 4 * (size_t)MP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_latent_kernel(const float* __restrict__ q, const T* __restrict__ tk_pool,
                    const T* __restrict__ tv_pool, const T* __restrict__ a_k,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    const int* __restrict__ page_table, const int* __restrict__ positions,
                    float* __restrict__ ws_s, float* __restrict__ ws_ml, int H, int KV, int P,
                    int MP, int Rk, int Rv, float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const Tile<T> s = carve<T>(smem_raw, scratch_bytes(HD), kt_ld(HD), HD, rep);
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t head0 = (size_t)b * H + (size_t)g * rep;
  const size_t chunk = ((size_t)b * KV + g) * gridDim.z + split;
  float* ml = ws_ml + chunk * rep * 2;

  // this block's keys: [lo, hi) of the row's live keys, in whole tiles
  const int pos = positions[b];
  const int t_lo = sliding > 0 ? max(0, pos - sliding + 1) : 0;
  const int lo = max(split * kSplit, (t_lo / kTT) * kTT);
  const int hi = min(min(MP * P, pos + 1), (split + 1) * kSplit);
  if (lo >= hi) {
    mark_empty_split(ml, rep);
    return;
  }

  tile_init(s, q + head0 * HD, HD, rep, Rv);
  const int* pt_b = stage_page_row(smem_raw,
                                   tile_smem_bytes(scratch_bytes(HD), kt_ld(HD), HD, rep, Rv),
                                   page_table + (size_t)b * MP, MP);
  __syncthreads();  // q, the running state and the page row are in place
  const T* ak_g = a_k + (size_t)g * HD * Rk;
  const bool vec = Rk % 8 == 0 && reinterpret_cast<uintptr_t>(tk_pool) % 16 == 0
                   && reinterpret_cast<uintptr_t>(a_k) % 16 == 0;

  for (int t0 = lo; t0 < hi; t0 += kTT) {
    if (tid < kTT) {
      const int t = t0 + tid;
      const T* rk = nullptr;
      const T* rv = nullptr;
      if (t < hi) {
        const size_t row = (size_t)pt_b[t / P] * P + t % P;
        rk = tk_pool + row * Rk;
        rv = tv_pool + row * Rv;
      }
      s.rows_k[tid] = rk;
      s.rows_v[tid] = rv;
    }
    __syncthreads();
    latent_tile<T, HD>(s, ak_g, cos_t, sin_t, Rk, Rv, rep, t0, hi, pos, sliding, scale,
                       softcap, vec);
  }
  tile_store_split(s, ws_s + chunk * rep * Rv, ml, Rv, rep);
}

template <typename T, int HD>
int launch(const float* q, const void* tk, const void* tv, const void* a_k, const float* cos_t,
           const float* sin_t, const int* pt, const int* positions, float* ws, float* out,
           int B, int H, int KV, int P, int MP, int Rk, int Rv, float scale, float softcap,
           int sliding, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD, H / KV, Rv, MP);
  const int NS = n_splits(MP, P);
  float* ws_ml = ws + (size_t)B * H * NS * Rv;
  auto kernel = paged_latent_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KV, B, NS), kThreads, bytes, stream>>>(
      q, static_cast<const T*>(tk), static_cast<const T*>(tv), static_cast<const T*>(a_k),
      cos_t, sin_t, pt, positions, ws, ws_ml, H, KV, P, MP, Rk, Rv, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_splits<<<dim3(KV, B), kThreads, 0, stream>>>(ws, ws_ml, out, H, KV, NS, Rv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int HD, const float* q, const void* tk, const void* tv, const void* a_k,
                const float* c, const float* s, const int* pt, const int* pos, float* ws,
                float* out, int B, int H, int KV, int P, int MP, int Rk, int Rv, float scale,
                float softcap, int sliding, cudaStream_t st) {
  switch (HD) {
    case 32:
      return launch<T, 32>(q, tk, tv, a_k, c, s, pt, pos, ws, out, B, H, KV, P, MP, Rk, Rv, scale, softcap, sliding, st);
    case 64:
      return launch<T, 64>(q, tk, tv, a_k, c, s, pt, pos, ws, out, B, H, KV, P, MP, Rk, Rv, scale, softcap, sliding, st);
    case 128:
      return launch<T, 128>(q, tk, tv, a_k, c, s, pt, pos, ws, out, B, H, KV, P, MP, Rk, Rv, scale, softcap, sliding, st);
    case 256:
      return launch<T, 256>(q, tk, tv, a_k, c, s, pt, pos, ws, out, B, H, KV, P, MP, Rk, Rv, scale, softcap, sliding, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs; the wrapper refuses shapes above
// the 232,448-byte opt-in limit before launching.
extern "C" long long paged_latent_attention_smem_bytes(int head_dim, int rep, int Rv, int MP) {
  return (long long)smem_bytes(head_dim, rep, Rv, MP);
}

// f32 elements of the workspace a launch needs (the chunks' partial sums).
extern "C" long long paged_latent_attention_workspace(int B, int H, int KV, int Rv, int P,
                                                      int MP) {
  return (long long)B * H * n_splits(MP, P) * (Rv + 2);
}

// q [B,H,HD] f32; tk_pool, tv_pool, a_k of `dtype` (0 = float32,
// 1 = bfloat16); cos/sin [MP·P, HD] f32; page_table [B, MP] and positions [B]
// int32; ws the f32 workspace; out [B, H, Rv] f32. Two launches on `stream`:
// the chunks, then their combination. Returns cudaGetLastError() (0 = success).
extern "C" int paged_latent_attention_launch(const void* q, const void* tk_pool,
                                             const void* tv_pool, const void* a_k,
                                             const void* cos_t, const void* sin_t,
                                             const void* page_table, const void* positions,
                                             void* ws, void* out, int B, int H, int KV, int HD,
                                             int P, int MP, int Rk, int Rv, float scale,
                                             float softcap, int sliding, int dtype,
                                             void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep || P <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch_hd<float>(HD, qf, tk_pool, tv_pool, a_k, c, s, pt, pos, w, o, B, H, KV, P,
                              MP, Rk, Rv, scale, softcap, sliding, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, qf, tk_pool, tv_pool, a_k, c, s, pt, pos, w, o, B, H,
                                      KV, P, MP, Rk, Rv, scale, softcap, sliding, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
