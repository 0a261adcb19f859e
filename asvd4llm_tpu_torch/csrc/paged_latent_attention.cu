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
// Forms, chosen by the wrapper (`ops/paged_attention.py::_latent_form`):
//   * "split_wgmma" (bf16, hd 64 or 128, Rk and Rv multiples of 8, 16-byte
//     aligned pools and A_k, page size P a power of two of at least 8):
//     kernel 2's split tile (latent_split.cuh) on the page pools. One block
//     per (128-key chunk, KV group, row), MP·P/128 chunks a row whatever
//     the positions (they live on the device, and paged_decode_scan runs
//     steps with no host sync between them): a block whose chunk holds no
//     key of [positions[b] − sliding + 1, positions[b]] marks its chunk
//     empty and exits. The block stages its row of the page table in shared
//     memory; the producer lane reads the page ids from there and loads the
//     chunk's latent rows through a 3-D tensor map over the pool (column,
//     row in page, page id): for P >= 128 one box of 128 rows of one page
//     (a chunk never straddles a page), for P < 128 128/P boxes of P rows,
//     each from its own page into consecutive rows of the stage, all on one
//     barrier. Boxes of 8 or more rows start on 1024-byte boundaries, so the
//     128-byte swizzle of the stage is that of one big box. A box of a
//     logical page outside the row's live pages loads the nearest live page
//     instead (the TPU kernel's clamp of trailing pages): its keys are
//     masked and its rows finite. A_k[g] is read once per 128 keys, K stays
//     in f32 registers (RoPE with the cos/sin row of the logical position,
//     q·K on the accumulators), T(p)·tv runs on mma.sync.
//   * "tile32" (f32, other head dims, unaligned ranks, other page sizes):
//     kernel 2's 32-key tile body (flash_decode.cuh) with a page table: a
//     block walks its chunk's live keys in 32-key tiles, each tile's keys
//     resolved through the staged page row into the shared row tables, one
//     lookup per key, so any page size works and a tile may straddle pages;
//     the up-projection on WMMA with one Rk chunk in flight, A_k[g] re-read
//     from L2 every tile, 255 registers.
// Both leave each chunk's running max, denominator and numerator in a
// workspace that a second launch (flash_decode::combine_chunks) merges.
// Pages past positions[b] / P are never read by tile32; split_wgmma reads
// the rows of a live chunk's pages past positions[b] (masked, p = 0), which
// must be finite, as the engine's pools are. A slot with no request (page
// table all 0, position 0) reads key 0 of the scratch page 0 and gives
// finite values, which the engine ignores.
//
// Page ids must lie in [0, NP) and positions in [0, MP·P): the engine
// guarantees both, and the kernel does not check them.

#include "latent_split.cuh"

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
  cudaError_t err = sm90::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KV, B, NS), kThreads, bytes, stream>>>(
      q, static_cast<const T*>(tk), static_cast<const T*>(tv), static_cast<const T*>(a_k),
      cos_t, sin_t, pt, positions, ws, ws_ml, H, KV, P, MP, Rk, Rv, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(ws, ws_ml, out, B, H, KV, NS, Rv, stream);
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

// ---- the split form ("split_wgmma") -----------------------------------------

namespace ls = latent_split;
static_assert(ls::kChunk == kSplit, "one workspace layout for both forms");

// Block (chunk j, group g, row b): kernel 2's split tile over the keys
// [128j, 128j + 128) of row b, their latent rows gathered from the pools by
// page; ws_ml [B, KV, NS, rep, 2] and ws_s [B, KV, NS, rep, Rv] as kernel 2.
template <int HD>
__global__ void __launch_bounds__(ls::kThreads, 1)
paged_latent_split_kernel(const __grid_constant__ CUtensorMap map_tk,
                          const __grid_constant__ CUtensorMap map_ak,
                          const __grid_constant__ CUtensorMap map_tv,
                          const float* __restrict__ q, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, const int* __restrict__ page_table,
                          const int* __restrict__ positions, float* __restrict__ ws_s,
                          float* __restrict__ ws_ml, int H, int KV, int P, int MP, int Rk, int Rv,
                          float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const size_t split = ((size_t)b * KV + g) * gridDim.x + j;
  const int pos = positions[b];
  const int t_lo = ls::window_lo(pos, sliding);
  const int c0 = j * ls::kChunk;
  if (ls::dead_chunk(c0, pos, t_lo, ws_ml + split * rep * 2, rep)) return;
  const ls::Smem s = ls::carve(smem_raw, HD, rep);
  int* pts = reinterpret_cast<int*>(s.tail);  // [MP] the row's page ids
  for (int i = threadIdx.x; i < MP; i += ls::kThreads) pts[i] = page_table[(size_t)b * MP + i];
  ls::setup(s, q + ((size_t)b * H + (size_t)g * rep) * HD, HD, rep);
  __syncthreads();
  const int KT = (Rk + sm90::kBK - 1) / sm90::kBK;
  const int VT = (Rv + sm90::kBK - 1) / sm90::kBK;
  if (threadIdx.x >= ls::kConsumers) {  // the producer warp
    if (threadIdx.x == ls::kConsumers) {
      // logical pages outside [lo, hi] hold no live key: their boxes load
      // the nearest live page (masked keys, finite rows)
      const int lo = t_lo / P, hi = pos / P;
      ls::produce<HD>(s, &map_tk, &map_ak, &map_tv, g, KT, VT,
                      [&](__nv_bfloat16* dst, const CUtensorMap* map, int col, uint64_t* bar) {
                        if (P >= ls::kChunk) {
                          sm90::tma_load_3d(dst, map, col, c0 % P, pts[c0 / P], bar);
                          return;
                        }
                        for (int i = 0; i < ls::kChunk / P; ++i) {
                          const int lp = min(max(c0 / P + i, lo), hi);
                          sm90::tma_load_3d(dst + (size_t)i * P * sm90::kBK, map, col, 0,
                                            pts[lp], bar);
                        }
                      });
    }
    return;
  }
  ls::consume<HD>(s, cos_t, sin_t, MP * P, c0, t_lo, pos + 1, Rv, rep, KT, VT, scale, softcap,
                  ws_s + split * rep * Rv, ws_ml + split * rep * 2);
}

size_t split_smem_bytes(int HD, int rep, int MP) {
  return ls::tail_offset(HD, rep) + 4 * (size_t)MP;
}

// A 3-D map over a pool [NP, P, R] bf16: (column, row in page, page), boxes
// of 64 columns and min(P, 128) rows of one page.
cudaError_t encode_pool(CUtensorMap* map, const void* pool, int NP, int P, int R) {
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)P, (cuuint64_t)NP};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 2, (cuuint64_t)P * R * 2};
  const cuuint32_t box[3] = {(cuuint32_t)sm90::kBK,
                             (cuuint32_t)(P < ls::kChunk ? P : ls::kChunk), 1};
  return sm90::encode_map(map, 3, pool, dims, strides, box);
}

template <int HD>
int launch_split(const float* q, const void* tk, const void* tv, const void* a_k,
                 const float* cos_t, const float* sin_t, const int* pt, const int* positions,
                 float* ws, float* out, int B, int H, int KV, int NP, int P, int MP, int Rk,
                 int Rv, float scale, float softcap, int sliding, cudaStream_t stream) {
  if (Rk % 8 != 0 || Rv % 8 != 0 || P < 8 || (P & (P - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_tk, map_ak, map_tv;
  cudaError_t err = encode_pool(&map_tk, tk, NP, P, Rk);
  if (err != cudaSuccess) return (int)err;
  err = encode_pool(&map_tv, tv, NP, P, Rv);
  if (err != cudaSuccess) return (int)err;
  err = sm90::encode_rows(&map_ak, a_k, KV * HD, Rk, HD);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = split_smem_bytes(HD, H / KV, MP);
  auto kernel = paged_latent_split_kernel<HD>;
  err = sm90::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int NS = n_splits(MP, P);
  float* ws_ml = ws + (size_t)B * H * NS * Rv;
  kernel<<<dim3(NS, KV, B), ls::kThreads, bytes, stream>>>(
      map_tk, map_ak, map_tv, q, cos_t, sin_t, pt, positions, ws, ws_ml, H, KV, P, MP, Rk, Rv,
      scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(ws, ws_ml, out, B, H, KV, NS, Rv, stream);
}

}  // namespace

// Shared memory (bytes) one block of a form needs; the wrapper refuses
// shapes above the 232,448-byte opt-in limit before launching.
extern "C" long long paged_latent_attention_smem_bytes(int head_dim, int rep, int Rv, int MP,
                                                       int form) {
  return (long long)(form == 1 ? split_smem_bytes(head_dim, rep, MP)
                               : smem_bytes(head_dim, rep, Rv, MP));
}

// f32 elements of the workspace a launch needs (the chunks' partial sums).
extern "C" long long paged_latent_attention_workspace(int B, int H, int KV, int Rv, int P,
                                                      int MP) {
  return (long long)B * H * n_splits(MP, P) * (Rv + 2);
}

// q [B,H,HD] f32; tk_pool [NP,P,Rk], tv_pool [NP,P,Rv], a_k of `dtype`
// (0 = float32, 1 = bfloat16); cos/sin [MP·P, HD] f32; page_table [B, MP]
// and positions [B] int32; ws the f32 workspace; out [B, H, Rv] f32. form:
// 0 = "tile32", 1 = "split_wgmma" (bf16, HD 64 or 128, Rk and Rv multiples
// of 8, P a power of two >= 8). Two launches on `stream`: the chunks, then
// their combination. Returns cudaGetLastError() (0 = success),
// cudaErrorInvalidValue for a form the shape does not allow.
extern "C" int paged_latent_attention_launch(const void* q, const void* tk_pool,
                                             const void* tv_pool, const void* a_k,
                                             const void* cos_t, const void* sin_t,
                                             const void* page_table, const void* positions,
                                             void* ws, void* out, int B, int H, int KV, int HD,
                                             int NP, int P, int MP, int Rk, int Rv, float scale,
                                             float softcap, int sliding, int dtype, int form,
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
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (HD == 64)
      return launch_split<64>(qf, tk_pool, tv_pool, a_k, c, s, pt, pos, w, o, B, H, KV, NP, P,
                              MP, Rk, Rv, scale, softcap, sliding, st);
    if (HD == 128)
      return launch_split<128>(qf, tk_pool, tv_pool, a_k, c, s, pt, pos, w, o, B, H, KV, NP, P,
                               MP, Rk, Rv, scale, softcap, sliding, st);
    return (int)cudaErrorInvalidValue;
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
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
