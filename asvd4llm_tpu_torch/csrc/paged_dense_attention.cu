// Paged flash-decoding over a dense K pool for Hopper (sm_90a) — kernel 5.
//
// Replaces asvd4llm_tpu/ops/pallas_latent_attention.py::_paged_dense_core
// (body `_paged_dense_kernel`, public wrapper `paged_dense_decode_attention`):
// one decode step of the serving engine over a layer whose K cache is dense
// and pre-rotated, k_pool [NP,P,KV,hd], in pages. Row b of the batch decodes
// at its own position positions[b] (ragged) and owns the pages
// page_table[b, :]; logical key t of row b is pool row
// page_table[b, t / P]·P + t % P. Two variants, by the V pool:
//   dense V     v_pool [NP,P,KV,hd]  → out [B,H,hd]: s_h = Σ_t T(p_t)·V_t[g(h)]
//   V-latent    v_pool [NP,P,Rv]     → out [B,H,Rv]: s_h = Σ_t T(p_t)·tv_t
// with p the online-softmax weights of scale·q·K_t (+ tanh softcap) over
// t ≤ positions[b] (and inside the sliding window), p rounded to the pool's
// type before the V sum, f32 sums, out = s / Σp. The v bias and, for
// V-latent, the A_v up-projection stay in the wrapper.
//
// What bounds it on this card: bytes. Each live key costs one K row and one V
// row per group, B·live·2·KV·hd elements for the step (dense V), against
// 4·rep·hd FLOP per group row: about 1 FLOP per byte in bf16 at MHA, far
// below the ~295 FLOP/byte ridge.
//
// Design: the tile body of kernels 2 and 6 (flash_decode.cuh) with the K
// tile loaded instead of up-projected, and the keys of a row split over
// blocks (flash-decoding):
//   * grid (KV group, row, 128-key chunk); a block walks its chunk's live
//     keys in 32-key tiles and leaves its running max, denominator and
//     numerator in a workspace; a second launch combines a head's chunks.
//     One block per (row, group) with the whole row inside it ran the
//     1024-key rows' 32 tiles as one serial chain on one SM (234 us at the
//     smoke's shapes, H100 at 700 W; 103 us once split). Chunks past a row's last
//     key exit at once. Two blocks fit on an SM (launch bound: 128
//     registers).
//   * The block stages its row of the page table in shared memory once;
//     before each tile 32 threads resolve the tile's keys through it into
//     the shared row tables (one lookup per key, so any page size works and
//     a tile may straddle pages). The group's [32, hd] K rows are loaded
//     into shared memory as f32 with 16-byte loads, all in flight together
//     (row stride hd + 1, so the per-key dot products read it without bank
//     conflicts); the logits, the softmax and the V sum run on the CUDA
//     cores in f32, the V loads of a tile also all in flight together.
//   * Pages past positions[b] / P are never read; the TPU kernel's clamp of
//     trailing logical pages has no counterpart. A slot with no request
//     (page table all 0, position 0) reads key 0 of the scratch page 0 and
//     gives finite values. Tiles wholly before the sliding window are
//     skipped (their weights would be wiped by the first live tile's
//     exp(-1e30 − m) = 0 correction).
//   * V-latent: the group blocks of one row all read the row's same tv rows,
//     KV reads of each, all but the first from L2. One block per row
//     instead would hold the [H, Rv] f32 numerator of all heads (128 KB at
//     H = 32, Rv = 1024) and serialize the groups' K work; the per-group
//     grid keeps one body for both variants.
// Known costs, left for later work: the chain of barriers and load round
// trips inside a tile; dense V uses hd of the 256 threads for the V sum; the
// chunks' partial numerators go through device memory.
//
// Page ids must lie in [0, NP) and positions in [0, MP·P): the engine
// guarantees both, and the kernel does not check them.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

__host__ __device__ constexpr int dense_ld(int HD) { return HD + 1; }

// the tile, then the block's row of the page table
size_t smem_bytes(int HD, int rep, int SV, int MP) {
  return tile_smem_bytes(0, dense_ld(HD), HD, rep, SV) + 4 * (size_t)MP;
}

// kt[t][0, HD) = the tile's K rows in f32, with 16-byte loads (rows are
// 16-byte aligned: the wrapper checks the pool), all issued before the first
// store. A null row (past the row's last key) reads row 0 instead, which every
// tile has; its logits are masked and never read its K.
template <typename T, int HD>
__device__ void load_k_tile(const T* const* rows, float* kt) {
  constexpr int V = 16 / sizeof(T);                       // elements per load
  constexpr int SPR = HD / V;                             // loads per row
  constexpr int N = (kTT * SPR + kThreads - 1) / kThreads;  // loads per thread
  uint4 raw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = min(i / SPR, kTT - 1);
    const T* row = rows[t] != nullptr ? rows[t] : rows[0];
    raw[j] = *reinterpret_cast<const uint4*>(row + (i % SPR) * V);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kTT * SPR) {
      const T* e = reinterpret_cast<const T*>(&raw[j]);
      float* dst = kt + (i / SPR) * dense_ld(HD) + (i % SPR) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) dst[k] = to_f32(e[k]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_dense_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ page_table,
                   const int* __restrict__ positions, float* __restrict__ ws_s,
                   float* __restrict__ ws_ml, int H, int KV, int P, int MP, int SV,
                   int v_latent, float scale, float softcap, int sliding) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KV;
  const Tile<T> s = carve<T>(smem_raw, 0, dense_ld(HD), HD, rep);
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

  tile_init(s, q + head0 * HD, HD, rep, SV);
  const int* pt_b = stage_page_row(smem_raw, tile_smem_bytes(0, dense_ld(HD), HD, rep, SV),
                                   page_table + (size_t)b * MP, MP);
  __syncthreads();  // q, the running state and the page row are in place

  for (int t0 = lo; t0 < hi; t0 += kTT) {
    if (tid < kTT) {
      const int t = t0 + tid;
      const T* rk = nullptr;
      const T* rv = nullptr;
      if (t < hi) {
        const size_t row = (size_t)pt_b[t / P] * P + t % P;
        rk = k_pool + (row * KV + g) * HD;
        rv = v_latent ? v_pool + row * SV : v_pool + (row * KV + g) * HD;
      }
      s.rows_k[tid] = rk;
      s.rows_v[tid] = rv;
    }
    __syncthreads();
    load_k_tile<T, HD>(s.rows_k, s.kt);
    __syncthreads();
    tile_logits<HD>(s.qs, s.kt, dense_ld(HD), s.ps, rep, t0, hi, pos, sliding, scale, softcap);
    __syncthreads();
    tile_softmax(s, rep);
    __syncthreads();
    tile_pv(s, SV, rep, min(kTT, hi - t0));
    __syncthreads();
  }
  tile_store_split(s, ws_s + chunk * rep * SV, ml, SV, rep);
}

template <typename T, int HD>
int launch(const float* q, const void* k_pool, const void* v_pool, const int* pt,
           const int* positions, float* ws, float* out, int B, int H, int KV, int P, int MP,
           int SV, int v_latent, float scale, float softcap, int sliding, cudaStream_t stream) {
  const size_t bytes = smem_bytes(HD, H / KV, SV, MP);
  const int NS = n_splits(MP, P);
  float* ws_ml = ws + (size_t)B * H * NS * SV;
  auto kernel = paged_dense_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(KV, B, NS), kThreads, bytes, stream>>>(
      q, static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), pt, positions, ws,
      ws_ml, H, KV, P, MP, SV, v_latent, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(ws, ws_ml, out, B, H, KV, NS, SV, stream);
}

template <typename T>
int dispatch_hd(int HD, const float* q, const void* k, const void* v, const int* pt,
                const int* pos, float* ws, float* out, int B, int H, int KV, int P, int MP,
                int SV, int vl, float scale, float softcap, int sliding, cudaStream_t st) {
  switch (HD) {
    case 32:
      return launch<T, 32>(q, k, v, pt, pos, ws, out, B, H, KV, P, MP, SV, vl, scale, softcap, sliding, st);
    case 64:
      return launch<T, 64>(q, k, v, pt, pos, ws, out, B, H, KV, P, MP, SV, vl, scale, softcap, sliding, st);
    case 128:
      return launch<T, 128>(q, k, v, pt, pos, ws, out, B, H, KV, P, MP, SV, vl, scale, softcap, sliding, st);
    case 256:
      return launch<T, 256>(q, k, v, pt, pos, ws, out, B, H, KV, P, MP, SV, vl, scale, softcap, sliding, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs; SV is hd (dense V) or Rv (V-latent).
// The wrapper refuses shapes above the 232,448-byte opt-in limit.
extern "C" long long paged_dense_attention_smem_bytes(int head_dim, int rep, int SV, int MP) {
  return (long long)smem_bytes(head_dim, rep, SV, MP);
}

// f32 elements of the workspace a launch needs (the chunks' partial sums).
extern "C" long long paged_dense_attention_workspace(int B, int H, int KV, int SV, int P,
                                                     int MP) {
  return (long long)B * H * n_splits(MP, P) * (SV + 2);
}

// q [B,H,HD] f32; k_pool [NP,P,KV,HD] and v_pool ([NP,P,KV,HD] with
// v_latent 0, [NP,P,SV] with v_latent 1) of `dtype` (0 = float32,
// 1 = bfloat16); page_table [B, MP] and positions [B] int32; ws the f32
// workspace; out [B, H, SV] f32. Two launches on `stream`: the chunks, then
// their combination. Returns cudaGetLastError() (0 = success).
extern "C" int paged_dense_attention_launch(const void* q, const void* k_pool,
                                            const void* v_pool, const void* page_table,
                                            const void* positions, void* ws, void* out, int B,
                                            int H, int KV, int HD, int P, int MP, int SV,
                                            int v_latent, float scale, float softcap,
                                            int sliding, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep || P <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (!v_latent && SV != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch_hd<float>(HD, qf, k_pool, v_pool, pt, pos, w, o, B, H, KV, P, MP, SV,
                              v_latent, scale, softcap, sliding, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, qf, k_pool, v_pool, pt, pos, w, o, B, H, KV, P, MP,
                                      SV, v_latent, scale, softcap, sliding, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_dense_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
