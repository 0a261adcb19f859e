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
// Forms, chosen by the wrapper (`ops/paged_attention.py::_dense_form`) and
// passed in:
//   * "split_tma" (bf16, hd 64 or 128, SV a multiple of 8, 16-byte aligned
//     pools, page size P a power of two of at least 8): one block per
//     (64-key chunk, head block, row), MP·P/64 chunks a row whatever the
//     positions (they live on the device, and paged_decode_scan runs steps
//     with no host sync between them); a block whose chunk holds no live key
//     marks its heads' chunk empty and exits. A head block is one KV group
//     for dense V (each group has its own V rows) and, for V-latent, the
//     G KV groups of up to 8 heads that the launcher picks (`head_groups`),
//     so a row's tv is read KV / G times instead of KV times. One producer warp
//     loads the chunk's rows by TMA into a ring: the K pool through a 4-D
//     tensor map (column, group, row in page, page), one box per page of the
//     chunk (one 64-row box for P >= 64, 64/P boxes of P rows otherwise,
//     each at its own page id, staged from the page table; pages outside the
//     live ones clamped to the nearest live page, as kernel 6 does, since
//     masked keys need finite rows), 64 columns a box with the 128-byte
//     swizzle; then the V rows of the group (dense) or the chunk's tv in
//     128-column slices (V-latent, a 3-D map (column, row in page, page)).
//     So all of a chunk's loads are in flight at once (dense V: the ring
//     holds K and V together), not one 32-key tile after another. The eight
//     consumer warps compute the logits of every head of the block on the
//     CUDA cores in f32 (eight lanes a key, each over 16-byte chunks that the
//     swizzle puts in distinct banks), the chunk's softmax (one warp a head:
//     max, denominator, T(p) in bf16 into shared memory), then
//     s = Σ_t T(p)·V on mma.sync m16n8k16 with Vᵀ (or tvᵀ) as the 16-row
//     operand (ldmatrix.trans out of the swizzled stage) and the heads on
//     the 8-wide side, each warp 16 columns of a stage, writing its f32
//     partial numerator straight to the workspace: no numerator stays live
//     across stages.
//   * "tile32" (f32, other head dims and page sizes, rows not 16-byte
//     aligned): the first design, the tile body of kernels 2 and 6
//     (flash_decode.cuh) with the K tile loaded instead of up-projected:
//     grid (KV group, row, 128-key chunk); a block walks its chunk's live
//     keys in 32-key tiles, each tile's keys resolved through the row's
//     page table, staged in shared memory, into the shared row tables (one
//     lookup per key, so any page size works and a tile may straddle
//     pages); the group's [32, hd] K rows loaded into shared memory as f32
//     with 16-byte loads, all in flight together; logits, softmax and the V
//     sum on the CUDA cores in f32. Pages past positions[b] / P are never
//     read. Its known costs: a chain of barriers and load round trips for
//     every 32-key tile; dense V uses hd of the 256 threads for the V sum;
//     V-latent's KV group blocks of a row all read the row's tv.
// Both leave each chunk's running max, denominator and numerator in a
// workspace that a second launch (flash_decode::combine_chunks) merges. A
// slot with no request (page table all 0, position 0) reads key 0 of the
// scratch page 0 and gives finite values, which the engine ignores.
// split_tma reads the rows of a live chunk's pages past positions[b]
// (masked, p = 0), which must be finite, as the engine's pools are.
// Known costs of split_tma, for later work: each block loads one chunk and
// exits, so no block's loads overlap its own compute (a persistent block
// walking chunks through the ring would); 288 threads at 72 registers let
// three blocks share an SM; the combine launch reads the partial sums back.
//
// Page ids must lie in [0, NP) and positions in [0, MP·P): the engine
// guarantees both, and the kernel does not check them.

#include "flash_decode.cuh"
#include "gemm_sm90.cuh"

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
  cudaError_t err = sm90::allow_smem(kernel, bytes);
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

// ---- the split form ("split_tma") ------------------------------------------

namespace ds {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;               // keys per block
constexpr int kConsumers = 256;          // eight consumer warps
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kHalf = kChunk * sm90::kRowBytes;  // bytes of 64 rows of one 64-column box
constexpr int kSlot = 2 * kHalf;         // a ring stage: two 64-column halves
constexpr int kPLd = kChunk + 8;         // bf16 row stride of T(p): 144 bytes, so the
                                         // rows one ldmatrix phase reads miss each other's banks
constexpr int kMaxBoxes = kChunk / 8;    // boxes of a chunk's rows (pages of 8 rows)
constexpr int kVSlice = 128;             // tv columns of a V-latent stage
constexpr int kHeadBlock = 8;            // query heads a V-latent block aims at

// Ring depth: dense V holds a group's K and V at once; V-latent streams
// the head block's K and its tv slices through four stages.
__host__ __device__ constexpr int stages(bool vlat) { return vlat ? 4 : 2; }

__host__ __device__ constexpr size_t smem_bytes(int HD, bool vlat) {
  return 1024 + (size_t)stages(vlat) * kSlot + 16 * (size_t)stages(vlat)
         + 4 * ((size_t)kMaxRep * HD + (size_t)kMaxRep * kChunk) + 2 * (size_t)kMaxRep * kPLd
         + 4 * (size_t)kMaxBoxes;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Block (chunk j, head block hb, row b): the keys [64j, 64j + 64) of row b
// for heads g0·rep .. (g0 + G)·rep of groups g0 = hb·G ..; ws_ml [B, KV, NS,
// rep, 2] and ws_s [B, KV, NS, rep, SV] as the tile32 form, NS = MP·P/64.
// Ring items: the K rows of each of the G groups, then (dense) the V rows
// of the group or (V-latent) the chunk's tv in 128-column slices.
template <int HD, bool VLAT>
__global__ void __launch_bounds__(kThreads)
paged_dense_split_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const float* __restrict__ q,
                         const int* __restrict__ page_table, const int* __restrict__ positions,
                         float* __restrict__ ws_s, float* __restrict__ ws_ml, int H, int KV,
                         int P, int MP, int SV, int G, float scale, float softcap, int sliding) {
  constexpr int S = stages(VLAT), NH = HD / 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = sm90::align1024(smem_raw);             // [S][2][64][64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)S * kSlot);
  uint64_t* empty = full + S;
  float* qs = reinterpret_cast<float*>(empty + S);             // [HB][HD]
  float* ps = qs + kMaxRep * HD;                               // [HB][kChunk] logits
  bf16* pb = reinterpret_cast<bf16*>(ps + kMaxRep * kChunk);   // [16][kPLd] T(p), rows >= HB 0
  int* pid = reinterpret_cast<int*>(pb + kMaxRep * kPLd);      // [kMaxBoxes] page ids

  const int j = blockIdx.x, b = blockIdx.z;
  const int NS = gridDim.x;
  const int rep = H / KV, HB = G * rep, g0 = blockIdx.y * G;
  const int tid = threadIdx.x;
  const int pos = positions[b];
  const int t_lo = sliding > 0 ? max(0, pos - sliding + 1) : 0;
  const int c0 = j * kChunk;
  // workspace row of the block's head h
  auto slot = [&](int h) {
    return (((size_t)b * KV + g0 + h / rep) * NS + j) * rep + h % rep;
  };
  if (c0 > pos || c0 + kChunk <= t_lo) {  // no live key in this chunk
    for (int h = tid; h < HB; h += kThreads) {
      ws_ml[2 * slot(h)] = kNeg;
      ws_ml[2 * slot(h) + 1] = 0.f;
    }
    return;
  }

  const float* qh = q + ((size_t)b * H + (size_t)g0 * rep) * HD;
  for (int i = tid; i < HB * HD; i += kThreads) qs[i] = qh[i];
  for (int i = tid; i < kMaxRep * kPLd; i += kThreads) pb[i] = __float2bfloat16_rn(0.f);
  const int nbox = P >= kChunk ? 1 : kChunk / P;
  const int box_rows = P >= kChunk ? kChunk : P;
  if (tid < nbox) {
    // logical pages outside [t_lo / P, pos / P] hold no live key: their
    // boxes load the nearest live page (masked keys, finite rows)
    const int lp = P >= kChunk ? c0 / P : min(max(c0 / P + tid, t_lo / P), pos / P);
    pid[tid] = page_table[(size_t)b * MP + lp];
  }
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], kConsumers / 32);  // lane 0 of every consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int VT = VLAT ? (SV + kVSlice - 1) / kVSlice : G;  // V items
  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      const int r0 = P >= kChunk ? c0 % P : 0;
      for (int i = 0; i < G + VT; ++i) {
        const int st = i % S;
        if (i >= S) sm90::mbar_wait(&empty[st], ((i / S) - 1) & 1);
        unsigned char* dst = ring + (size_t)st * kSlot;
        if (i < G || !VLAT) {  // K rows of group g0 + i, or V rows of group g0 + i − G
          const CUtensorMap* map = i < G ? &map_k : &map_v;
          const int g = g0 + (i < G ? i : i - G);
          sm90::mbar_expect_tx(&full[st], NH * kHalf);
          for (int h = 0; h < NH; ++h)
            for (int x = 0; x < nbox; ++x)
              sm90::tma_load_4d(dst + h * kHalf + x * box_rows * sm90::kRowBytes, map, h * 64, g,
                                r0, pid[x], &full[st]);
        } else {  // tv columns [128·vs, 128·vs + 128) of the chunk's keys
          const int vs = i - G;
          const int nh = min(2, (SV - vs * kVSlice + 63) / 64);
          sm90::mbar_expect_tx(&full[st], nh * kHalf);
          for (int h = 0; h < nh; ++h)
            for (int x = 0; x < nbox; ++x)
              sm90::tma_load_3d(dst + h * kHalf + x * box_rows * sm90::kRowBytes, &map_v,
                                vs * kVSlice + h * 64, r0, pid[x], &full[st]);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  // logits: eight lanes a key, lane `part` over the 16-byte chunks `part` of
  // each 64-column half (the swizzle puts a key's eight chunks in distinct
  // banks); every head of the group on the same K registers
  const int part = lane % 8;
  for (int gi = 0; gi < G; ++gi) {
    const int st = gi % S;
    sm90::mbar_wait(&full[st], (gi / S) & 1);
    const unsigned char* kt = ring + (size_t)st * kSlot;
#pragma unroll
    for (int pass = 0; pass < kChunk / 32; ++pass) {
      const int t = pass * 32 + warp * 4 + lane / 8;
      float kf[NH][8];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint4 v = *reinterpret_cast<const uint4*>(kt + h * kHalf + t * sm90::kRowBytes +
                                                        ((part ^ (t % 8)) * 16));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) kf[h][k] = __bfloat162float(e[k]);
      }
      const int kp = c0 + t;
      const bool live = kp >= t_lo && kp <= pos;
      for (int r = 0; r < rep; ++r) {
        const int hh = gi * rep + r;
        const float* qr = qs + hh * HD + part * 8;
        float dot = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float4 qa = *reinterpret_cast<const float4*>(qr + h * 64);
          const float4 qb = *reinterpret_cast<const float4*>(qr + h * 64 + 4);
          dot = fmaf(qa.x, kf[h][0], dot);
          dot = fmaf(qa.y, kf[h][1], dot);
          dot = fmaf(qa.z, kf[h][2], dot);
          dot = fmaf(qa.w, kf[h][3], dot);
          dot = fmaf(qb.x, kf[h][4], dot);
          dot = fmaf(qb.y, kf[h][5], dot);
          dot = fmaf(qb.z, kf[h][6], dot);
          dot = fmaf(qb.w, kf[h][7], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (part == 0) {
          float l = kNeg;
          if (live) {
            l = dot * scale;
            if (softcap > 0.f) l = softcap * tanhf(l / softcap);
          }
          ps[hh * kChunk + t] = l;
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }
  consumers_sync();

  // the chunk's softmax, one warp per head: max, denominator, T(p) in bf16
  for (int h = warp; h < HB; h += kConsumers / 32) {
    const float l0 = ps[h * kChunk + lane], l1 = ps[h * kChunk + 32 + lane];
    const float m = flash_decode::warp_max(fmaxf(l0, l1));
    const float p0 = expf(l0 - m), p1 = expf(l1 - m);
    const float sum = flash_decode::warp_sum(p0 + p1);
    pb[h * kPLd + lane] = __float2bfloat16_rn(p0);
    pb[h * kPLd + 32 + lane] = __float2bfloat16_rn(p1);
    if (lane == 0) {
      ws_ml[2 * slot(h)] = m;
      ws_ml[2 * slot(h) + 1] = sum;
    }
  }
  consumers_sync();

  // s[h][v] = Σ_t T(p[h][t])·V[t][v] as sᵀ = Vᵀ·T(p)ᵀ on mma m16n8k16: 16
  // columns v (warp w owns stage columns 16w..16w+15) times 16 keys times 8
  // heads; Vᵀ comes transposed out of the swizzled stage, T(p)ᵀ from pb.
  // Masked keys have T(p) = 0 exactly, so their (finite) rows add nothing.
  const int NHT = (HB + 7) / 8;  // head tiles of 8
  uint32_t pf[2][kChunk / 16][2];
#pragma unroll
  for (int ht = 0; ht < 2; ++ht)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      if (ht < NHT)
        sm90::ldsm_x2(pf[ht][kk][0], pf[ht][kk][1],
                      pb + (ht * 8 + lane % 8) * kPLd + kk * 16 + ((lane / 8) % 2) * 8);
  constexpr int kWidth = VLAT ? kVSlice : HD;  // V columns a stage holds
  for (int vi = 0; vi < VT; ++vi) {
    const int i = G + vi, st = i % S;
    sm90::mbar_wait(&full[st], (i / S) & 1);
    const unsigned char* tile = ring + (size_t)st * kSlot;
    const int v0 = warp * 16;
    const int col0 = VLAT ? vi * kVSlice : 0;
    if (v0 < kWidth && col0 + v0 < SV) {
      float c[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const int t = kk * 16 + (lane / 16) * 8 + lane % 8;
        const int v = v0 + ((lane / 8) % 2) * 8;
        uint32_t a[4];
        sm90::ldsm_x4_trans(a, tile + (v / 64) * kHalf + t * sm90::kRowBytes +
                                   ((((v % 64) / 8) ^ (t % 8)) * 16));
#pragma unroll
        for (int ht = 0; ht < 2; ++ht)
          if (ht < NHT) sm90::mma16816(c[ht], a, pf[ht][kk][0], pf[ht][kk][1]);
      }
      // c[ht][2·hi + e]: column v0 + lane/4 + 8·hi, head 8·ht + 2·(lane % 4) + e
#pragma unroll
      for (int ht = 0; ht < 2; ++ht)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = ht * 8 + 2 * (lane % 4) + (e & 1);
          const int v = col0 + v0 + lane / 4 + (e >> 1) * 8;
          if (ht < NHT && h < HB && v < SV) ws_s[slot(h) * SV + v] = c[ht][e];
        }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }
}

// A 4-D map over a dense pool [NP, P, KV, HD] bf16: (column, group, row in
// page, page), boxes of 64 columns and min(P, 64) rows of one group and page.
cudaError_t encode_dense_pool(CUtensorMap* map, const void* pool, int NP, int P, int KV, int HD) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)P, (cuuint64_t)NP};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)KV * HD * 2,
                                 (cuuint64_t)P * KV * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)(P < kChunk ? P : kChunk), 1};
  return sm90::encode_map(map, 4, pool, dims, strides, box);
}

// A 3-D map over a latent pool [NP, P, R] bf16: (column, row in page, page).
cudaError_t encode_latent_pool(CUtensorMap* map, const void* pool, int NP, int P, int R) {
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)P, (cuuint64_t)NP};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 2, (cuuint64_t)P * R * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)(P < kChunk ? P : kChunk), 1};
  return sm90::encode_map(map, 3, pool, dims, strides, box);
}

template <int HD, bool VLAT>
int launch(const float* q, const void* k_pool, const void* v_pool, const int* pt,
           const int* positions, float* ws, float* out, int B, int H, int KV, int NP, int P,
           int MP, int SV, int G, float scale, float softcap, int sliding, cudaStream_t stream) {
  CUtensorMap mk, mv;
  cudaError_t err = encode_dense_pool(&mk, k_pool, NP, P, KV, HD);
  if (err != cudaSuccess) return (int)err;
  err = VLAT ? encode_latent_pool(&mv, v_pool, NP, P, SV)
             : encode_dense_pool(&mv, v_pool, NP, P, KV, HD);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = smem_bytes(HD, VLAT);
  auto kernel = paged_dense_split_kernel<HD, VLAT>;
  err = sm90::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int NS = (MP * P + kChunk - 1) / kChunk;
  float* ws_ml = ws + (size_t)B * H * NS * SV;
  kernel<<<dim3(NS, KV / G, B), kThreads, bytes, stream>>>(
      mk, mv, q, pt, positions, ws, ws_ml, H, KV, P, MP, SV, G, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(ws, ws_ml, out, B, H, KV, NS, SV, stream);
}

// KV groups one block covers: one for dense V (each group has its own V
// rows); for V-latent, whose tv rows every head shares, the largest divisor
// of KV whose heads fit in kHeadBlock, so that a row's tv is read KV / G
// times instead of KV times. A head's result does not depend on G.
int head_groups(int KV, int rep, bool vlat) {
  int G = 1;
  for (int g = 2; vlat && g <= KV; ++g)
    if (KV % g == 0 && g * rep <= kHeadBlock) G = g;
  return G;
}

int launch_split(int HD, bool vlat, const float* q, const void* k, const void* v, const int* pt,
                 const int* pos, float* ws, float* out, int B, int H, int KV, int NP, int P,
                 int MP, int SV, float scale, float softcap, int sliding, cudaStream_t st) {
  if (P < 8 || (P & (P - 1)) != 0 || SV % 8 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = head_groups(KV, H / KV, vlat);
  if (HD == 64 && vlat)
    return launch<64, true>(q, k, v, pt, pos, ws, out, B, H, KV, NP, P, MP, SV, G, scale, softcap, sliding, st);
  if (HD == 64)
    return launch<64, false>(q, k, v, pt, pos, ws, out, B, H, KV, NP, P, MP, SV, G, scale, softcap, sliding, st);
  if (HD == 128 && vlat)
    return launch<128, true>(q, k, v, pt, pos, ws, out, B, H, KV, NP, P, MP, SV, G, scale, softcap, sliding, st);
  if (HD == 128)
    return launch<128, false>(q, k, v, pt, pos, ws, out, B, H, KV, NP, P, MP, SV, G, scale, softcap, sliding, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ds

}  // namespace

// Shared memory (bytes) one block of a form needs, at most (split_tma: the
// V-latent ring, the deeper one); SV is hd (dense V) or Rv (V-latent). The
// wrapper refuses shapes above the 232,448-byte opt-in limit.
extern "C" long long paged_dense_attention_smem_bytes(int head_dim, int rep, int SV, int MP,
                                                      int form) {
  return (long long)(form == 1 ? ds::smem_bytes(head_dim, true)
                               : smem_bytes(head_dim, rep, SV, MP));
}

// f32 elements of the workspace a launch of a form needs (the chunks'
// partial sums: 128-key chunks for tile32, 64-key chunks for split_tma).
extern "C" long long paged_dense_attention_workspace(int B, int H, int KV, int SV, int P,
                                                     int MP, int form) {
  const long long NS = form == 1 ? (MP * P + ds::kChunk - 1) / ds::kChunk : n_splits(MP, P);
  return (long long)B * H * NS * (SV + 2);
}

// q [B,H,HD] f32; k_pool [NP,P,KV,HD] and v_pool ([NP,P,KV,HD] with
// v_latent 0, [NP,P,SV] with v_latent 1) of `dtype` (0 = float32,
// 1 = bfloat16); page_table [B, MP] and positions [B] int32; ws the f32
// workspace; out [B, H, SV] f32. form: 0 = "tile32", 1 = "split_tma"
// (bf16, HD 64 or 128, SV a multiple of 8, P a power of two >= 8, aligned
// pools). Two
// launches on `stream`: the chunks, then their combination. Returns
// cudaGetLastError() (0 = success), cudaErrorInvalidValue for a form the
// shape does not allow.
extern "C" int paged_dense_attention_launch(const void* q, const void* k_pool,
                                            const void* v_pool, const void* page_table,
                                            const void* positions, void* ws, void* out, int B,
                                            int H, int KV, int HD, int NP, int P, int MP, int SV,
                                            int v_latent, int form, float scale,
                                            float softcap, int sliding, int dtype,
                                            void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep || P <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (!v_latent && SV != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* pt = static_cast<const int*>(page_table);
  const int* pos = static_cast<const int*>(positions);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return ds::launch_split(HD, v_latent != 0, qf, k_pool, v_pool, pt, pos, w, o, B, H, KV, NP,
                            P, MP, SV, scale, softcap, sliding, st);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
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
