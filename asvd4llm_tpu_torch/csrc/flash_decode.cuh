// Shared tile body of the flash-decoding kernels for Hopper (sm_90a):
// latent_attention.cu (kernel 2, flat latent caches), paged_latent_attention.cu
// (kernel 6, paged latent pools) and paged_dense_attention.cu (kernel 5, paged
// dense K pool).
//
// One block owns one (KV group, batch row) — in the paged kernels one chunk
// of the row's keys, see kSplit — and walks its keys in tiles of kTT = 32.
// Before each tile the kernel fills two row tables in shared
// memory: rows_k[t] and rows_v[t] point at key t0 + t's K (or K-latent) row
// and its V (or V-latent) row, or are null past the row's last live key. A
// flat cache fills them with consecutive rows, a page pool through the page
// table, so one tile body serves every cache layout and any page size. Per
// tile, for the group's rep query heads:
//   logits  l = scale·q·K (+ tanh softcap); keys past pos or before the
//             sliding window → -1e30
//   online softmax: m' = max(m, max l), c = exp(m − m'), p = exp(l − m'),
//             den = den·c + Σp
//   s       = s·c + Σ_t T(p_t)·V_t    (p rounded to the cache type, f32 sum)
// The kernels end with s / den.
//
// Kernels 2 and 6 also up-project each tile's K latents, K = tk·A_k[g]ᵀ in f32
// (up_project below; the bf16 form on the tensor cores), and rotate them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

namespace flash_decode {

constexpr int kThreads = 256;
constexpr int kTT = 32;      // keys per tile (one per lane in the softmax)
constexpr int kRC = 32;      // Rk chunk of the f32 up-projection
constexpr int kKC = 128;     // Rk chunk of the bf16 (tensor-core) up-projection
constexpr int kLDB = kKC + 8;  // bf16 chunk row stride (a multiple of 8 for WMMA)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;  // query heads per KV group
constexpr float kNeg = -1e30f;
constexpr size_t kRowTableBytes = 2 * kTT * sizeof(void*);

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

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// f32 K-tile row stride of the up-projecting kernels (WMMA stores need a
// multiple of 4)
__host__ __device__ constexpr int kt_ld(int HD) { return HD + 4; }

// Staging buffer of the up-projection chunks: f32 [kTT + HD][kRC + 1] or bf16
// [kTT + HD][kLDB], whichever is larger, rounded to 128 bytes.
__host__ __device__ constexpr size_t scratch_bytes(int HD) {
  return round128((size_t)(kTT + HD) * (kRC + 1) * 4 > (size_t)(kTT + HD) * kLDB * 2
                      ? (size_t)(kTT + HD) * (kRC + 1) * 4
                      : (size_t)(kTT + HD) * kLDB * 2);
}

// Shared memory of one block: [scratch][row tables][K tile][q][p][m, den, c][s]
template <typename T>
struct Tile {
  void* scratch;     // up-projection chunks (empty for kernel 5)
  const T** rows_k;  // [kTT]
  const T** rows_v;  // [kTT]
  float* kt;         // [kTT][ld] f32 K tile
  float* qs;         // [rep][HD] f32 query
  float* ps;         // [rep][kTT] logits, then p
  float* ms;         // [rep] running max
  float* ls;         // [rep] denominator
  float* cs;         // [rep] this tile's correction
  float* ss;         // [rep][SV] numerator
};

__host__ __device__ inline size_t tile_smem_bytes(size_t scratch, int ld, int HD, int rep,
                                                  int SV) {
  return scratch + kRowTableBytes
         + 4 * ((size_t)kTT * ld + (size_t)rep * HD + (size_t)rep * kTT + 3 * (size_t)rep
                + (size_t)rep * SV);
}

template <typename T>
__device__ Tile<T> carve(unsigned char* smem, size_t scratch, int ld, int HD, int rep) {
  Tile<T> s;
  s.scratch = smem;
  s.rows_k = reinterpret_cast<const T**>(smem + scratch);
  s.rows_v = s.rows_k + kTT;
  s.kt = reinterpret_cast<float*>(smem + scratch + kRowTableBytes);
  s.qs = s.kt + kTT * ld;
  s.ps = s.qs + rep * HD;
  s.ms = s.ps + rep * kTT;
  s.ls = s.ms + rep;
  s.cs = s.ls + rep;
  s.ss = s.cs + rep;
  return s;
}

// The paged kernels keep their row of the page table in shared memory right
// after the tile (tile_smem_bytes is a multiple of 4): one read of the table
// per block instead of one dependent global read per tile.
__device__ inline const int* stage_page_row(unsigned char* smem, size_t tile_bytes,
                                            const int* pt_b, int MP) {
  int* pts = reinterpret_cast<int*>(smem + tile_bytes);
  for (int i = threadIdx.x; i < MP; i += kThreads) pts[i] = pt_b[i];
  return pts;
}

// q [rep][HD] of the block's heads in f32; m = -1e30, den = 0, s = 0.
template <typename Q, typename T>
__device__ void tile_init(const Tile<T>& s, const Q* q_heads, int HD, int rep, int SV) {
  for (int i = threadIdx.x; i < rep * HD; i += kThreads) s.qs[i] = to_f32(q_heads[i]);
  for (int i = threadIdx.x; i < rep; i += kThreads) {
    s.ms[i] = kNeg;
    s.ls[i] = 0.f;
    s.cs[i] = 1.f;
  }
  for (int i = threadIdx.x; i < rep * SV; i += kThreads) s.ss[i] = 0.f;
}

// kt[kTT][kt_ld(HD)] = tile's K latents · A_k[g]ᵀ in f32 on the CUDA cores.
// A null row is a zero row. (`vec` is the bf16 form's; unused here.)
template <int HD>
__device__ void up_project(const float* const* rows, const float* ak_g, int Rk, void* scratch,
                           float* kt, bool /*vec*/) {
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
      const float* row = rows[t];
      tks[t * (kRC + 1) + k] = (row != nullptr && k0 + k < Rk) ? row[k0 + k] : 0.f;
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

// Eight bf16 values of a row, columns [col, col + 8), of a matrix with row
// length ld; zero for a null row and outside [0, ld). One 16-byte load when
// `vec` (ld % 8 == 0 and 16-byte aligned rows: then a slot is all in or all
// out), else eight scalar loads.
__device__ __forceinline__ uint4 load_slot(const __nv_bfloat16* row, int ld, int col, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row != nullptr && col < ld) {
    const __nv_bfloat16* p = row + col;
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
// chunk's latent and A_k slots are loaded into registers while the tensor
// cores work on the current one, so the L2/HBM latency overlaps the products.
template <int HD>
__device__ void up_project(const __nv_bfloat16* const* rows, const __nv_bfloat16* ak_g, int Rk,
                           void* scratch, float* kt, bool vec) {
  using namespace nvcuda;
  constexpr int NT = (kTT / 16) * (HD / 16);        // 16x16 output fragments
  constexpr int ACC = (NT + kWarps - 1) / kWarps;   // fragments per warp
  constexpr int SPR = kKC / 8;                      // 8-wide slots per chunk row
  constexpr int SLOTS = (kTT + HD) * SPR / kThreads;  // slots per thread
  static_assert((kTT + HD) * SPR % kThreads == 0, "slots divide the block");
  __nv_bfloat16* buf = static_cast<__nv_bfloat16*>(scratch);  // [kTT + HD][kLDB]
  const int warp = threadIdx.x / 32;

  // rows [0, kTT) of the chunk are the tile's latent rows, rows [kTT, kTT + HD)
  // A_k[g] rows
  uint4 regs[SLOTS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / SPR, c = k0 + (i % SPR) * 8;
      regs[j] = r < kTT ? load_slot(rows[r], Rk, c, vec)
                        : load_slot(ak_g + (size_t)(r - kTT) * Rk, Rk, c, vec);
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

// Rotate-half RoPE of the K tile in f32, rows t0 + t < t_hi, with the f32
// cos/sin rows of those logical positions.
template <int HD>
__device__ void tile_rope(float* kt, const float* cos_t, const float* sin_t, int t0, int t_hi) {
  constexpr int HALF = HD / 2;
  constexpr int LD = kt_ld(HD);
  for (int i = threadIdx.x; i < kTT * HALF; i += kThreads) {
    const int t = i / HALF, dd = i % HALF;
    if (t0 + t >= t_hi) continue;
    const float* cr = cos_t + (size_t)(t0 + t) * HD;
    const float* sr = sin_t + (size_t)(t0 + t) * HD;
    const float k1 = kt[t * LD + dd];
    const float k2 = kt[t * LD + dd + HALF];
    kt[t * LD + dd] = k1 * cr[dd] + (-k2) * sr[dd];
    kt[t * LD + dd + HALF] = k2 * cr[dd + HALF] + k1 * sr[dd + HALF];
  }
}

// ps[r][t] = scale·q_r·K_t (+ softcap) for the live keys t0 + t < t_hi inside
// the sliding window, -1e30 for the others.
template <int HD>
__device__ void tile_logits(const float* qs, const float* kt, int ld, float* ps, int rep,
                            int t0, int t_hi, int pos, int sliding, float scale,
                            float softcap) {
  for (int i = threadIdx.x; i < rep * kTT; i += kThreads) {
    const int r = i / kTT, t = i % kTT;
    const int kp = t0 + t;
    float l = kNeg;
    if (kp < t_hi && (sliding <= 0 || kp > pos - sliding)) {
      float dot = 0.f;
      const float* qr = qs + r * HD;
      const float* kr = kt + t * ld;
#pragma unroll 8
      for (int e = 0; e < HD; ++e) dot = fmaf(qr[e], kr[e], dot);
      l = dot * scale;
      if (softcap > 0.f) l = softcap * tanhf(l / softcap);
    }
    ps[i] = l;
  }
}

// Online softmax over the tile, one warp per head; p is left in ps rounded to
// the cache type T, the correction in cs.
template <typename T>
__device__ void tile_softmax(const Tile<T>& s, int rep) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rep; r += kWarps) {
    const float l = s.ps[r * kTT + lane];
    const float m_prev = s.ms[r];
    const float m_new = fmaxf(m_prev, warp_max(l));
    const float corr = expf(m_prev - m_new);
    const float p = expf(l - m_new);
    const float sum = warp_sum(p);
    s.ps[r * kTT + lane] = to_f32(from_f32<T>(p));
    if (lane == 0) {
      s.ls[r] = s.ls[r] * corr + sum;
      s.ms[r] = m_new;
      s.cs[r] = corr;
    }
  }
}

// s = s·c + Σ_{t < tn} T(p_t) · V_t over the tile's first tn rows of width SV
// (the keys after them have p = 0); each thread owns whole columns of s, two
// at a time. A round's loads are all issued before its first product,
// unconditionally (rows past tn read row 0, which every tile has, and are not
// summed), so they are in flight together instead of one round trip each.
template <typename T>
__device__ void tile_pv(const Tile<T>& s, int SV, int rep, int tn) {
  for (int v0 = threadIdx.x; v0 < SV; v0 += 2 * kThreads) {
    const bool two = v0 + kThreads < SV;
    const int v1 = two ? v0 + kThreads : v0;
    T x0[kTT], x1[kTT];
#pragma unroll
    for (int t = 0; t < kTT; ++t) {
      const T* row = s.rows_v[t < tn ? t : 0];
      x0[t] = row[v0];
      x1[t] = row[v1];
    }
    float a0[kMaxRep], a1[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) {
        a0[r] = s.ss[r * SV + v0] * s.cs[r];
        a1[r] = s.ss[r * SV + v1] * s.cs[r];
      }
#pragma unroll
    for (int t = 0; t < kTT; ++t) {
      if (t < tn) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) {
            a0[r] = fmaf(s.ps[r * kTT + t], to_f32(x0[t]), a0[r]);
            a1[r] = fmaf(s.ps[r * kTT + t], to_f32(x1[t]), a1[r]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) {
        s.ss[r * SV + v0] = a0[r];
        if (two) s.ss[r * SV + v1] = a1[r];
      }
  }
}

// One tile of kernels 2 and 6: up-project and rotate the tile's K latents,
// then logits, online softmax and the absorbed-V numerator.
template <typename T, int HD>
__device__ void latent_tile(const Tile<T>& s, const T* ak_g, const float* cos_t,
                            const float* sin_t, int Rk, int Rv, int rep, int t0, int t_hi,
                            int pos, int sliding, float scale, float softcap, bool vec) {
  up_project<HD>(s.rows_k, ak_g, Rk, s.scratch, s.kt, vec);
  __syncthreads();
  tile_rope<HD>(s.kt, cos_t, sin_t, t0, t_hi);
  __syncthreads();
  tile_logits<HD>(s.qs, s.kt, kt_ld(HD), s.ps, rep, t0, t_hi, pos, sliding, scale, softcap);
  __syncthreads();
  tile_softmax(s, rep);
  __syncthreads();
  tile_pv(s, Rv, rep, min(kTT, t_hi - t0));
  __syncthreads();
}

// out[r][v] = s[r][v] / den[r] for the block's heads.
template <typename T>
__device__ void tile_finish(const Tile<T>& s, float* out_heads, int SV, int rep) {
  for (int i = threadIdx.x; i < rep * SV; i += kThreads) out_heads[i] = s.ss[i] / s.ls[i / SV];
}

// ---- split keys (the paged kernels) ---------------------------------------
// The paged kernels split each row's keys into chunks of kSplit keys, one
// block per (KV group, row, chunk), so a long row's tiles run on many SMs at
// once. A block leaves its chunk's running max, denominator and numerator
// (not divided) in a workspace: ws_ml [B, KV, NS, rep, 2] and ws_s [B, KV,
// NS, rep, SV] f32, with den = 0 marking a chunk that holds no live key; a
// second launch (combine_chunks) combines the chunks of each head:
//   M = max_j m_j,  w_j = exp(m_j − M),  out = Σ_j w_j·s_j / Σ_j w_j·den_j
constexpr int kSplit = 128;  // keys per chunk, a multiple of kTT

template <typename T>
__device__ void tile_store_split(const Tile<T>& s, float* ws_s, float* ws_ml, int SV, int rep) {
  for (int i = threadIdx.x; i < rep * SV; i += kThreads) ws_s[i] = s.ss[i];
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    ws_ml[2 * r] = s.ms[r];
    ws_ml[2 * r + 1] = s.ls[r];
  }
}

__device__ inline void mark_empty_split(float* ws_ml, int rep) {
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    ws_ml[2 * r] = kNeg;
    ws_ml[2 * r + 1] = 0.f;
  }
}

// out[b][h][v] = Σ_j e^(m_j − M)·s_j / Σ_j e^(m_j − M)·den_j over the chunks
// j of head h with den_j > 0, one thread per output value: the second launch
// of every split kernel (2, 5 and 6, every form). Grid (cdiv(SV, kThreads),
// H, B); out [B, H, SV] f32.
__global__ void __launch_bounds__(kThreads)
combine_chunks(const float* __restrict__ ws_s, const float* __restrict__ ws_ml,
               float* __restrict__ out, int H, int KV, int NS, int SV) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (v >= SV) return;
  const int rep = H / KV, g = h / rep, r = h % rep;
  const size_t base = ((size_t)b * KV + g) * NS;
  // Unrolled so that a thread's loads of several chunks are in flight
  // together: one dependent round trip per chunk set this launch's time. A
  // chunk with no live key left its numerator unwritten; it is loaded with
  // the others and not summed.
  float M = kNeg;
#pragma unroll 8
  for (int j = 0; j < NS; ++j) {
    const float* ml = ws_ml + ((base + j) * rep + r) * 2;
    if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
  }
  float den = 0.f, num = 0.f;
#pragma unroll 8
  for (int j = 0; j < NS; ++j) {
    const float* ml = ws_ml + ((base + j) * rep + r) * 2;
    const float m = ml[0], l = ml[1], s = ws_s[((base + j) * rep + r) * SV + v];
    if (l > 0.f) {
      const float w = expf(m - M);
      den = fmaf(w, l, den);
      num = fmaf(w, s, num);
    }
  }
  out[((size_t)b * H + h) * SV + v] = num / den;
}

inline cudaError_t launch_combine(const float* ws_s, const float* ws_ml, float* out, int B,
                                  int H, int KV, int NS, int SV, cudaStream_t stream) {
  combine_chunks<<<dim3((SV + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
      ws_s, ws_ml, out, H, KV, NS, SV);
  return cudaGetLastError();
}

// Number of chunks of a row of MP·P keys.
__host__ __device__ inline int n_splits(int MP, int P) { return (MP * P + kSplit - 1) / kSplit; }

}  // namespace flash_decode
