// The split tile of the latent-KV decode kernels for Hopper (sm_90a): the
// form "split_wgmma" of kernel 2 (latent_attention.cu, flat caches) and of
// kernel 6 (paged_latent_attention.cu, page pools). The two differ only in
// where a chunk's 128 latent rows come from, which the caller's producer
// callback says; everything here is shared.
//
// One block owns one (128-key chunk, KV group, batch row). The block is two
// consumer warpgroups (64 keys each) and one producer warp whose lane 0
// streams the chunk's tk rows and A_k[g] over Rk through a 4-stage TMA ring
// (64 Rk columns a stage, 128-byte swizzle), so A_k[g] is read once per 128
// keys. The consumers up-project on wgmma (m64n{hd}k16, f32 accumulators in
// registers); K stays in those registers in f32: the rotate-half pair
// (d, d + hd/2) lies in one thread, so RoPE runs on the accumulators, and
// each key's q·K is an f32 dot over the thread's columns finished by a quad
// shuffle, for each of the group's rep heads. Then per head the chunk's
// max, denominator and T(p) in bf16 (one warp per head), and
// s = Σ T(p)·tv on the tensor cores (mma.sync m16n8k16, heads padded to 16)
// over 64-column tv tiles that the producer streams through the same ring
// (they land while the softmax runs). The chunk's (max, den, s) go to the
// workspace that flash_decode::combine_chunks merges.

#pragma once

#include "flash_decode.cuh"
#include "gemm_sm90.cuh"

namespace latent_split {

using bf16 = __nv_bfloat16;
using flash_decode::kMaxRep;
using flash_decode::kNeg;

constexpr int kChunk = 128;                 // keys per block: two warpgroups of 64
constexpr int kStages = 4;                  // TMA ring depth over Rk
constexpr int kConsumers = 256;             // the two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kPLd = kChunk + 8;  // bf16 row stride of T(p): 272 bytes, so the
                                  // rows one ldmatrix phase reads miss each other's banks

// Shared memory of the tile; a caller's own data follows at tail_offset.
__host__ __device__ inline size_t tail_offset(int HD, int rep) {
  return 1024 + (size_t)kStages * (kChunk + HD) * sm90::kRowBytes + 2 * kStages * 8
         + 4 * ((size_t)rep * HD + (size_t)rep * kChunk) + 2 * (size_t)kMaxRep * kPLd;
}

struct Smem {
  bf16* tks;        // [kStages][kChunk][64] tk, then tv, stages
  bf16* aks;        // [kStages][HD][64] A_k[g] stages
  uint64_t* full;   // [kStages]
  uint64_t* empty;  // [kStages]
  float* qs;        // [rep][HD] f32 query
  float* ps;        // [rep][kChunk] logits
  bf16* pb;         // [kMaxRep][kPLd] T(p), rows >= rep 0
  unsigned char* tail;
};

__device__ inline Smem carve(unsigned char* smem_raw, int HD, int rep) {
  Smem s;
  unsigned char* base = sm90::align1024(smem_raw);
  s.tks = reinterpret_cast<bf16*>(base);
  s.aks = s.tks + (size_t)kStages * kChunk * sm90::kBK;
  s.full = reinterpret_cast<uint64_t*>(s.aks + (size_t)kStages * HD * sm90::kBK);
  s.empty = s.full + kStages;
  s.qs = reinterpret_cast<float*>(s.empty + kStages);
  s.ps = s.qs + rep * HD;
  s.pb = reinterpret_cast<bf16*>(s.ps + rep * kChunk);
  s.tail = reinterpret_cast<unsigned char*>(s.pb + kMaxRep * kPLd);
  return s;
}

// The first live key of a row whose query sits at `pos`: the live keys are
// [window_lo, pos] (pos − sliding + 1 under a sliding window, else 0).
__device__ __forceinline__ int window_lo(int pos, int sliding) {
  return sliding > 0 ? max(0, pos - sliding + 1) : 0;
}

// The grid covers every chunk of a row whatever its position, which lives on
// the device. A block whose chunk [c0, c0 + kChunk) holds no live key of
// [t_lo, pos] marks the chunk empty for its rep heads (den 0, which
// flash_decode::combine_chunks skips) and returns true: the block exits.
__device__ __forceinline__ bool dead_chunk(int c0, int pos, int t_lo, float* ws_ml, int rep) {
  if (c0 <= pos && c0 + kChunk > t_lo) return false;
  flash_decode::mark_empty_split(ws_ml, rep);
  return true;
}

// The group's query heads in f32, the padding rows of T(p) zeroed, the ring
// barriers initialized. The caller synchronizes the block afterwards.
template <typename Q>
__device__ void setup(const Smem& s, const Q* q_heads, int HD, int rep) {
  for (int i = threadIdx.x; i < rep * HD; i += kThreads) s.qs[i] = flash_decode::to_f32(q_heads[i]);
  for (int i = rep * kPLd + threadIdx.x; i < kMaxRep * kPLd; i += kThreads)
    s.pb[i] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&s.full[st], 1);
      sm90::mbar_init(&s.empty[st], 8);  // lane 0 of every consumer warp
    }
    sm90::mbar_fence_init();
  }
}

// Producer lane: KT stages of (tk rows, A_k[g] rows) over Rk, then VT
// stages of tv rows over Rv in the tk slot. `rows(dst, map, col, bar)`
// issues the TMA loads of the chunk's kChunk latent rows of `map`,
// columns [col, col + 64), into dst, all on barrier bar.
template <int HD, typename Rows>
__device__ void produce(const Smem& s, const CUtensorMap* map_tk, const CUtensorMap* map_ak,
                        const CUtensorMap* map_tv, int g, int KT, int VT, Rows rows) {
  constexpr int S = kStages, BK = sm90::kBK;
  for (int i = 0; i < KT + VT; ++i) {
    const int st = i % S;
    if (i >= S) sm90::mbar_wait(&s.empty[st], ((i / S) - 1) & 1);
    bf16* dst = s.tks + (size_t)st * kChunk * BK;
    if (i < KT) {
      sm90::mbar_expect_tx(&s.full[st], (kChunk + HD) * sm90::kRowBytes);
      rows(dst, map_tk, i * BK, &s.full[st]);
      sm90::tma_load_2d(s.aks + (size_t)st * HD * BK, map_ak, i * BK, g * HD, &s.full[st]);
    } else {
      sm90::mbar_expect_tx(&s.full[st], kChunk * sm90::kRowBytes);
      rows(dst, map_tv, (i - KT) * BK, &s.full[st]);
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The consumer warpgroups: keys c0 + [0, kChunk) of which [t_lo, t_hi) are
// live; cos/sin rows of the logical positions (rows past rope_rows − 1
// read the last: those keys are masked). Writes the chunk's max and
// denominator of head r to ws_ml[2r], [2r + 1] and its numerator to
// ws_s[r·Rv + v].
template <int HD>
__device__ void consume(const Smem& s, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, int rope_rows, int c0, int t_lo,
                        int t_hi, int Rv, int rep, int KT, int VT, float scale, float softcap,
                        float* __restrict__ ws_s, float* __restrict__ ws_ml) {
  constexpr int S = kStages, BK = sm90::kBK, HALF = HD / 2, NJ = HD / 8;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;

  // K [64 keys of this warpgroup, HD] = tk · A_k[g]ᵀ in f32 registers
  float acc[HD / 2];  // written first by the kt = 0 products
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % S;
    sm90::mbar_wait(&s.full[st], (kt / S) & 1);
    sm90::wgmma_fence();
    const uint64_t da = sm90::desc_sw128(s.tks + ((size_t)st * kChunk + wg * 64) * BK);
    const uint64_t db = sm90::desc_sw128(s.aks + (size_t)st * HD * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_k16<HD>(acc, sm90::desc_k(da, kk), sm90::desc_k(db, kk), kt > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&s.empty[(kt - 1) % S]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  if (lane == 0) sm90::mbar_arrive(&s.empty[(KT - 1) % S]);

  // acc[4jj + 2h + e]: key key0 + 8h, column 8jj + 2·quad + e
  const int warp = (tid % 128) / 32, quad = lane % 4;
  const int key0 = wg * 64 + warp * 16 + lane / 4;

  // rotate-half RoPE on the accumulators: column d and d + HD/2 sit in the
  // same thread (jj and jj + NJ/2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = min(c0 + key0 + 8 * h, rope_rows - 1);  // keys past it are masked below
    const float* cr = cos_t + (size_t)t * HD;
    const float* sr = sin_t + (size_t)t * HD;
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      const int d = 8 * jj + 2 * quad;
      const float2 c1 = *reinterpret_cast<const float2*>(cr + d);
      const float2 c2 = *reinterpret_cast<const float2*>(cr + d + HALF);
      const float2 s1 = *reinterpret_cast<const float2*>(sr + d);
      const float2 s2 = *reinterpret_cast<const float2*>(sr + d + HALF);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i1 = 4 * jj + 2 * h + e, i2 = 4 * (jj + NJ / 2) + 2 * h + e;
        const float k1 = acc[i1], k2 = acc[i2];
        acc[i1] = k1 * (e ? c1.y : c1.x) + (-k2) * (e ? s1.y : s1.x);
        acc[i2] = k2 * (e ? c2.y : c2.x) + k1 * (e ? s2.y : s2.x);
      }
    }
  }

  // logits: an f32 dot over the thread's columns, finished across the quad
  for (int r = 0; r < rep; ++r) {
    const float* qr = s.qs + r * HD;
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float2 qv = *reinterpret_cast<const float2*>(qr + 8 * jj + 2 * quad);
      dot0 = fmaf(qv.x, acc[4 * jj], dot0);
      dot0 = fmaf(qv.y, acc[4 * jj + 1], dot0);
      dot1 = fmaf(qv.x, acc[4 * jj + 2], dot1);
      dot1 = fmaf(qv.y, acc[4 * jj + 3], dot1);
    }
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
    if (quad == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = c0 + key0 + 8 * h;
        float l = kNeg;
        if (kp >= t_lo && kp < t_hi) {
          l = (h ? dot1 : dot0) * scale;
          if (softcap > 0.f) l = softcap * tanhf(l / softcap);
        }
        s.ps[r * kChunk + key0 + 8 * h] = l;
      }
    }
  }
  consumers_sync();

  // the chunk's softmax, one warp per head: max, denominator, T(p) in bf16
  for (int r = tid / 32; r < rep; r += kConsumers / 32) {
    float l[kChunk / 32];
    float m = kNeg;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      l[i] = s.ps[r * kChunk + lane + 32 * i];
      m = fmaxf(m, l[i]);
    }
    m = flash_decode::warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const float p = expf(l[i] - m);
      sum += p;
      s.pb[r * kPLd + lane + 32 * i] = __float2bfloat16_rn(p);
    }
    sum = flash_decode::warp_sum(sum);
    if (lane == 0) {
      ws_ml[2 * r] = m;
      ws_ml[2 * r + 1] = sum;
    }
  }
  consumers_sync();

  // s[r][v] = Σ_t T(p[r][t])·tv[t][v] on the tensor cores (mma m16n8k16:
  // the heads, padded to 16, times 16 keys times 8 columns), one 64-column
  // tv stage at a time, warp w owning columns 8w..8w+7 of each. Masked keys
  // have T(p) = 0 exactly, so their tv rows add nothing as long as they are
  // finite (rows past the source arrive as 0). The A fragments of T(p) serve
  // every stage; the tv fragments come transposed out of the swizzled stage.
  uint32_t pa[kChunk / 16][4];
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
    sm90::ldsm_x4(pa[kk], s.pb + (lane % 16) * kPLd + kk * 16 + (lane / 16) * 8);
  const int cw = tid / 32;
  for (int vt = 0; vt < VT; ++vt) {
    const int i = KT + vt, st = i % S;
    sm90::mbar_wait(&s.full[st], (i / S) & 1);
    const bf16* tile = s.tks + (size_t)st * kChunk * BK;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int row = kk * 16 + lane % 16;  // lanes 16..31 repeat 0..15 (ignored)
      uint32_t b0, b1;
      sm90::ldsm_x2_trans(b0, b1, tile + row * BK + ((cw ^ (row % 8)) * 8));
      sm90::mma16816(c, pa[kk], b0, b1);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&s.empty[st]);
    // c[2h + e]: head lane/4 + 8h, column 8·cw + 2·(lane % 4) + e
    const int v = vt * BK + cw * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane / 4 + 8 * h;
      if (r < rep && v < Rv)  // Rv % 8 == 0: v and v + 1 both in or both out
        *reinterpret_cast<float2*>(ws_s + (size_t)r * Rv + v) = make_float2(c[2 * h], c[2 * h + 1]);
    }
  }
}

}  // namespace latent_split
