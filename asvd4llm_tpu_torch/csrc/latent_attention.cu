// Latent-KV flash-decoding attention for Hopper (sm_90a).
//
// Replaces asvd4llm_tpu/ops/pallas_latent_attention.py::_latent_attention_core
// (bodies `_kernel` and `_online_tile`, public wrapper
// `latent_decode_attention`): one decode step of a layer whose k and v
// projections are low-rank and whose cache holds the rank-dim latents
// tk [B,T,Rk] and tv [B,T,Rv] instead of K and V.
//
// For every query head h of KV group g, over the live keys
// [pos - sliding + 1, pos] of the row:
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
//     aligned caches): one block per (128-key chunk, KV group, batch row);
//     chunks wholly outside the live window are not launched. The block is
//     two consumer warpgroups (64 keys each) and one producer warp whose lane
//     0 streams the chunk's tk rows and A_k[g] over Rk through a 4-stage TMA
//     ring (64 Rk columns a stage, 128-byte swizzle), so A_k[g] is read once
//     per 128 keys instead of once per 32. The consumers up-project on wgmma
//     (m64n{hd}k16, f32 accumulators in registers); K stays in those
//     registers in f32: the rotate-half pair (d, d + hd/2) lies in one
//     thread, so RoPE runs on the accumulators, and each key's q·K is an f32
//     dot over the thread's columns finished by a quad shuffle, for each of
//     the group's rep heads. Then per head the chunk's max, denominator and
//     T(p) in bf16 (one warp per head), and s = Σ T(p)·tv on the tensor
//     cores (mma.sync m16n8k16, heads padded to 16) over 64-column tv tiles
//     that the producer streams through the same ring (they land while the
//     softmax runs).
//     The chunk's (max, den, s) go to a workspace and a second launch
//     merges the chunks with kernels 5 and 6's arithmetic, one thread per
//     output value:
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

#include "flash_decode.cuh"
#include "gemm_sm90.cuh"

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

// ---- the split form ("split_wgmma") -----------------------------------------

constexpr int kChunk = 128;                   // keys per block: two warpgroups of 64
constexpr int kSplitStages = 4;               // TMA ring depth over Rk
constexpr int kConsumers = 256;               // the two consumer warpgroups
constexpr int kSplitThreads = kConsumers + 32;  // + the producer warp

constexpr int kPLd = kChunk + 8;  // bf16 row stride of T(p): 272 bytes, so the
                                  // rows one ldmatrix phase reads miss each other's banks

__host__ __device__ inline size_t split_smem_bytes(int HD, int rep) {
  return 1024 + (size_t)kSplitStages * (kChunk + HD) * sm90::kRowBytes + 2 * kSplitStages * 8
         + 4 * ((size_t)rep * HD + (size_t)rep * kChunk) + 2 * (size_t)kMaxRep * kPLd;
}

// The live keys [t_lo, t_hi) of a row and the chunks that hold them.
struct Window {
  int t_lo, t_hi, c_lo, n;
};
__host__ __device__ inline Window key_window(int T_len, int pos, int sliding) {
  Window w;
  w.t_hi = T_len < pos + 1 ? T_len : pos + 1;
  w.t_lo = sliding > 0 && pos - sliding + 1 > 0 ? pos - sliding + 1 : 0;
  w.c_lo = w.t_lo / kChunk;
  w.n = (w.t_hi + kChunk - 1) / kChunk - w.c_lo;
  return w;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Block (chunk j, group g, row b): the chunk's running max, denominator and
// numerator s for the group's rep heads into ws_ml [B, KV, NS, rep, 2] and
// ws_s [B, KV, NS, rep, Rv].
template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 1)
latent_split_kernel(const __grid_constant__ CUtensorMap map_tk,
                    const __grid_constant__ CUtensorMap map_ak,
                    const __grid_constant__ CUtensorMap map_tv, const __nv_bfloat16* __restrict__ q,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    float* __restrict__ ws_s, float* __restrict__ ws_ml, int H, int KV, int T_len,
                    int Rk, int Rv, int pos, float scale, float softcap, int sliding) {
  using bf16 = __nv_bfloat16;
  constexpr int S = kSplitStages, BK = sm90::kBK, HALF = HD / 2, NJ = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  bf16* tks = reinterpret_cast<bf16*>(base);                      // [S][kChunk][64]
  bf16* aks = tks + (size_t)S * kChunk * BK;                      // [S][HD][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(aks + (size_t)S * HD * BK);
  uint64_t* empty = full + S;
  const int rep = H / KV;
  float* qs = reinterpret_cast<float*>(empty + S);                // [rep][HD]
  float* ps = qs + rep * HD;                                      // [rep][kChunk]
  bf16* pb = reinterpret_cast<bf16*>(ps + rep * kChunk);          // [16][kPLd] T(p), rows >= rep 0
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const Window w = key_window(T_len, pos, sliding);
  const int c0 = (w.c_lo + j) * kChunk;
  const size_t split = ((size_t)b * KV + g) * gridDim.x + j;
  const int KT = (Rk + BK - 1) / BK;  // ring steps of the up-projection
  const int VT = (Rv + BK - 1) / BK;  // then of the tv sum
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;

  for (int i = tid; i < rep * HD; i += kSplitThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + (size_t)g * rep) * HD + i]);
  for (int i = rep * kPLd + tid; i < kMaxRep * kPLd; i += kSplitThreads)
    pb[i] = __float2bfloat16_rn(0.f);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // producer warp: the chunk's tk rows and A_k[g], 64 Rk columns a stage,
  // then the chunk's tv rows, 64 Rv columns a stage (in the tk slot): they
  // arrive while the consumers run the softmax
  if (wg == 2) {
    if (lane == 0) {
      for (int i = 0; i < KT + VT; ++i) {
        const int s = i % S;
        if (i >= S) sm90::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        if (i < KT) {
          sm90::mbar_expect_tx(&full[s], (kChunk + HD) * sm90::kRowBytes);
          sm90::tma_load_3d(tks + (size_t)s * kChunk * BK, &map_tk, i * BK, c0, b, &full[s]);
          sm90::tma_load_2d(aks + (size_t)s * HD * BK, &map_ak, i * BK, g * HD, &full[s]);
        } else {
          sm90::mbar_expect_tx(&full[s], kChunk * sm90::kRowBytes);
          sm90::tma_load_3d(tks + (size_t)s * kChunk * BK, &map_tv, (i - KT) * BK, c0, b,
                            &full[s]);
        }
      }
    }
    return;
  }

  // K [64 keys of this warpgroup, HD] = tk · A_k[g]ᵀ in f32 registers
  float acc[HD / 2];  // written first by the kt = 0 products
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    sm90::mbar_wait(&full[s], (kt / S) & 1);
    sm90::wgmma_fence();
    const uint64_t da = sm90::desc_sw128(tks + ((size_t)s * kChunk + wg * 64) * BK);
    const uint64_t db = sm90::desc_sw128(aks + (size_t)s * HD * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_k16<HD>(acc, sm90::desc_k(da, kk), sm90::desc_k(db, kk), kt > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % S]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  if (lane == 0) sm90::mbar_arrive(&empty[(KT - 1) % S]);

  // acc[4jj + 2h + e]: key key0 + 8h, column 8jj + 2·quad + e
  const int warp = (tid % 128) / 32, quad = lane % 4;
  const int key0 = wg * 64 + warp * 16 + lane / 4;

  // rotate-half RoPE on the accumulators: column d and d + HD/2 sit in the
  // same thread (jj and jj + NJ/2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = min(c0 + key0 + 8 * h, T_len - 1);  // keys past T are masked below
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
    const float* qr = qs + r * HD;
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
        if (kp >= w.t_lo && kp < w.t_hi) {
          l = (h ? dot1 : dot0) * scale;
          if (softcap > 0.f) l = softcap * tanhf(l / softcap);
        }
        ps[r * kChunk + key0 + 8 * h] = l;
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
      l[i] = ps[r * kChunk + lane + 32 * i];
      m = fmaxf(m, l[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const float p = expf(l[i] - m);
      sum += p;
      pb[r * kPLd + lane + 32 * i] = __float2bfloat16_rn(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ws_ml[(split * rep + r) * 2] = m;
      ws_ml[(split * rep + r) * 2 + 1] = sum;
    }
  }
  consumers_sync();

  // s[r][v] = Σ_t T(p[r][t])·tv[t][v] on the tensor cores (mma m16n8k16:
  // the heads, padded to 16, times 16 keys times 8 columns), one 64-column
  // tv stage at a time, warp w owning columns 8w..8w+7 of each. Masked keys
  // have T(p) = 0 exactly; rows past T arrive as 0. The A fragments of T(p)
  // serve every stage; the tv fragments come transposed out of the
  // swizzled stage.
  uint32_t pa[kChunk / 16][4];
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
    sm90::ldsm_x4(pa[kk], pb + (lane % 16) * kPLd + kk * 16 + (lane / 16) * 8);
  const int cw = tid / 32;
  for (int vt = 0; vt < VT; ++vt) {
    const int i = KT + vt, s = i % S;
    sm90::mbar_wait(&full[s], (i / S) & 1);
    const bf16* tile = tks + (size_t)s * kChunk * BK;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int row = kk * 16 + lane % 16;  // lanes 16..31 repeat 0..15 (ignored)
      uint32_t b0, b1;
      sm90::ldsm_x2_trans(b0, b1, tile + row * BK + ((cw ^ (row % 8)) * 8));
      sm90::mma16816(c, pa[kk], b0, b1);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    // c[2h + e]: head lane/4 + 8h, column 8·cw + 2·(lane % 4) + e
    const int v = vt * BK + cw * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane / 4 + 8 * h;
      if (r < rep && v < Rv)  // Rv % 8 == 0: v and v + 1 both in or both out
        *reinterpret_cast<float2*>(ws_s + (split * rep + r) * Rv + v) =
            make_float2(c[2 * h], c[2 * h + 1]);
    }
  }
}

// out[b][h][v] = Σ_j e^(m_j − M)·s_j / Σ_j e^(m_j − M)·den_j over the chunks
// j of head h with den_j > 0 (flash_decode::combine_splits' arithmetic, one
// thread per output value). Grid (cdiv(Rv, kThreads), H, B).
__global__ void __launch_bounds__(kThreads)
combine_chunks(const float* __restrict__ ws_s, const float* __restrict__ ws_ml,
               float* __restrict__ out, int H, int KV, int NS, int Rv) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (v >= Rv) return;
  const int rep = H / KV, g = h / rep, r = h % rep;
  const size_t base = ((size_t)b * KV + g) * NS;
  float M = kNeg;
  for (int j = 0; j < NS; ++j) {
    const float* ml = ws_ml + ((base + j) * rep + r) * 2;
    if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
  }
  float den = 0.f, num = 0.f;
  for (int j = 0; j < NS; ++j) {
    const float* ml = ws_ml + ((base + j) * rep + r) * 2;
    if (ml[1] > 0.f) {
      const float w = expf(ml[0] - M);
      den = fmaf(w, ml[1], den);
      num = fmaf(w, ws_s[((base + j) * rep + r) * Rv + v], num);
    }
  }
  out[((size_t)b * H + h) * Rv + v] = num / den;
}

// The split form: chunks, then combine_chunks into out.
// ws holds B·KV·NS·rep·(Rv + 2) f32 values, NS the row's live chunks.
template <int HD>
int launch_split(const void* q, const void* tk, const void* tv, const void* a_k,
                 const float* cos_t, const float* sin_t, float* ws, float* out, int B, int H,
                 int KV, int T_len, int Rk, int Rv, int pos, float scale, float softcap,
                 int sliding, cudaStream_t stream) {
  const Window w = key_window(T_len, pos, sliding);
  if (w.n <= 0 || Rk % 8 != 0 || Rv % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_tk, map_ak;
  const cuuint64_t dims[3] = {(cuuint64_t)Rk, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Rk * 2, (cuuint64_t)T_len * Rk * 2};
  const cuuint32_t box[3] = {(cuuint32_t)sm90::kBK, (cuuint32_t)kChunk, 1};
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
  const size_t bytes = split_smem_bytes(HD, rep);
  auto kernel = latent_split_kernel<HD>;
  // the attribute is per device, so it is set on every call (it costs little)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* ws_s = ws;
  float* ws_ml = ws + (size_t)B * KV * w.n * rep * Rv;
  kernel<<<dim3(w.n, KV, B), kSplitThreads, bytes, stream>>>(
      map_tk, map_ak, map_tv, static_cast<const __nv_bfloat16*>(q), cos_t, sin_t, ws_s, ws_ml,
      H, KV, T_len, Rk, Rv, pos, scale, softcap, sliding);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_chunks<<<dim3((Rv + kThreads - 1) / kThreads, H, B), kThreads, 0, stream>>>(
      ws_s, ws_ml, out, H, KV, w.n, Rv);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block needs; the wrapper refuses shapes above
// the 232,448-byte opt-in limit before launching.
extern "C" long long latent_attention_smem_bytes(int head_dim, int rep, int Rv) {
  return (long long)smem_bytes(head_dim, rep, Rv);
}

// dtype: 0 = float32, 1 = bfloat16 (q, tk, tv, a_k all of it); cos/sin
// [T, HD] f32; out [B, H, Rv] f32. form: 0 = "tile32", 1 = "split_wgmma"
// (bf16, HD 64 or 128; ws its workspace of B·KV·n_chunks·rep·(Rv + 2) f32
// values, n_chunks the chunks of kChunk keys that hold the live keys, else
// both unused). Returns
// cudaGetLastError() (0 = success), cudaErrorInvalidValue for a form the
// shape does not allow.
extern "C" int latent_attention_launch(const void* q, const void* tk, const void* tv,
                                       const void* a_k, const void* cos_t, const void* sin_t,
                                       void* out, void* ws, int n_chunks, int B, int H,
                                       int KV, int HD,
                                       int T_len, int Rk, int Rv, int pos, float scale,
                                       float softcap, int sliding, int dtype, int form,
                                       void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  float* o = static_cast<float*>(out);
  if (form == 1) {
    float* w = static_cast<float*>(ws);
    if (dtype != 1 || key_window(T_len, pos, sliding).n != n_chunks)
      return (int)cudaErrorInvalidValue;
    if (HD == 64)
      return launch_split<64>(q, tk, tv, a_k, c, s, w, o, B, H, KV, T_len, Rk, Rv, pos, scale,
                              softcap, sliding, st);
    if (HD == 128)
      return launch_split<128>(q, tk, tv, a_k, c, s, w, o, B, H, KV, T_len, Rk, Rv, pos, scale,
                               softcap, sliding, st);
    return (int)cudaErrorInvalidValue;
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
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
