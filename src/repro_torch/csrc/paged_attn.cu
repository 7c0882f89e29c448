// Single-query paged decode attention, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py:_paged_attn_kernel
// (launched by paged_attn_pallas) in three of its forms, each over fp pages
// or, with its int8-scale option (K2q, the reference's k_scale / v_scale /
// k2_scale, paged_attn.py:131-134, 141-142, 159-161), over int8 pages, and
// each with either flush: normalized (emit_stats=False: K2) or the raw
// flash stats (emit_stats=True: K3, paged_attn.py:171-176).
//
// paged_attn_launch, MHA/GQA (K2), with the window option (K2w, the
// reference's window / win_slots, paged_attn.py:109-125):
//   q        (B, Hkv, G, D)   queries grouped per KV head
//   k_pages  (P, ps, Hkv, D)  physical pool;  v_pages (P, ps, Hkv, Dv)
//   out      (B, Hkv, G, Dv)  in q's type
//   window = 0: an append-only table, slot p holds logical page p.
//   window > 0: a modular table of win_slots (= n_slots) slots: slot p
//   holds the newest logical page pg = cur - floormod(cur - p, win_slots)
//   at or before the lane's current page cur = (length - 1) / ps, and only
//   positions in [length - window, length) count.  A slot whose page lies
//   before 0 (not reached yet), wholly before the window or at or past the
//   length is skipped; the window's first page is live only from row
//   length - window - pg * ps.
// paged_attn_mla_launch, MLA's absorbed latent form (K2m; the reference's
// q2 / k2_pages / v_is_k options, src/repro/models/mla.py:202-237):
//   q        (B, Hkv, G, D)   the latent queries (DeepSeek: Hkv=1, G=16, D=512)
//   q2       (B, Hkv, G, D2)  the RoPE queries, a second score stream
//   k_pages  (P, ps, Hkv, D)  the latent pool, which is V as well
//   k2_pages (P, ps, Hkv, D2) the shared RoPE keys
//   out      (B, Hkv, G, D)   in q's type
//   scores are (q.k + q2.k2) * scale; V is the K page already staged.
// The stats flush (K3, either launch with m_out and l_out given): out is
// the unnormalized f32 accumulator (B, Hkv, G, Dv), m_out the running max
// and l_out the denominator (B, Hkv, G), both f32; a lane with no live
// position writes acc = 0, m = -1e30, l = 0.  A tensor-parallel pool
// shard runs it over its own page range (the rest of a lane's table is
// its local sentinel) and the shards' triples merge in one combine
// (kernels/sharded.py).  Otherwise out is acc / max(l, 1e-30) in q's type.
// All: tables (B, n_slots) int32 page ids, P = sentinel (unmapped);
// lengths (B,) int32 live tokens per lane.  Queries and output share one
// type (f32 or bf16) and the pages another (f32, bf16 or int8), so the MLA
// form keeps the reference's f32 queries and output over bf16 or int8
// pages.  Int8 pages come with one f16 scale per (page, slot) for each page
// stream, (P, ps): k_scale, v_scale (GQA and window forms), k_scale and
// k2_scale (MLA, whose V is the dequantized K page); a row is its codes
// times its scale, in f32, as models/cache.py:dequant computes it.
// Positions at or past lengths[b] are dead.  A lane with length 0 writes
// exact zeros (the stats flush: the dead-lane triple above).
//
// What bounds it: the bytes of the live pages (decode does ~1 FMA per
// byte read per query head, far below the tensor cores' break-even); int8
// pages halve them against bf16.  A row is dequantized as it is staged into
// shared memory, so device memory streams only the 1-byte codes and one
// 2-byte scale per row, and everything after the staging is the fp path.  The
// design gives one block to each (lane, KV head) and walks the lane's table
// slots in order, so every live page is read once and all G query heads of
// the KV head share that read; in the MLA form the latent page is read once
// for both the scores and the output.  Where that leaves few blocks (MLA
// and RecurrentGemma's MQA: one KV head, 16 query heads), the query heads
// are split across blocks that each read the pages (L2 serves the
// repeats).  Slots that are sentinel or hold no live row are skipped
// before any load is issued, and only a page's live rows are loaded (the
// last page's head, the window's first page's tail).  The softmax does not
// depend on the order the pages come in, so a window's slots are walked in
// slot order, not logical order.  Each page's K (and K2, V)
// go through shared memory (rows padded by one float against bank
// conflicts), and a flash-style online softmax in f32 carries (max,
// denominator, accumulator) from page to page, with the finite -1e30 in
// place of -inf so dead positions never make NaNs.  The MLA form at
// DeepSeek's widths needs 105 KB of shared memory for 16 heads in a block
// (f32 queries and accumulator of 16 x 512, one page of 16 x 513), and the
// GQA form 66 KB for 16 heads of 256, past the 48 KB a launch gets by
// default: the launch opts in with cudaFuncSetAttribute above 48 KB and
// returns its error if that fails.
// The scoring loop is a template parameter picked at launch from the row
// width: rows of at least WARP_ROW_MIN floats over both streams (MLA's
// 512 + 64) take a warp per (head, row), its lanes splitting the dot
// product; narrower rows (GQA's 64-128) a thread per (head, row), which
// needs no shuffle reduction.
// The stats flush changes only the last loop: the f32 accumulator and the
// per-head max and denominator leave as they are, so K3 costs what K2
// costs in each form.  One page per step leaves much of the card idle at
// small batch; splitting one lane's page walk across blocks with the stats
// form is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;
constexpr int SMEM_MAX = 232448;  // 227 KB: a block's limit on Hopper
constexpr int WARP_ROW_MIN = 256;  // D + D2 from which a warp scores a row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int floor_mod(int x, int n) { return ((x % n) + n) % n; }

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Floats of shared memory: q, q2, K page, K2 page, V page (none when V is
// K), scores, accumulator, and three per-head rows.
__host__ __device__ inline int smem_floats(int G, int D, int D2, int Dv, int ps,
                                           bool v_is_k) {
  return G * D + G * D2 + ps * (D + 1) + ps * (D2 + 1) + (v_is_k ? 0 : ps * Dv)
         + G * ps + G * Dv + 3 * G;
}

// TQ: queries and output; TP: pages (int8_t: codes with f16 scales ksc,
// k2sc, vsc of (P, ps), else the scale pointers are unused).  D2 = 0
// without a second stream.  The block owns query heads [blockIdx.z * G, +G)
// of the Gt that share KV head blockIdx.y.  ROW_WARP: a warp (else a
// thread) per (head, row) score.  STATS: the K3 flush (f32 acc into out,
// the running max and denominator into m_out and l_out), else the
// normalized output in TQ.
template <typename TQ, typename TP, bool V_IS_K, bool ROW_WARP, bool STATS>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ q2,
    const TP* __restrict__ kp, const TP* __restrict__ k2p,
    const TP* __restrict__ vp, const __half* __restrict__ ksc,
    const __half* __restrict__ k2sc, const __half* __restrict__ vsc,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    std::conditional_t<STATS, float, TQ>* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int Gt, int G,
    int D, int D2, int Dv, int P, int ps, int n_slots, int window, int win_slots,
    float scale) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  extern __shared__ float smem[];
  const int KS = D + 1, K2S = D2 + 1;  // padded row strides
  float* qs = smem;                     // G*D
  float* q2s = qs + G * D;              // G*D2
  float* ks = q2s + G * D2;             // ps*KS
  float* k2s = ks + ps * KS;            // ps*K2S
  float* vs = k2s + ps * K2S;           // ps*Dv, absent when V is K
  const int VS = V_IS_K ? KS : Dv;      // row stride of the V tile
  if (V_IS_K) vs = ks;
  float* ss = k2s + ps * K2S + (V_IS_K ? 0 : ps * Dv);  // G*ps scores, then probabilities
  float* acc = ss + G * ps;             // G*Dv
  float* mrow = acc + G * Dv;           // G   running max
  float* lrow = mrow + G;               // G   running denominator
  float* corr = lrow + G;               // G   this page's rescale factor

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int length = lengths[b];
  const size_t head = ((size_t)b * Hkv + h) * Gt + (size_t)blockIdx.z * G;  // first query head

  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f(q[head * D + e]);
  for (int e = tid; e < G * D2; e += THREADS) q2s[e] = to_f(q2[head * D2 + e]);
  for (int e = tid; e < G * Dv; e += THREADS) acc[e] = 0.f;
  for (int g = tid; g < G; g += THREADS) { mrow[g] = NEG; lrow[g] = 0.f; }
  __syncthreads();

  // every value here is uniform across the block, so whole pages skip together
  const int cur_pg = max(length - 1, 0) / ps;
  const int lo = window > 0 ? max(length - window, 0) : 0;  // first live position
  const int n_walk = length <= 0 ? 0 : window > 0 ? n_slots
                                                  : min(n_slots, (length + ps - 1) / ps);
  for (int p = 0; p < n_walk; ++p) {
    const int pg = window > 0 ? cur_pg - floor_mod(cur_pg - p, win_slots) : p;
    const int phys = tables[(size_t)b * n_slots + p];
    if (phys < 0 || phys >= P || pg < 0) continue;     // sentinel or not reached
    const int r0 = max(lo - pg * ps, 0);               // live rows [r0, r1) of the page
    const int r1 = min(ps, length - pg * ps);
    if (r0 >= r1) continue;                            // nothing live: nothing loaded
    const int nv = r1 - r0;
    const size_t row0 = (size_t)phys * ps + r0;  // also the rows' index in a scale plane
    for (int e = tid; e < nv * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      float x = to_f(kp[((row0 + r) * Hkv + h) * D + d]);
      if constexpr (QUANT) x *= __half2float(ksc[row0 + r]);
      ks[r * KS + d] = x;
    }
    for (int e = tid; e < nv * D2; e += THREADS) {
      const int r = e / D2, d = e - r * D2;
      float x = to_f(k2p[((row0 + r) * Hkv + h) * D2 + d]);
      if constexpr (QUANT) x *= __half2float(k2sc[row0 + r]);
      k2s[r * K2S + d] = x;
    }
    if (!V_IS_K) {
      for (int e = tid; e < nv * Dv; e += THREADS) {
        const int r = e / Dv, d = e - r * Dv;
        float x = to_f(vp[((row0 + r) * Hkv + h) * Dv + d]);
        if constexpr (QUANT) x *= __half2float(vsc[row0 + r]);
        vs[e] = x;
      }
    }
    __syncthreads();
    if (ROW_WARP) {
      for (int e = warp; e < G * nv; e += THREADS / 32) {
        const int g = e / nv, r = e - g * nv;
        const float *qg = qs + g * D, *kr = ks + r * KS;
        const float *q2g = q2s + g * D2, *k2r = k2s + r * K2S;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s = fmaf(qg[d], kr[d], s);
        for (int d = lane; d < D2; d += 32) s = fmaf(q2g[d], k2r[d], s);
        s = warp_sum(s);
        if (lane == 0) ss[g * ps + r] = s * scale;
      }
    } else {
      for (int e = tid; e < G * nv; e += THREADS) {
        const int g = e / nv, r = e - g * nv;
        const float *qg = qs + g * D, *kr = ks + r * KS;
        const float *q2g = q2s + g * D2, *k2r = k2s + r * K2S;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
        for (int d = 0; d < D2; ++d) s = fmaf(q2g[d], k2r[d], s);
        ss[g * ps + r] = s * scale;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG;
      for (int r = lane; r < nv; r += 32) mx = fmaxf(mx, ss[g * ps + r]);
      mx = warp_max(mx);
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < nv; r += 32) {
        const float pr = expf(ss[g * ps + r] - m_new);
        ss[g * ps + r] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        lrow[g] = c * lrow[g] + sum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * Dv; e += THREADS) {
      const int g = e / Dv, d = e - g * Dv;
      const float* pg = ss + g * ps;
      float a = corr[g] * acc[e];
      for (int r = 0; r < nv; ++r) a = fmaf(pg[r], vs[r * VS + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }
  if constexpr (STATS) {
    for (int e = tid; e < G * Dv; e += THREADS) out[head * Dv + e] = acc[e];
    for (int g = tid; g < G; g += THREADS) {
      m_out[head + g] = mrow[g];
      l_out[head + g] = lrow[g];
    }
  } else {
    for (int e = tid; e < G * Dv; e += THREADS) {
      out[head * Dv + e] = from_f<TQ>(acc[e] / fmaxf(lrow[e / Dv], 1e-30f));
    }
  }
}

template <typename TQ, typename TP, bool V_IS_K, bool STATS>
int launch(const void* q, const void* q2, const void* k, const void* k2,
           const void* v, const void* ksc, const void* k2sc, const void* vsc,
           const void* tables, const void* lengths, void* out, void* m_out,
           void* l_out, int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
           int n_slots, int window, int win_slots, float scale, cudaStream_t s) {
  // split a KV head's query heads across blocks (halving while G stays
  // even) until the grid has 64 blocks or a block has 2 heads: every block
  // re-reads the pages (from L2), but 4 lanes of 16 MLA or MQA heads fill
  // 32 SMs
  int gb = G;
  while (gb > 2 && gb % 2 == 0 && B * Hkv * (G / gb) < 64) gb /= 2;
  const int smem = (int)sizeof(float) * smem_floats(gb, D, D2, Dv, ps, V_IS_K);
  auto kernel = D + D2 >= WARP_ROW_MIN ? paged_attn_kernel<TQ, TP, V_IS_K, true, STATS>
                                      : paged_attn_kernel<TQ, TP, V_IS_K, false, STATS>;
  if (smem > 48 * 1024) {  // past the default: opt in, or fail the launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, Hkv, G / gb), THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(q2),
      static_cast<const TP*>(k), static_cast<const TP*>(k2),
      static_cast<const TP*>(v), static_cast<const __half*>(ksc),
      static_cast<const __half*>(k2sc), static_cast<const __half*>(vsc),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<std::conditional_t<STATS, float, TQ>*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), Hkv, G, gb, D, D2,
      Dv, P, ps, n_slots, window, win_slots, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool V_IS_K, bool STATS>
int launch_types(int q_dtype, int page_dtype, const void* q, const void* q2,
                 const void* k, const void* k2, const void* v, const void* ksc,
                 const void* k2sc, const void* vsc, const void* tables,
                 const void* lengths, void* out, void* m_out, void* l_out,
                 int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
                 int n_slots, int window, int win_slots, float scale,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, q2, k, k2, v, ksc, k2sc, vsc, tables, lengths, out, m_out, l_out, \
                B, Hkv, G, D, D2, Dv, P, ps, n_slots, window, win_slots, scale, s
  if (page_dtype == 2) {
    return q_dtype == 0 ? launch<float, int8_t, V_IS_K, STATS>(PA_ARGS)
                        : launch<__nv_bfloat16, int8_t, V_IS_K, STATS>(PA_ARGS);
  }
  if (q_dtype == 0 && page_dtype == 0) return launch<float, float, V_IS_K, STATS>(PA_ARGS);
  if (q_dtype == 0) return launch<float, __nv_bfloat16, V_IS_K, STATS>(PA_ARGS);
  if (page_dtype == 0) return launch<__nv_bfloat16, float, V_IS_K, STATS>(PA_ARGS);
  return launch<__nv_bfloat16, __nv_bfloat16, V_IS_K, STATS>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper refuses more than
// paged_attn_smem_max()).  D2 = 0 and v_is_k = 0 for the MHA/GQA form.
extern "C" int paged_attn_smem_bytes(int G, int D, int D2, int Dv, int ps, int v_is_k) {
  return (int)sizeof(float) * smem_floats(G, D, D2, Dv, ps, v_is_k != 0);
}

extern "C" int paged_attn_smem_max() { return SMEM_MAX; }

// q_dtype: 0 = float32, 1 = bfloat16; page_dtype: the same, or 2 = int8
// (then the f16 scale planes k_scale and v_scale, or k_scale and k2_scale,
// are given; otherwise they are null).  m_out and l_out null: the
// normalized flush into out (q's type); both given: the stats flush (K3),
// f32 acc into out.  Each returns the error of the shared-memory opt-in,
// else cudaGetLastError() after the launch.  The wrapper
// (kernels/paged_attn.py) checks shapes, types and contiguity.
// window = 0 (and win_slots = 0) for an append-only table, else the live
// window's width and the modular table's slot count (= n_slots).
extern "C" int paged_attn_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* lengths,
                                 void* out, void* m_out, void* l_out, int B,
                                 int Hkv, int G, int D, int Dv, int P, int ps,
                                 int n_slots, int window, int win_slots,
                                 float scale, int q_dtype, int page_dtype,
                                 void* stream) {
#define PA_GQA_ARGS q_dtype, page_dtype, q, nullptr, k, nullptr, v, k_scale, nullptr, \
                    v_scale, tables, lengths, out, m_out, l_out, B, Hkv, G, D, 0, Dv, \
                    P, ps, n_slots, window, win_slots, scale, stream
  return m_out != nullptr ? launch_types<false, true>(PA_GQA_ARGS)
                          : launch_types<false, false>(PA_GQA_ARGS);
#undef PA_GQA_ARGS
}

extern "C" int paged_attn_mla_launch(const void* q, const void* q2,
                                     const void* k, const void* k2,
                                     const void* k_scale, const void* k2_scale,
                                     const void* tables, const void* lengths,
                                     void* out, void* m_out, void* l_out, int B,
                                     int Hkv, int G, int D, int D2, int P,
                                     int ps, int n_slots, float scale,
                                     int q_dtype, int page_dtype, void* stream) {
#define PA_MLA_ARGS q_dtype, page_dtype, q, q2, k, k2, nullptr, k_scale, k2_scale, \
                    nullptr, tables, lengths, out, m_out, l_out, B, Hkv, G, D, D2, D, \
                    P, ps, n_slots, 0, 0, scale, stream
  return m_out != nullptr ? launch_types<true, true>(PA_MLA_ARGS)
                          : launch_types<true, false>(PA_MLA_ARGS);
#undef PA_MLA_ARGS
}
