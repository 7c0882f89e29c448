// Single-query paged decode attention, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py:_paged_attn_kernel
// (launched by paged_attn_pallas) in three of its forms, each over fp pages
// or, with its int8-scale option (K2q, the reference's k_scale / v_scale /
// k2_scale, paged_attn.py:131-134, 141-142, 159-161), over int8 pages, and
// each with either flush: normalized (emit_stats=False: K2) or the raw
// flash stats (emit_stats=True: K3, paged_attn.py:171-176).
//
// paged_attn_launch, MHA/GQA (K2):
//   q        (B, Hkv, G, D)   queries grouped per KV head
//   k_pages  (P, ps, Hkv, D)  physical pool;  v_pages (P, ps, Hkv, Dv)
//   out      (B, Hkv, G, Dv)  in q's type
//   an append-only table: slot p holds logical page p.
// paged_attn_win_launch, its window option (K2w, the reference's window /
// win_slots, paged_attn.py:109-125): the same operands over a modular table
// of n_slots (= win_slots) slots: slot p holds the newest logical page pg =
// cur - floormod(cur - p, n_slots) at or before the lane's current page cur
// = (length - 1) / ps, and only positions in [length - window, length)
// count.  A slot whose page lies before 0 (not reached yet), wholly before
// the window or at or past the length is skipped; the window's first page
// is live only from row length - window - pg * ps.
// paged_attn_mla_launch, MLA's absorbed latent form (K2m; the reference's
// q2 / k2_pages / v_is_k options, src/repro/models/mla.py:202-237):
//   q        (B, Hkv, G, D)   the latent queries (DeepSeek: Hkv=1, G=16, D=512)
//   q2       (B, Hkv, G, D2)  the RoPE queries, a second score stream
//   k_pages  (P, ps, Hkv, D)  the latent pool, which is V as well
//   k2_pages (P, ps, Hkv, D2) the shared RoPE keys
//   out      (B, Hkv, G, D)   in q's type
//   scores are (q.k + q2.k2) * scale; V is the K page already staged.
// The stats flush (K3, any launch with m_out and l_out given): out is the
// unnormalized f32 accumulator (B, Hkv, G, Dv), m_out the running max and
// l_out the denominator (B, Hkv, G), both f32; a lane with no live
// position writes acc = 0, m = -1e30, l = 0.  A tensor-parallel pool shard
// runs it over its own page range (the rest of a lane's table is its local
// sentinel) and the shards' triples merge in one combine
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
// What bounds every form: the bytes of the live pages (decode does ~1 FMA
// per byte read per query head, far below the tensor cores' break-even);
// int8 pages halve them against bf16.
//
// The GQA and MLA forms (paged_attn_kernel) give one block to each (lane,
// KV head) and walk the lane's table slots in order, so every live page is
// read once and all G query heads of the KV head share that read; in the
// MLA form the latent page is read once for both the scores and the
// output.  Where that leaves few blocks (MLA: one KV head, 16 query
// heads), the query heads are split across blocks that each read the pages
// (L2 serves the repeats).  Sentinel slots and pages with no live row are
// skipped before any load starts, and only a page's live rows are
// loaded.  A row is dequantized as it is staged into shared memory (rows
// padded by one float against bank conflicts), and a flash-style online
// softmax in f32 carries (max, denominator, accumulator) from page to page,
// with the finite -1e30 in place of -inf so dead positions never make
// NaNs.  The MLA form at DeepSeek's widths needs 105 KB of shared memory
// for 16 heads in a block and the GQA form 66 KB for 16 heads of 256, past
// the 48 KB a launch gets by default: the launch opts in with
// cudaFuncSetAttribute above 48 KB and returns its error if that fails.
// Rows of at least WARP_ROW_MIN floats over both streams (MLA's 512 + 64)
// are scored by a warp per (head, row), narrower rows (GQA's 64) by a
// thread per (head, row).  The stats flush changes only the last loop.
//
// The window form (paged_attn_win_kernel) has few lanes, one KV head and a
// long table (RecurrentGemma: 4 lanes, 16 query heads over one KV head of
// 256, 130 slots of 16 rows), so a walk of one block per lane would leave
// the card idle and pay every page's load latency in turn.  Three things
// answer that:
// - The split.  The grid is (B, Hkv, S) and block s walks the contiguous
//   slots [s c, min((s + 1) c, n_slots)), c = ceil(n_slots / S).  Which
//   logical page a slot holds depends only on the slot and the lane's
//   length, so the ranges partition the window exactly and the skip rules
//   hold per block.  S is chosen on the host from the shapes alone
//   (kernels/paged_attn.py:window_splits: about one block per SM, a few
//   slots a block, S = 1 once B * Hkv fills the card), never from the
//   lengths, which live on the card.  A block keeps all G query heads of
//   its KV head, so each live page is read from device memory once.
// - The pipeline.  A page's live K and V rows (and, for int8 pages, the
//   page's codes and its f16 scales, raw) are copied into shared memory
//   with cp.async, 16 bytes a copy where the rows' bytes and addresses
//   allow (else 8 or 4), neighbouring threads on neighbouring bytes, into
//   one of two stages: the next live page's copies are in flight while the
//   block scores the current one.  One barrier a page: after it the
//   current page is visible and every warp is done with the other stage.
// - Warps that need no barrier of their own.  A warp owns two query heads:
//   lane l holds columns [8 l, 8 l + 8) of the heads' queries and
//   accumulators in registers and reads the same 8 columns of a staged row
//   as one vector, converting each value to f32 as it is read (an int8
//   code times its row's scale, in f32).  The warp scores 16 rows at a
//   time, reduces the 32 (head, row) partial dots so that lane i ends with
//   score i, runs the online softmax within each 16-lane half and
//   accumulates P V into registers.  Nothing is exchanged between warps.
// With S > 1 every block writes its f32 (acc, m, l) into a workspace the
// wrapper allocates, (S, B, Hkv, G, Dv) + 2 (S, B, Hkv, G), and a second
// kernel, paged_attn_win_combine, launched by the same C entry on the same
// stream, merges the S partials in the order s = 0, 1, ... (m = max m_s,
// l = sum exp(m_s - m) l_s, acc = sum exp(m_s - m) acc_s: no atomics, the
// same bits on every run) and flushes either way.  With S = 1 the walk
// flushes directly.  Splits and lanes with no live row give (0, -1e30, 0),
// which the combine keeps exact: zeros, or the dead-lane triple.
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
constexpr unsigned FULL = 0xffffffffu;
// the window kernel: a warp owns WIN_HEADS query heads and scores WIN_ROWS
// rows at a time (one (head, row) pair a lane); lane l holds columns
// [WIN_VEC l, WIN_VEC (l + 1)) of each head's query and accumulator and
// reads them from a staged row as one vector (D, Dv <= 32 WIN_VEC)
constexpr int WIN_HEADS = 2, WIN_ROWS = 16, WIN_VEC = 8;
constexpr int WIN_THREADS_MAX = 512;  // G <= 2 * 16 query heads a KV head
static_assert(WIN_HEADS * WIN_ROWS == 32, "a warp scores one (head, row) pair a lane");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
__device__ __forceinline__ int floor_mod(int x, int n) { return ((x % n) + n) % n; }

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, s));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
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
// normalized output in TQ.  The table is append-only: slot p holds page p.
template <typename TQ, typename TP, bool V_IS_K, bool ROW_WARP, bool STATS>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ q2,
    const TP* __restrict__ kp, const TP* __restrict__ k2p,
    const TP* __restrict__ vp, const __half* __restrict__ ksc,
    const __half* __restrict__ k2sc, const __half* __restrict__ vsc,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    std::conditional_t<STATS, float, TQ>* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int Gt, int G,
    int D, int D2, int Dv, int P, int ps, int n_slots, float scale) {
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
  const int n_walk = length <= 0 ? 0 : min(n_slots, (length + ps - 1) / ps);
  for (int p = 0; p < n_walk; ++p) {
    const int phys = tables[(size_t)b * n_slots + p];
    if (phys < 0 || phys >= P) continue;               // sentinel: nothing loaded
    const int nv = min(ps, length - p * ps);           // live rows [0, nv) of the page
    const size_t row0 = (size_t)phys * ps;  // also the rows' index in a scale plane
    // each staging loop unrolled by 8, so a thread can have 8 loads of a
    // stream in flight before its first store: at the compiler's own
    // unroll of 4 these instances' times moved by up to a quarter with
    // unrelated edits of the body (PERF.md §6)
    #pragma unroll 8
    for (int e = tid; e < nv * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      float x = to_f(kp[((row0 + r) * Hkv + h) * D + d]);
      if constexpr (QUANT) x *= __half2float(ksc[row0 + r]);
      ks[r * KS + d] = x;
    }
    #pragma unroll 8
    for (int e = tid; e < nv * D2; e += THREADS) {
      const int r = e / D2, d = e - r * D2;
      float x = to_f(k2p[((row0 + r) * Hkv + h) * D2 + d]);
      if constexpr (QUANT) x *= __half2float(k2sc[row0 + r]);
      k2s[r * K2S + d] = x;
    }
    if (!V_IS_K) {
      #pragma unroll 8
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

// ---- the window form: a split, pipelined walk and its combine ----

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}
// One step of the reduction of a lane's 2 * OFF partial sums across the
// warp: a lane keeps the half its bit OFF selects and adds its partner's.
template <int OFF>
__device__ __forceinline__ void reduce_step(float* part, int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int x = 0; x < OFF; ++x) {
    const float send = up ? part[x] : part[x + OFF];
    const float keep = up ? part[x + OFF] : part[x];
    part[x] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// WIN_VEC consecutive values of a staged row (aligned to WIN_VEC values)
// as f32: 32, 16 or 8 bytes in one or two shared-memory loads.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[WIN_VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[WIN_VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[WIN_VEC]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of one stage: a page's K rows, V rows and (int8) its two scale rows.
__host__ __device__ inline int win_stage_bytes(int D, int Dv, int ps, int item, bool quant) {
  return align16(ps * D * item) + align16(ps * Dv * item) + (quant ? 2 * align16(ps * 2) : 0);
}

// Shared memory of the window kernel: the block's table slots, two stages.
__host__ __device__ inline int win_smem_bytes(int D, int Dv, int ps, int chunk, int item,
                                              bool quant) {
  return align16(chunk * 4) + 2 * win_stage_bytes(D, Dv, ps, item, quant);
}

// Block (b, h, s) of the split walk: slots [s * chunk, +chunk) of lane b's
// window table, all G query heads of KV head h (warp w: heads 2w, 2w + 1),
// 32 * ceil(G / 2) threads.  vk, vv, vs: bytes per cp.async of the K rows,
// V rows and scale rows (16, 8 or 4).  NORM: the normalized flush into out
// (TQ); else the f32 (acc, m, l) into out, m_out, l_out at the rows of
// split s: ((s * B + b) * Hkv + h) * G + g.
template <typename TQ, typename TP, bool NORM>
__global__ void __launch_bounds__(WIN_THREADS_MAX) paged_attn_win_kernel(
    const TQ* __restrict__ q, const TP* __restrict__ kp, const TP* __restrict__ vp,
    const __half* __restrict__ ksc, const __half* __restrict__ vsc,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    std::conditional_t<NORM, TQ, float>* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int Hkv, int G, int D, int Dv, int P, int ps, int n_slots,
    int window, int chunk, int vk, int vv, int vs, float scale) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  extern __shared__ __align__(16) unsigned char wsm[];
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32;
  const int g0 = (tid / 32) * WIN_HEADS;  // the warp's first query head
  const int rowk = D * (int)sizeof(TP), rowv = Dv * (int)sizeof(TP);
  const int kbytes = align16(ps * rowk), vbytes = align16(ps * rowv);
  const int sbytes = QUANT ? align16(ps * 2) : 0;
  const int stage_bytes = kbytes + vbytes + 2 * sbytes;
  int* tab = reinterpret_cast<int*>(wsm);
  unsigned char* stages = wsm + align16(chunk * 4);

  const int length = lengths[b];
  const int p_lo = split * chunk, n = min(chunk, n_slots - p_lo);
  for (int i = tid; i < n; i += nt) tab[i] = tables[(size_t)b * n_slots + p_lo + i];

  // lane l's columns [c0, c0 + WIN_VEC); a lane past D (or Dv) reads the
  // last vector of the row with q = 0 (and does not write)
  const int c0 = WIN_VEC * lane, ck0 = min(c0, D - WIN_VEC), cv0 = min(c0, Dv - WIN_VEC);
  const size_t qhead = ((size_t)b * Hkv + h) * G;
  float qr[WIN_HEADS][WIN_VEC], acc[WIN_HEADS][WIN_VEC];
#pragma unroll
  for (int hh = 0; hh < WIN_HEADS; ++hh) {
#pragma unroll
    for (int t = 0; t < WIN_VEC; ++t) {
      qr[hh][t] = g0 + hh < G && c0 < D ? to_f(q[(qhead + g0 + hh) * D + c0 + t]) : 0.f;
      acc[hh][t] = 0.f;
    }
  }
  float m_run = NEG, l_run = 0.f;  // of head g0 + lane / 16, the same in its 16 lanes
  __syncthreads();

  // every value here is uniform across the block, so whole pages skip together
  const int cur = max(length - 1, 0) / ps;
  const int lo = max(length - window, 0);  // first live position
  // slot p_lo + i: its page id and live rows [r0, r1); false if nothing is live
  auto live = [&](int i, int& phys, int& r0, int& r1) {
    phys = tab[i];
    const int pg = cur - floor_mod(cur - (p_lo + i), n_slots);
    r0 = max(lo - pg * ps, 0);
    r1 = min(ps, length - pg * ps);
    return length > 0 && phys >= 0 && phys < P && pg >= 0 && r0 < r1;
  };
  auto next_live = [&](int i) {
    int phys, r0, r1;
    while (i < n && !live(i, phys, r0, r1)) ++i;
    return i;
  };
  // start the copies of slot i's live rows (and its page's scales) into stage st
  auto prefetch = [&](int i, int st) {
    int phys, r0, r1;
    live(i, phys, r0, r1);
    unsigned char* sk = stages + st * stage_bytes;
    unsigned char* sv = sk + kbytes;
    const size_t row0 = (size_t)phys * ps + r0;
    const int nv = r1 - r0, ck = rowk / vk, cv = rowv / vv;
    const auto* kb = reinterpret_cast<const unsigned char*>(kp);
    const auto* vb = reinterpret_cast<const unsigned char*>(vp);
    for (int e = tid; e < nv * ck; e += nt) {
      const int r = e / ck, c = e - r * ck;
      cp_async(sk + r * rowk + c * vk, kb + ((row0 + r) * Hkv + h) * rowk + c * vk, vk);
    }
    for (int e = tid; e < nv * cv; e += nt) {
      const int r = e / cv, c = e - r * cv;
      cp_async(sv + r * rowv + c * vv, vb + ((row0 + r) * Hkv + h) * rowv + c * vv, vv);
    }
    if constexpr (QUANT) {
      const auto* ksb = reinterpret_cast<const unsigned char*>(ksc + (size_t)phys * ps);
      const auto* vsb = reinterpret_cast<const unsigned char*>(vsc + (size_t)phys * ps);
      for (int o = tid * vs; o < ps * 2; o += nt * vs) {
        cp_async(sv + vbytes + o, ksb + o, vs);
        cp_async(sv + vbytes + sbytes + o, vsb + o, vs);
      }
    }
  };

  int i = next_live(0);
  if (i < n) prefetch(i, 0);
  cp_async_commit();
  for (int st = 0; i < n; st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // slot i staged; every warp is done with stage st ^ 1
    const int i_next = next_live(i + 1);
    if (i_next < n) prefetch(i_next, st ^ 1);
    cp_async_commit();

    int phys, r0, r1;
    live(i, phys, r0, r1);
    const int nv = r1 - r0;
    const unsigned char* sbase = stages + st * stage_bytes;
    const TP* sk = reinterpret_cast<const TP*>(sbase);
    const TP* sv = reinterpret_cast<const TP*>(sbase + kbytes);
    const __half* sks = reinterpret_cast<const __half*>(sbase + kbytes + vbytes) + r0;
    const __half* svs = reinterpret_cast<const __half*>(sbase + kbytes + vbytes + sbytes) + r0;
    for (int rc = 0; rc < nv; rc += WIN_ROWS) {
      // part[hh * 16 + r]: this lane's share of head g0 + hh's dot with row
      // rc + r; rows past the live ones read the last live row and are masked
      float part[WIN_HEADS * WIN_ROWS];
#pragma unroll
      for (int r = 0; r < WIN_ROWS; ++r) {
        const int rr = min(rc + r, nv - 1);
        float x[WIN_VEC];
        load_vec(sk + rr * D + ck0, x);
        if constexpr (QUANT) {
          const float sc = __half2float(sks[rr]);
#pragma unroll
          for (int t = 0; t < WIN_VEC; ++t) x[t] *= sc;
        }
#pragma unroll
        for (int hh = 0; hh < WIN_HEADS; ++hh) {
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < WIN_VEC; ++t) dot = fmaf(qr[hh][t], x[t], dot);
          part[hh * WIN_ROWS + r] = dot;
        }
      }
      // reduce the 32 partial dots across the lanes so that lane i holds dot i
      reduce_step<16>(part, lane);
      reduce_step<8>(part, lane);
      reduce_step<4>(part, lane);
      reduce_step<2>(part, lane);
      reduce_step<1>(part, lane);
      const int hh = lane / WIN_ROWS, r = lane % WIN_ROWS;
      const bool valid = rc + r < nv && g0 + hh < G;
      const float s = valid ? part[0] * scale : NEG;
      float mx = s;
      for (int off = WIN_ROWS / 2; off >= 1; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      }
      const float m_new = fmaxf(m_run, mx);
      const float pr = valid ? expf(s - m_new) : 0.f;
      float sum = pr;
      for (int off = WIN_ROWS / 2; off >= 1; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      const float c = expf(m_run - m_new);
      l_run = c * l_run + sum;
      m_run = m_new;
#pragma unroll
      for (int hh2 = 0; hh2 < WIN_HEADS; ++hh2) {
        const float ch = __shfl_sync(FULL, c, hh2 * WIN_ROWS);
#pragma unroll
        for (int t = 0; t < WIN_VEC; ++t) acc[hh2][t] *= ch;
      }
      // P V over all 16 rows: a masked row has p = 0 times a live row
#pragma unroll
      for (int r2 = 0; r2 < WIN_ROWS; ++r2) {
        const int rr = min(rc + r2, nv - 1);
        float x[WIN_VEC];
        load_vec(sv + rr * Dv + cv0, x);
        if constexpr (QUANT) {
          const float sc = __half2float(svs[rr]);
#pragma unroll
          for (int t = 0; t < WIN_VEC; ++t) x[t] *= sc;
        }
#pragma unroll
        for (int hh2 = 0; hh2 < WIN_HEADS; ++hh2) {
          const float p = __shfl_sync(FULL, pr, hh2 * WIN_ROWS + r2);
#pragma unroll
          for (int t = 0; t < WIN_VEC; ++t) acc[hh2][t] = fmaf(p, x[t], acc[hh2][t]);
        }
      }
    }
    i = i_next;
  }

  const size_t ohead = (((size_t)split * gridDim.x + b) * Hkv + h) * G;
#pragma unroll
  for (int hh = 0; hh < WIN_HEADS; ++hh) {
    const float m_h = __shfl_sync(FULL, m_run, hh * WIN_ROWS);
    const float l_h = __shfl_sync(FULL, l_run, hh * WIN_ROWS);
    const int g = g0 + hh;
    if (g >= G) continue;
    if (c0 < Dv) {
#pragma unroll
      for (int t = 0; t < WIN_VEC; ++t) {
        if constexpr (NORM) {
          out[(ohead + g) * Dv + c0 + t] = from_f<TQ>(acc[hh][t] / fmaxf(l_h, 1e-30f));
        } else {
          out[(ohead + g) * Dv + c0 + t] = acc[hh][t];
        }
      }
    }
    if (!NORM && lane == 0) {
      m_out[ohead + g] = m_h;
      l_out[ohead + g] = l_h;
    }
  }
}

// Merge the splits' f32 partials of each of the `rows` query heads (block
// x = one head, thread = one column): acc (S, rows, Dv), m and l (S, rows),
// in the order s = 0, 1, ... in every thread; then the normalized flush
// (NORM) or the merged (acc, m, l).  Shared memory: 3 S floats.
template <typename TQ, bool NORM>
__global__ void paged_attn_win_combine(const float* __restrict__ acc,
                                       const float* __restrict__ m,
                                       const float* __restrict__ l,
                                       std::conditional_t<NORM, TQ, float>* __restrict__ out,
                                       float* __restrict__ m_out, float* __restrict__ l_out,
                                       int rows, int Dv, int splits) {
  extern __shared__ float csm[];
  float *ms = csm, *ls = csm + splits, *ws = csm + 2 * splits;
  const int row = blockIdx.x, d = threadIdx.x;
  for (int s = d; s < splits; s += blockDim.x) {
    ms[s] = m[(size_t)s * rows + row];
    ls[s] = l[(size_t)s * rows + row];
  }
  __syncthreads();
  float m_g = NEG;
  for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, ms[s]);
  // 1 where every split is dead (m_g = -1e30), 0 for a dead split beside a live one
  for (int s = d; s < splits; s += blockDim.x) ws[s] = expf(ms[s] - m_g);
  __syncthreads();
  float a = 0.f, lsum = 0.f;
  for (int s = 0; s < splits; ++s) lsum = fmaf(ws[s], ls[s], lsum);
  if (d < Dv) {
    const float* col = acc + (size_t)row * Dv + d;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) a = fmaf(ws[s], col[(size_t)s * rows * Dv], a);
  }
  if constexpr (NORM) {
    if (d < Dv) out[(size_t)row * Dv + d] = from_f<TQ>(a / fmaxf(lsum, 1e-30f));
  } else {
    if (d < Dv) out[(size_t)row * Dv + d] = a;
    if (d == 0) {
      m_out[row] = m_g;
      l_out[row] = lsum;
    }
  }
}

template <typename TQ, typename TP, bool V_IS_K, bool STATS>
int launch(const void* q, const void* q2, const void* k, const void* k2,
           const void* v, const void* ksc, const void* k2sc, const void* vsc,
           const void* tables, const void* lengths, void* out, void* m_out,
           void* l_out, int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
           int n_slots, float scale, cudaStream_t s) {
  // split a KV head's query heads across blocks (halving while G stays
  // even) until the grid has 64 blocks or a block has 2 heads: every block
  // re-reads the pages (from L2), but 4 lanes of 16 MLA heads fill 32 SMs
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
      Dv, P, ps, n_slots, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool V_IS_K, bool STATS>
int launch_types(int q_dtype, int page_dtype, const void* q, const void* q2,
                 const void* k, const void* k2, const void* v, const void* ksc,
                 const void* k2sc, const void* vsc, const void* tables,
                 const void* lengths, void* out, void* m_out, void* l_out,
                 int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
                 int n_slots, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, q2, k, k2, v, ksc, k2sc, vsc, tables, lengths, out, m_out, l_out, \
                B, Hkv, G, D, D2, Dv, P, ps, n_slots, scale, s
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

// The largest of 16, 8 and 4 bytes that divides `bytes` and the address
// `p` (every row then starts aligned to it), or 0.
int copy_bytes(const void* p, int bytes) {
  for (int v = 16; v >= 4; v >>= 1) {
    if (bytes % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  }
  return 0;
}

// One launch of the walk with flush NORM into (out, m_out, l_out).
template <typename TQ, typename TP, bool NORM>
int launch_walk(const void* q, const void* k, const void* v, const void* ksc,
                const void* vsc, const void* tables, const void* lengths, void* out,
                float* m_out, float* l_out, int B, int Hkv, int G, int D, int Dv, int P,
                int ps, int n_slots, int window, int splits, int chunk, int vk, int vv,
                int vs, int smem, float scale, cudaStream_t s) {
  auto kernel = paged_attn_win_kernel<TQ, TP, NORM>;
  if (smem > 48 * 1024) {  // past the default: opt in, or fail the launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, Hkv, splits), 32 * ((G + WIN_HEADS - 1) / WIN_HEADS), smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k), static_cast<const TP*>(v),
      static_cast<const __half*>(ksc), static_cast<const __half*>(vsc),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<std::conditional_t<NORM, TQ, float>*>(out), m_out, l_out, Hkv, G, D, Dv,
      P, ps, n_slots, window, chunk, vk, vv, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

// The walk over `splits` blocks a (lane, KV head) and, for splits > 1, the
// combine of its partials in work: acc (S, rows, Dv), then m and l (S, rows).
template <typename TQ, typename TP>
int launch_win(const void* q, const void* k, const void* v, const void* ksc,
               const void* vsc, const void* tables, const void* lengths, void* out,
               void* m_out, void* l_out, float* work, int B, int Hkv, int G, int D,
               int Dv, int P, int ps, int n_slots, int window, int splits, float scale,
               cudaStream_t s) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  const bool stats = m_out != nullptr;
  const int chunk = splits > 0 ? (n_slots + splits - 1) / splits : 0;
  const int item = (int)sizeof(TP);
  const int vk = copy_bytes(k, D * item), vv = copy_bytes(v, Dv * item);
  int vs = 16;
  if (QUANT) {
    const int a = copy_bytes(ksc, ps * 2), c = copy_bytes(vsc, ps * 2);
    vs = a < c ? a : c;
  }
  if (splits < 1 || (n_slots + chunk - 1) / chunk != splits || (splits > 1 && !work)
      || G > WIN_HEADS * WIN_THREADS_MAX / 32 || D > 32 * WIN_VEC || Dv > 32 * WIN_VEC
      || D % WIN_VEC || Dv % WIN_VEC || !vk || !vv || !vs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = win_smem_bytes(D, Dv, ps, chunk, item, QUANT);
  if (splits == 1 && !stats) {  // the walk's normalized flush, no combine
    return launch_walk<TQ, TP, true>(q, k, v, ksc, vsc, tables, lengths, out, nullptr,
                                     nullptr, B, Hkv, G, D, Dv, P, ps, n_slots, window, 1,
                                     chunk, vk, vv, vs, smem, scale, s);
  }
  // the stats flush: the final (acc, m, l) for S = 1, else the partials
  const int rows = B * Hkv * G;
  float* wm = splits == 1 ? static_cast<float*>(m_out) : work + (size_t)splits * rows * Dv;
  float* wl = splits == 1 ? static_cast<float*>(l_out) : wm + (size_t)splits * rows;
  const int err = launch_walk<TQ, TP, false>(q, k, v, ksc, vsc, tables, lengths,
                                             splits == 1 ? out : work, wm, wl, B, Hkv, G, D,
                                             Dv, P, ps, n_slots, window, splits, chunk, vk,
                                             vv, vs, smem, scale, s);
  if (err != 0 || splits == 1) return err;
  const int threads = 32 * ((Dv + 31) / 32), csmem = 3 * splits * (int)sizeof(float);
  if (stats) {
    paged_attn_win_combine<TQ, false><<<rows, threads, csmem, s>>>(
        work, wm, wl, static_cast<float*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), rows, Dv, splits);
  } else {
    paged_attn_win_combine<TQ, true><<<rows, threads, csmem, s>>>(
        work, wm, wl, static_cast<TQ*>(out), nullptr, nullptr, rows, Dv, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the GQA/MLA kernel needs, in bytes (the wrapper refuses
// more than paged_attn_smem_max()).  D2 = 0 and v_is_k = 0 for the GQA form.
extern "C" int paged_attn_smem_bytes(int G, int D, int D2, int Dv, int ps, int v_is_k) {
  return (int)sizeof(float) * smem_floats(G, D, D2, Dv, ps, v_is_k != 0);
}

// Shared memory the window kernel needs at `splits` blocks a lane, in bytes.
extern "C" int paged_attn_win_smem_bytes(int D, int Dv, int ps, int n_slots, int splits,
                                         int page_dtype) {
  const int item = page_dtype == 0 ? 4 : page_dtype == 1 ? 2 : 1;
  return win_smem_bytes(D, Dv, ps, (n_slots + splits - 1) / splits, item, page_dtype == 2);
}

extern "C" int paged_attn_smem_max() { return SMEM_MAX; }

// q_dtype: 0 = float32, 1 = bfloat16; page_dtype: the same, or 2 = int8
// (then the f16 scale planes k_scale and v_scale, or k_scale and k2_scale,
// are given; otherwise they are null).  m_out and l_out null: the
// normalized flush into out (q's type); both given: the stats flush (K3),
// f32 acc into out.  Each returns the error of the shared-memory opt-in,
// else cudaGetLastError() after its launches.  The wrapper
// (kernels/paged_attn.py) checks shapes, types and contiguity.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* lengths,
                                 void* out, void* m_out, void* l_out, int B,
                                 int Hkv, int G, int D, int Dv, int P, int ps,
                                 int n_slots, float scale, int q_dtype, int page_dtype,
                                 void* stream) {
#define PA_GQA_ARGS q_dtype, page_dtype, q, nullptr, k, nullptr, v, k_scale, nullptr, \
                    v_scale, tables, lengths, out, m_out, l_out, B, Hkv, G, D, 0, Dv, \
                    P, ps, n_slots, scale, stream
  return m_out != nullptr ? launch_types<false, true>(PA_GQA_ARGS)
                          : launch_types<false, false>(PA_GQA_ARGS);
#undef PA_GQA_ARGS
}

// The window form over a modular table of n_slots slots, window = the live
// width: `splits` blocks a (lane, KV head) (kernels/paged_attn.py:
// window_splits; ceil(n_slots / ceil(n_slots / splits)) must equal it), and
// with splits > 1 `work`, f32 scratch of splits * B * Hkv * G * (Dv + 2).
// G <= 32, D and Dv multiples of 8 up to 256; rows, scale rows and their
// addresses must take 4-byte copies.  Returns the first nonzero error of
// the walk's and the combine's launches (cudaErrorInvalidValue for shapes
// it does not take).
extern "C" int paged_attn_win_launch(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* tables, const void* lengths, void* out,
                                     void* m_out, void* l_out, void* work, int B, int Hkv,
                                     int G, int D, int Dv, int P, int ps, int n_slots,
                                     int window, int splits, float scale, int q_dtype,
                                     int page_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
#define PA_WIN_ARGS q, k, v, k_scale, v_scale, tables, lengths, out, m_out, l_out, w, B, \
                    Hkv, G, D, Dv, P, ps, n_slots, window, splits, scale, s
  if (page_dtype == 2) {
    return q_dtype == 0 ? launch_win<float, int8_t>(PA_WIN_ARGS)
                        : launch_win<__nv_bfloat16, int8_t>(PA_WIN_ARGS);
  }
  if (q_dtype == 0 && page_dtype == 0) return launch_win<float, float>(PA_WIN_ARGS);
  if (q_dtype == 0) return launch_win<float, __nv_bfloat16>(PA_WIN_ARGS);
  if (page_dtype == 0) return launch_win<__nv_bfloat16, float>(PA_WIN_ARGS);
  return launch_win<__nv_bfloat16, __nv_bfloat16>(PA_WIN_ARGS);
#undef PA_WIN_ARGS
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
                    P, ps, n_slots, scale, stream
  return m_out != nullptr ? launch_types<true, true>(PA_MLA_ARGS)
                          : launch_types<true, false>(PA_MLA_ARGS);
#undef PA_MLA_ARGS
}
