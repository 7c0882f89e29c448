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
// The GQA and MLA forms (paged_attn_kernel) walk each lane's table slots in
// order, one block per (lane, KV head, group of query heads), and keep the
// first version's arithmetic to the bit (its bytes are held against SHA-256
// digests of that kernel's outputs, kernels/paged_attn_check.py): each
// score one fmaf chain in ascending d over D, then D2 (a warp's lanes each
// summing d = lane (mod 32), then warp_sum's butterfly, from D + D2 >=
// WARP_ROW_MIN; else one thread's chain), times the scale; per page the
// max, expf(s - m), the lane-strided partial sums and warp_sum, c =
// expf(m_old - m) and l = fmaf(c, l, sum); each accumulator c * a, then one
// fmaf per live row in row order; int8 rows their codes times the row's
// f16 scale in f32.  Decode at these shapes is bound by latency, not by
// bytes (a gpt2 page is 4 KB, a DeepSeek page 18 KB), so the design cuts
// the latency a page pays:
// - The pipeline.  A stage holds up to pg live pages (their live K, K2
//   and V rows and, for int8 pages, the pages' f16 scales, raw), copied
//   with cp.async, 16 bytes a copy where the rows' bytes and addresses
//   allow (else 8 or 4; rows and scale planes that are not whole 4-byte
//   words take plain 2- or 1-byte copies), into a ring of 2-4 stages, so
//   the next stages' copies are in flight while the block works on the
//   current one.  Two barriers a stage: after the first the stage is
//   visible and every warp is done with the stage refilled next; after the
//   second its scores are.
//   (Where two stages of one page overflow the shared memory, one stage
//   is filled, used and, after a third barrier, refilled.)
//   The table is read 32 slots at a time, one a lane, and sentinel slots
//   and slots past the length are skipped before any copy.
// - More threads on a page.  All (head, row) scores of a stage are
//   independent, so a stage of several pages (pg from the shapes: gpt2's
//   128 threads score 8 pages of 16 rows at once) gives every thread a
//   chain; the warp path scores PA_ROWS pairs a warp at once, its loads
//   issued ahead of its fmafs.
// - Warps that own their output.  A warp owns (head, column slice) items
//   with their softmax state and accumulators in registers; a warp whose
//   slice is not a head's first runs that head's softmax too (the same
//   bits), so the page walk needs no third barrier.  Past the running
//   max, the pages of a stage do not depend on one another: their maxima,
//   probabilities and sums are taken together, their warp reductions
//   interleaved, and only m, l and the accumulators chain page by page.
// - Heads a block from the shapes and the SM count (kernels/paged_attn.py:
//   attn_plan): the fewest that keep the grid within one wave, so 4 lanes
//   of 16 DeepSeek heads take 64 blocks of one head (L2 serves the pages'
//   repeats).  The MLA form reads the latent page once for scores and
//   output.
// The stats flush changes only the last loop.  Finite -1e30 stands in for
// -inf, so dead positions never make NaNs.

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
#include <cstring>
#include <type_traits>

namespace {

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

// The largest of 16, 8 and 4 bytes (then 2 and 1, down to `least`) that
// divides `bytes` and the address `p` (every row then starts aligned to
// it), or 0.
int copy_bytes(const void* p, int bytes, int least = 4) {
  for (int v = 16; v >= least; v >>= 1) {
    if (bytes % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  }
  return 0;
}

// ---- the GQA and MLA forms: a pipelined walk in slot order ----

// The GQA/MLA kernel: a warp owns at most PA_ITEMS (head, column slice)
// items of the output, lane l columns [32 CV j + CV l, +CV) of slice j
// (CV: 4 in the MLA form, 2 in the GQA form; Dv a multiple of CV); the
// warp path scores PA_ROWS (head, row) pairs at once, PA_UNROLL columns a
// lane loaded ahead; a stage holds at most PA_PAGES pages of up to 32
// rows, or one page of up to 32 PA_PAGES rows (a lane keeps one register a
// page, or one per 32 rows of the one page).
constexpr int PA_ITEMS = 4, PA_ROWS = 4, PA_UNROLL = 4, PA_PAGES = 8;
constexpr int PA_THREADS_MAX = 512, PA_STAGES_MAX = 4;

// A staged row's stride in bytes: 16-byte aligned (cp.async's widest copy)
// and an odd number of 16-byte units, so the 8 rows that 8 neighbouring
// threads read at one offset fall in 8 distinct bank groups.
__host__ __device__ inline int row_stride(int bytes) {
  const int s = align16(bytes);
  return bytes == 0 ? 0 : (s / 16) % 2 ? s : s + 16;
}

// Shared memory of the GQA/MLA kernel, in bytes, for gb heads and nw
// warps a block and stages of pg pages each: the queries (f32), the scores
// of a stage's pages (gb x pg ps f32), each stage's page count and live
// rows (ints), each warp's probabilities and rescales of a stage (pg ps +
// PA_PAGES f32), then the stages: raw K rows, K2 rows, V rows (none when V
// is K) and, for int8 pages, two f16 scale planes (K's, and V's or K2's).
struct AttnSmem {
  int ksd, k2sd, vsd;  // row strides
  int kb, k2b, vb, sb;  // a stage's K, K2 and V rows and one scale plane
  int head, stage, total;
  __host__ __device__ AttnSmem(int gb, int nw, int D, int D2, int Dv, int ps, int item,
                               bool quant, bool v_is_k, int pg, int stages) {
    ksd = row_stride(D * item), k2sd = row_stride(D2 * item);
    vsd = v_is_k ? ksd : row_stride(Dv * item);
    kb = pg * ps * ksd, k2b = pg * ps * k2sd, vb = v_is_k ? 0 : pg * ps * vsd;
    sb = quant ? align16(pg * ps * 2) : 0;
    head = align16(4 * (gb * (D + D2) + gb * pg * ps + stages * (pg + 1)
                        + nw * (pg * ps + PA_PAGES)));
    stage = kb + k2b + vb + 2 * sb;
    total = head + stages * stage;
  }
};

__device__ __forceinline__ void cp_async_wait(int pending) {
  // cp.async.wait_group takes an immediate: at most `pending` groups in flight
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// One piece of `w` bytes of a stage: cp.async for 16, 8 or 4 bytes; a
// plain load and store for the 2 or 1 bytes of rows that are not whole
// 4-byte words (and of int8 pages' scale planes at an odd ps).  The stage
// being filled is one no warp reads before the barrier that makes it
// visible, so both kinds of copy land in time.
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src, int w) {
  if (w >= 4) {
    cp_async(dst, src, w);
  } else if (w == 2) {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  } else {
    *dst = *src;
  }
}

// Start the copies of `rows` rows of `row_bytes` bytes, `w` bytes a copy,
// neighbouring threads on neighbouring bytes (NARROW: w may be under 4).
template <bool NARROW>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src, size_t src_stride,
                                          int row_bytes, int rows, int w, int tid, int nt) {
  const int per = row_bytes / w, dr = nt / per, dc = nt - dr * per;
  int r = tid / per, c = tid - r * per;  // copy e = r per + c, stepped by nt
  for (int e = tid; e < rows * per; e += nt) {
    if constexpr (NARROW) {
      copy_piece(dst + r * dst_stride + c * w, src + r * src_stride + c * w, w);
    } else {
      cp_async(dst + r * dst_stride + c * w, src + r * src_stride + c * w, w);
    }
    r += dr, c += dc;
    if (c >= per) c -= per, ++r;
  }
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// N consecutive staged values at p (aligned to their bytes) as f32; int8
// codes times their row's scale sc, in f32 (what the first version staged).
template <typename TP, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float sc, float (&x)[N]) {
  using R = typename Raw<N * (int)sizeof(TP)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  TP v[N];
  memcpy(v, &raw, sizeof(raw));
#pragma unroll
  for (int t = 0; t < N; ++t) {
    x[t] = to_f(v[t]);
    if constexpr (std::is_same<TP, int8_t>::value) x[t] = __fmul_rn(x[t], sc);
  }
}

// One value of a staged row as f32.
template <typename TP>
__device__ __forceinline__ float load_one(const unsigned char* row, int d, float sc) {
  float x[1];
  load_vals<TP, 1>(row + d * sizeof(TP), sc, x);
  return x[0];
}

// s + q . row over n values in ascending order, one fmaf each (the first
// version's chain); the staged row is 16-byte aligned, and n * sizeof(TP)
// a multiple of 4 unless NARROW.
template <typename TP, bool NARROW>
__device__ __forceinline__ float dot_chain(const float* qg, const unsigned char* row, int n,
                                           float sc, float s) {
  constexpr int V16 = 16 / sizeof(TP), V4 = 4 / sizeof(TP);
  int d = 0;
#pragma unroll 2
  for (; d + V16 <= n; d += V16) {
    float x[V16];
    load_vals<TP, V16>(row + d * sizeof(TP), sc, x);
#pragma unroll
    for (int t = 0; t < V16; ++t) s = fmaf(qg[d + t], x[t], s);
  }
  for (; NARROW ? d + V4 <= n : d < n; d += V4) {
    float x[V4];
    load_vals<TP, V4>(row + d * sizeof(TP), sc, x);
#pragma unroll
    for (int t = 0; t < V4; ++t) s = fmaf(qg[d + t], x[t], s);
  }
  if constexpr (NARROW) {
    for (; d < n; ++d) s = fmaf(qg[d], load_one<TP>(row, d, sc), s);
  }
  return s;
}

// TQ: queries and output; TP: pages (int8_t: codes with f16 scales ksc,
// k2sc, vsc of (P, ps), else the scale pointers are unused).  D2 = 0
// without a second stream.  Block (b, h, z) owns query heads [z G, +G) of
// the Gt that share KV head h, blockDim.x threads (a multiple of 32).
// ROW_WARP: a warp (else a thread) per (head, row) score.  STATS: the K3
// flush (f32 acc into out, the running max and denominator into m_out and
// l_out), else the normalized output in TQ.  The table is append-only:
// slot p holds page p.  pg: pages a stage; stages: the ring's depth (1 to
// PA_STAGES_MAX; 1 where two stages of one page do not fit); vk, vk2, vv,
// vs: bytes a copy of the K, K2 and V rows and the scale planes (16, 8 or
// 4 by cp.async; 2 or 1 by a plain copy).  NARROW: a copy may be under 4
// bytes, a row's bytes and Dv need not be multiples of 4 and of CV; the
// shapes of every configuration of the port take the other instance,
// which carries none of that code.
template <typename TQ, typename TP, bool V_IS_K, bool ROW_WARP, bool STATS, bool NARROW>
__global__ void __launch_bounds__(PA_THREADS_MAX) paged_attn_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ q2,
    const TP* __restrict__ kp, const TP* __restrict__ k2p,
    const TP* __restrict__ vp, const __half* __restrict__ ksc,
    const __half* __restrict__ k2sc, const __half* __restrict__ vsc,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    std::conditional_t<STATS, float, TQ>* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int Gt, int G,
    int D, int D2, int Dv, int P, int ps, int n_slots, int pg, int stages, int vk, int vk2,
    int vv, int vs, float scale) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  constexpr int CV = V_IS_K ? 4 : 2, SW = 32 * CV;  // columns a lane, a slice
  constexpr int IT = (int)sizeof(TP);
  extern __shared__ __align__(16) unsigned char psm[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const AttnSmem L(G, nw, D, D2, Dv, ps, IT, QUANT, V_IS_K, pg, stages);
  const int RG = pg * ps, ppr = (ps + 31) / 32;  // rows of a stage; registers a page
  float* qs = reinterpret_cast<float*>(psm);  // G*D
  float* q2s = qs + G * D;                    // G*D2
  float* ss = q2s + G * D2;                   // G*RG scores of the stage's rows
  int* meta = reinterpret_cast<int*>(ss + G * RG);  // a stage: its pages, their live rows
  float* pw = reinterpret_cast<float*>(meta + stages * (pg + 1)) + warp * (RG + PA_PAGES);
  unsigned char* stage0 = psm + L.head;

  const size_t head = ((size_t)b * Hkv + h) * Gt + (size_t)blockIdx.z * G;  // first query head

  // the first 32 table slots, one a lane (loaded beside the length)
  int wbase = 0;
  int tw = lane < n_slots ? tables[(size_t)b * n_slots + lane] : P;
  const int length = lengths[b];
  // every value here is uniform across the block, so whole pages skip together
  const int n_walk = length <= 0 ? 0 : min(n_slots, (length + ps - 1) / ps);
  unsigned live = __ballot_sync(FULL, lane < n_walk && tw >= 0 && tw < P);
  // the first live slot after `slot`, or n_walk: the window of 32 slots
  // moves forward as the walk does
  auto next_live = [&](int slot) {
    for (int s = slot + 1; s < n_walk;) {
      if (s >= wbase + 32) {
        wbase = s & ~31;
        tw = wbase + lane < n_walk ? tables[(size_t)b * n_slots + wbase + lane] : P;
        live = __ballot_sync(FULL, tw >= 0 && tw < P);
      }
      const unsigned ahead = live >> (s - wbase);
      if (ahead) return s + __ffs(ahead) - 1;
      s = wbase + 32;
    }
    return n_walk;
  };

  // fill stage st with the next pg live pages after slot `cursor`: start
  // the copies of their live rows (and int8 pages' scales), record each
  // page's live rows and their count
  int cursor = -1;
  const auto* kb = reinterpret_cast<const unsigned char*>(kp);
  const auto* k2b = reinterpret_cast<const unsigned char*>(k2p);
  const auto* vb = reinterpret_cast<const unsigned char*>(vp);
  const int rowk = D * IT, rowk2 = D2 * IT, rowv = Dv * IT;
  auto prefetch = [&](int st) {
    unsigned char* sk = stage0 + st * L.stage;
    int* sm = meta + st * (pg + 1);
    int cnt = 0;
    for (; cnt < pg; ++cnt) {
      const int slot = next_live(cursor);
      if (slot >= n_walk) break;
      cursor = slot;
      const int phys = __shfl_sync(FULL, tw, slot - wbase);
      const int nv = min(ps, length - slot * ps);  // live rows [0, nv) of the page
      const size_t row0 = (size_t)phys * ps;  // also the rows' index in a scale plane
      const int R0 = cnt * ps;
      copy_rows<NARROW>(sk + R0 * L.ksd, L.ksd, kb + (row0 * Hkv + h) * rowk,
                        (size_t)Hkv * rowk, rowk, nv, vk, tid, nt);
      if (D2) {
        copy_rows<NARROW>(sk + L.kb + R0 * L.k2sd, L.k2sd, k2b + (row0 * Hkv + h) * rowk2,
                          (size_t)Hkv * rowk2, rowk2, nv, vk2, tid, nt);
      }
      if (!V_IS_K) {
        copy_rows<NARROW>(sk + L.kb + L.k2b + R0 * L.vsd, L.vsd, vb + (row0 * Hkv + h) * rowv,
                          (size_t)Hkv * rowv, rowv, nv, vv, tid, nt);
      }
      if constexpr (QUANT) {
        unsigned char* sc = sk + L.kb + L.k2b + L.vb + R0 * 2;
        const auto* pa = reinterpret_cast<const unsigned char*>(ksc + row0);
        const auto* pb = reinterpret_cast<const unsigned char*>((V_IS_K ? k2sc : vsc) + row0);
        for (int o = tid * vs; o < ps * 2; o += nt * vs) {
          if constexpr (NARROW) {
            copy_piece(sc + o, pa + o, vs);
            copy_piece(sc + L.sb + o, pb + o, vs);
          } else {
            cp_async(sc + o, pa + o, vs);
            cp_async(sc + L.sb + o, pb + o, vs);
          }
        }
      }
      if (tid == 0) sm[1 + cnt] = nv;
    }
    if (tid == 0) sm[0] = cnt;
  };

  for (int s = 0; s < stages - 1; ++s) {
    prefetch(s);
    cp_async_commit();
  }
  for (int e = tid; e < G * D; e += nt) qs[e] = to_f(q[head * D + e]);
  for (int e = tid; e < G * D2; e += nt) q2s[e] = to_f(q2[head * D2 + e]);

  // the warp's items (head g, slice j): softmax state and accumulators
  const int nsl = (Dv + SW - 1) / SW, items = G * nsl;
  float acc[PA_ITEMS][CV], m_run[PA_ITEMS], l_run[PA_ITEMS];
#pragma unroll
  for (int it = 0; it < PA_ITEMS; ++it) {
    m_run[it] = NEG, l_run[it] = 0.f;
#pragma unroll
    for (int t = 0; t < CV; ++t) acc[it][t] = 0.f;
  }

  for (int st = 0;; st = st + 1 == stages ? 0 : st + 1) {
    if (stages == 1) {  // no ring: fill the one stage, wait for it, use it
      prefetch(0);
      cp_async_commit();
    }
    cp_async_wait(max(stages - 2, 0));
    __syncthreads();  // stage st staged; every warp is done with the stage refilled next
    const int* sm = meta + st * (pg + 1);
    const int cnt = sm[0];
    if (cnt == 0) break;
    if (stages > 1) {
      prefetch(st == 0 ? stages - 1 : st - 1);
      cp_async_commit();
    }

    const unsigned char* sk = stage0 + st * L.stage;
    const unsigned char* sk2 = sk + L.kb;
    const unsigned char* sv = V_IS_K ? sk : sk + L.kb + L.k2b;
    const int vsd = V_IS_K ? L.ksd : L.vsd;
    const __half* sca = reinterpret_cast<const __half*>(sk + L.kb + L.k2b + L.vb);
    const __half* scb = reinterpret_cast<const __half*>(sk + L.kb + L.k2b + L.vb + L.sb);
    const __half* ks_sc = sca;                // K's scales
    const __half* k2_sc = scb;                // K2's (MLA)
    const __half* v_sc = V_IS_K ? sca : scb;  // V's: K's in the MLA form
    auto row_live = [&](int R) { return R / ps < cnt && R % ps < sm[1 + R / ps]; };

    // scores of every live (head, row) pair of the stage, each in the first
    // version's order, times the scale
    if constexpr (ROW_WARP) {
      // a warp takes PA_ROWS consecutive rows of one head at a time
      const int groups = (RG + PA_ROWS - 1) / PA_ROWS;
      for (int e = warp; e < G * groups; e += nw) {
        const int g = e / groups, R0 = (e - g * groups) * PA_ROWS;
        int rr[PA_ROWS];
        bool ok[PA_ROWS];
        float s[PA_ROWS], sk_[PA_ROWS], sk2_[PA_ROWS];
#pragma unroll
        for (int u = 0; u < PA_ROWS; ++u) {
          ok[u] = R0 + u < RG && row_live(R0 + u);
          rr[u] = ok[u] ? R0 + u : 0;  // row 0 is always live: read it, drop it
          s[u] = 0.f;
          sk_[u] = QUANT ? __half2float(ks_sc[rr[u]]) : 1.f;
          sk2_[u] = QUANT ? __half2float(k2_sc[rr[u]]) : 1.f;
        }
        // lane l's columns d = l, l + 32, ... of each stream, in order;
        // PA_UNROLL of them loaded ahead of their fmafs
        auto stream = [&](const float* qg, int n, const unsigned char* kbase, int stride,
                          const float (&sc)[PA_ROWS]) {
          for (int d0 = lane; d0 < n; d0 += 32 * PA_UNROLL) {
            float qx[PA_UNROLL], kx[PA_UNROLL][PA_ROWS];
#pragma unroll
            for (int j = 0; j < PA_UNROLL; ++j) {
              const int d = min(d0 + 32 * j, n - 1);
              qx[j] = qg[d];
#pragma unroll
              for (int u = 0; u < PA_ROWS; ++u) {
                kx[j][u] = load_one<TP>(kbase + rr[u] * stride, d, sc[u]);
              }
            }
#pragma unroll
            for (int j = 0; j < PA_UNROLL; ++j) {
              if (d0 + 32 * j < n) {
#pragma unroll
                for (int u = 0; u < PA_ROWS; ++u) s[u] = fmaf(qx[j], kx[j][u], s[u]);
              }
            }
          }
        };
        stream(qs + g * D, D, sk, L.ksd, sk_);
        stream(q2s + g * D2, D2, sk2, L.k2sd, sk2_);
#pragma unroll
        for (int u = 0; u < PA_ROWS; ++u) s[u] = warp_sum(s[u]);
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < PA_ROWS; ++u) {
            if (ok[u]) ss[g * RG + rr[u]] = __fmul_rn(s[u], scale);
          }
        }
      }
    } else {
      for (int e = tid; e < G * RG; e += nt) {
        const int g = e / RG, R = e - g * RG;
        if (!row_live(R)) continue;
        float s = dot_chain<TP, NARROW>(qs + g * D, sk + R * L.ksd, D,
                                        QUANT ? __half2float(ks_sc[R]) : 1.f, 0.f);
        if (D2) {
          s = dot_chain<TP, NARROW>(q2s + g * D2, sk2 + R * L.k2sd, D2,
                                    QUANT ? __half2float(k2_sc[R]) : 1.f, s);
        }
        ss[g * RG + R] = __fmul_rn(s, scale);
      }
    }
    __syncthreads();  // the stage's scores are in ss

    // each item (head g, column slice) over the stage's pages in slot
    // order: per page the online softmax of g over its live rows, then P V
    // on the slice's columns.  The pages' maxima, probabilities and sums
    // do not depend on one another past the running max, so they are
    // taken for all of the stage's pages at once (each in the first
    // version's order: lane l holds rows l, l + 32, ... of a page, then
    // warp_max and warp_sum), their reductions interleaved and free of
    // branches (a slot past the stage's pages holds max -1e30 and sum 0,
    // so its rescale is exactly 1); only m, l and the accumulators chain
    // from page to page.  Every warp holding a slice of head g runs g's
    // softmax, to the same bits.
#pragma unroll
    for (int it = 0; it < PA_ITEMS; ++it) {
      const int item = warp + it * nw;
      if (item >= items) continue;  // uniform in the warp
      const int g = item / nsl, c0 = (item - g * nsl) * SW + lane * CV;
      // a lane past Dv reads other columns, unused; NARROW: a lane across Dv
      // reads its CV columns whole, those past Dv from the row's padding
      const int cr = NARROW ? (c0 < Dv ? c0 : 0) : min(c0, Dv - CV);
      const float* sg = ss + g * RG;
      // slot j of a lane: row 32 kk + lane of page k, (k, kk) = (j, 0) for
      // pages of up to 32 rows, else (0, j) (a stage of one page)
      float v[PA_PAGES], pm[PA_PAGES], psum[PA_PAGES], mk[PA_PAGES];
      bool live[PA_PAGES];
#pragma unroll
      for (int j = 0; j < PA_PAGES; ++j) {
        const int k = ppr == 1 ? j : 0, r = ppr == 1 ? lane : 32 * j + lane;
        live[j] = k < cnt && r < sm[1 + k];
        v[j] = live[j] ? sg[k * ps + r] : NEG;
        pm[j] = fmaxf(NEG, v[j]);
      }
      if (ppr > 1) {  // one page: its lane partial over the slots, in row order
#pragma unroll
        for (int j = 1; j < PA_PAGES; ++j) pm[0] = fmaxf(pm[0], pm[j]), pm[j] = NEG;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < PA_PAGES; ++k) pm[k] = fmaxf(pm[k], __shfl_xor_sync(FULL, pm[k], off));
      }
      float m = m_run[it];
#pragma unroll
      for (int k = 0; k < PA_PAGES; ++k) mk[k] = m = fmaxf(m, pm[k]);
#pragma unroll
      for (int j = 0; j < PA_PAGES; ++j) {
        const float e = expf(v[j] - (ppr == 1 ? mk[j] : mk[0]));
        if (live[j]) pw[(ppr == 1 ? j * ps : 32 * j) + lane] = e;
        psum[j] = 0.f + (live[j] ? e : 0.f);
      }
      if (ppr > 1) {
#pragma unroll
        for (int j = 1; j < PA_PAGES; ++j) psum[0] += psum[j], psum[j] = 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < PA_PAGES; ++k) psum[k] += __shfl_xor_sync(FULL, psum[k], off);
      }
      float m_old = m_run[it], l = l_run[it];
#pragma unroll
      for (int k = 0; k < PA_PAGES; ++k) {
        const float c = expf(m_old - mk[k]);
        l = fmaf(c, l, psum[k]);  // the first version's c * l + sum, contracted
        m_old = mk[k];
        if (lane == k) pw[RG + k] = c;
      }
      m_run[it] = m_old, l_run[it] = l;
      __syncwarp();  // the warp's probabilities and rescales are in pw
      for (int k = 0; k < cnt; ++k) {
        const float c = pw[RG + k];
#pragma unroll
        for (int t = 0; t < CV; ++t) acc[it][t] = __fmul_rn(c, acc[it][t]);
        const int R1 = k * ps + sm[1 + k];
        for (int r = k * ps; r < R1; r += 4) {  // 4 rows loaded ahead of their fmafs
          float p[4], x[4][CV];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ru = min(r + u, R1 - 1);
            p[u] = pw[ru];
            load_vals<TP, CV>(sv + ru * vsd + cr * IT, QUANT ? __half2float(v_sc[ru]) : 1.f, x[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (r + u < R1) {
#pragma unroll
              for (int t = 0; t < CV; ++t) acc[it][t] = fmaf(p[u], x[u][t], acc[it][t]);
            }
          }
        }
      }
      __syncwarp();  // every lane is done with pw before the next item refills it
    }
    if (stages == 1) __syncthreads();  // every warp is done with the stage
  }

#pragma unroll
  for (int it = 0; it < PA_ITEMS; ++it) {
    const int item = warp + it * nw;
    if (item >= items) continue;
    const int g = item / nsl, j = item - g * nsl, c0 = j * SW + lane * CV;
    const size_t row = head + g;
#pragma unroll
    for (int t = 0; t < CV; ++t) {
      if (c0 + t >= Dv) continue;
      if constexpr (STATS) {
        out[row * Dv + c0 + t] = acc[it][t];
      } else {
        out[row * Dv + c0 + t] = from_f<TQ>(acc[it][t] / fmaxf(l_run[it], 1e-30f));
      }
    }
    if (STATS && j == 0 && lane == 0) {
      m_out[row] = m_run[it];
      l_out[row] = l_run[it];
    }
  }
}

template <typename TQ, typename TP, bool V_IS_K, bool STATS>
int launch(const void* q, const void* q2, const void* k, const void* k2,
           const void* v, const void* ksc, const void* k2sc, const void* vsc,
           const void* tables, const void* lengths, void* out, void* m_out,
           void* l_out, int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
           int n_slots, float scale, int gb, int threads, int pg, int stages,
           cudaStream_t s) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  constexpr int item = (int)sizeof(TP), SW = 32 * (V_IS_K ? 4 : 2);
  const int vk = copy_bytes(k, D * item, 1), vk2 = D2 ? copy_bytes(k2, D2 * item, 1) : 16;
  const int vv = V_IS_K ? 16 : copy_bytes(v, Dv * item, 1);
  int vs = 16;
  if (QUANT) {
    const int a = copy_bytes(ksc, ps * 2, 2), c = copy_bytes(V_IS_K ? k2sc : vsc, ps * 2, 2);
    vs = a < c ? a : c;
  }
  const int smem = AttnSmem(gb, threads / 32, D, D2, Dv, ps, item, QUANT, V_IS_K, pg,
                            stages).total;
  if (gb < 1 || G % gb || threads < 32 || threads > PA_THREADS_MAX || threads % 32
      || gb * ((Dv + SW - 1) / SW) > threads / 32 * PA_ITEMS || pg < 1 || stages < 1
      || stages > PA_STAGES_MAX || ps > 32 * PA_PAGES || (ps > 32 ? pg > 1 : pg > PA_PAGES)
      || smem > SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool narrow = vk < 4 || vk2 < 4 || vv < 4 || vs < 4 || Dv % (SW / 32);
  auto kernel = D + D2 >= WARP_ROW_MIN
                    ? (narrow ? paged_attn_kernel<TQ, TP, V_IS_K, true, STATS, true>
                              : paged_attn_kernel<TQ, TP, V_IS_K, true, STATS, false>)
                    : (narrow ? paged_attn_kernel<TQ, TP, V_IS_K, false, STATS, true>
                              : paged_attn_kernel<TQ, TP, V_IS_K, false, STATS, false>);
  if (smem > 48 * 1024) {  // past the default: opt in, or fail the launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, Hkv, G / gb), threads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(q2),
      static_cast<const TP*>(k), static_cast<const TP*>(k2),
      static_cast<const TP*>(v), static_cast<const __half*>(ksc),
      static_cast<const __half*>(k2sc), static_cast<const __half*>(vsc),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<std::conditional_t<STATS, float, TQ>*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), Hkv, G, gb, D, D2,
      Dv, P, ps, n_slots, pg, stages, vk, vk2, vv, vs, scale);
  return static_cast<int>(cudaGetLastError());
}

// The launch of one (form, flush, query type) over any page type.
template <bool V_IS_K, bool STATS, typename TQ>
int launch_pages(int q_dtype, int page_dtype, const void* q, const void* q2,
                 const void* k, const void* k2, const void* v, const void* ksc,
                 const void* k2sc, const void* vsc, const void* tables,
                 const void* lengths, void* out, void* m_out, void* l_out,
                 int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,
                 int n_slots, float scale, int gb, int threads, int pg, int stages,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, q2, k, k2, v, ksc, k2sc, vsc, tables, lengths, out, m_out, l_out, \
                B, Hkv, G, D, D2, Dv, P, ps, n_slots, scale, gb, threads, pg, stages, s
  if (page_dtype == 2) return launch<TQ, int8_t, V_IS_K, STATS>(PA_ARGS);
  if (page_dtype == 0) return launch<TQ, float, V_IS_K, STATS>(PA_ARGS);
  return launch<TQ, __nv_bfloat16, V_IS_K, STATS>(PA_ARGS);
#undef PA_ARGS
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

// The file compiles whole, or in nine parts (KERNEL_PART 0-8) that
// kernels/dispatch.py builds in parallel and links into one library: part
// 4 * V_IS_K + 2 * STATS + (bf16 queries) holds that (form, flush, query
// type) of the GQA and MLA launches with its 12 kernel instances, part 8
// the window form and the C entry points.
#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif
#define IN_PART(p) (KERNEL_PART < 0 || KERNEL_PART == (p))

#define PA_TYPES_PARAMS int q_dtype, int page_dtype, const void* q, const void* q2,      \
    const void* k, const void* k2, const void* v, const void* ksc, const void* k2sc,    \
    const void* vsc, const void* tables, const void* lengths, void* out, void* m_out,    \
    void* l_out, int B, int Hkv, int G, int D, int D2, int Dv, int P, int ps,           \
    int n_slots, float scale, int gb, int threads, int pg, int stages, void* stream
#define PA_TYPES_ARGS q_dtype, page_dtype, q, q2, k, k2, v, ksc, k2sc, vsc, tables,      \
    lengths, out, m_out, l_out, B, Hkv, G, D, D2, Dv, P, ps, n_slots, scale, gb,        \
    threads, pg, stages, stream
#define PA_PART_DEF(V_IS_K, STATS, TQ)                                                  \
  { return launch_pages<V_IS_K, STATS, TQ>(PA_TYPES_ARGS); }
int pa_part0(PA_TYPES_PARAMS);
int pa_part1(PA_TYPES_PARAMS);
int pa_part2(PA_TYPES_PARAMS);
int pa_part3(PA_TYPES_PARAMS);
int pa_part4(PA_TYPES_PARAMS);
int pa_part5(PA_TYPES_PARAMS);
int pa_part6(PA_TYPES_PARAMS);
int pa_part7(PA_TYPES_PARAMS);
#if IN_PART(0)
int pa_part0(PA_TYPES_PARAMS) PA_PART_DEF(false, false, float)
#endif
#if IN_PART(1)
int pa_part1(PA_TYPES_PARAMS) PA_PART_DEF(false, false, __nv_bfloat16)
#endif
#if IN_PART(2)
int pa_part2(PA_TYPES_PARAMS) PA_PART_DEF(false, true, float)
#endif
#if IN_PART(3)
int pa_part3(PA_TYPES_PARAMS) PA_PART_DEF(false, true, __nv_bfloat16)
#endif
#if IN_PART(4)
int pa_part4(PA_TYPES_PARAMS) PA_PART_DEF(true, false, float)
#endif
#if IN_PART(5)
int pa_part5(PA_TYPES_PARAMS) PA_PART_DEF(true, false, __nv_bfloat16)
#endif
#if IN_PART(6)
int pa_part6(PA_TYPES_PARAMS) PA_PART_DEF(true, true, float)
#endif
#if IN_PART(7)
int pa_part7(PA_TYPES_PARAMS) PA_PART_DEF(true, true, __nv_bfloat16)
#endif

#if IN_PART(8)
// The GQA and MLA launches by part: 4 * V_IS_K + 2 * STATS + (q_dtype != 0).
using PaLaunch = int (*)(PA_TYPES_PARAMS);
const PaLaunch PA_LAUNCH[8] = {pa_part0, pa_part1, pa_part2, pa_part3,
                               pa_part4, pa_part5, pa_part6, pa_part7};
#undef PA_TYPES_PARAMS
#undef PA_TYPES_ARGS
#undef PA_PART_DEF

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
// f32 acc into out.  The GQA and MLA entries take their launch plan (gb
// heads a block, threads a block, pg pages a stage, stages; kernels/
// paged_attn.py:attn_plan) and return cudaErrorInvalidValue for a plan the
// kernel does not take (its shared memory past SMEM_MAX included).  Each
// returns the error of the shared-memory opt-in, else
// cudaGetLastError() after its launches.  The wrapper
// (kernels/paged_attn.py) checks shapes, types and contiguity.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* lengths,
                                 void* out, void* m_out, void* l_out, int B,
                                 int Hkv, int G, int D, int Dv, int P, int ps,
                                 int n_slots, int gb, int threads, int pg, int stages,
                                 float scale, int q_dtype, int page_dtype, void* stream) {
#define PA_GQA_ARGS q_dtype, page_dtype, q, nullptr, k, nullptr, v, k_scale, nullptr, \
                    v_scale, tables, lengths, out, m_out, l_out, B, Hkv, G, D, 0, Dv, \
                    P, ps, n_slots, scale, gb, threads, pg, stages, stream
  return PA_LAUNCH[2 * (m_out != nullptr) + (q_dtype != 0)](PA_GQA_ARGS);
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
                                     int ps, int n_slots, int gb, int threads, int pg,
                                     int stages, float scale, int q_dtype, int page_dtype,
                                     void* stream) {
#define PA_MLA_ARGS q_dtype, page_dtype, q, q2, k, k2, nullptr, k_scale, k2_scale, \
                    nullptr, tables, lengths, out, m_out, l_out, B, Hkv, G, D, D2, D, \
                    P, ps, n_slots, scale, gb, threads, pg, stages, stream
  return PA_LAUNCH[4 + 2 * (m_out != nullptr) + (q_dtype != 0)](PA_MLA_ARGS);
#undef PA_MLA_ARGS
}
#endif  // IN_PART(8)
