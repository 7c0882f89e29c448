// Compressed N:M matmul y = x @ decompress(values, indices), for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:_nm_spmm_kernel
// (launched by nm_spmm_pallas).  Layout: x (B, K) row-major; values and
// uint8 indices (K*n/m, O) row-major, where compressed row r belongs to
// group r / n and expands to dense row (r / n) * m + indices[r, o]; y is
// (B, o_true) with o_true <= O (the trailing O - o_true alignment columns
// of a padded artifact are never written).  f32 accumulation, output in
// x's type (bf16 or f32; values share it).
//
// Three bodies, each summing every output in one order fixed by the
// weight's shapes, never by B or by which rows share a call, so a row of x
// gives the same bytes alone or beside others, call after call:
//
// - decode (B <= 8 rows), and every f32 call: the first version's order.
//   An output (b, o) is the fold, in the order w = 0, 1, ..., 7 from 0, of
//   eight chains: chain w is the fma, in order, of the kept rows of the
//   groups whose place in their chunk of 256 / m groups is w, w + 8, ...
//   (chunk by chunk, each group's n rows in turn).  nm_spmm_decode and the
//   first version's body (nm_spmm_prefill) both sum so.
// - bf16 prefill (B > 8): the tensor-core body nm_spmm_tc.  An output is
//   the f32 sum, in k order from 0, of one term per 32 dense columns of K:
//   two chained mma.sync m16n8k16 steps (bf16 products, the tensor core's
//   f32 accumulation) over those columns.  Its order is its own, fixed by
//   K and the MMA shape alone; its bytes differ from decode's.
//
// What bounds decode (B <= 8 rows): the weight stream.  A 2:4 bf16 weight
// moves 3 bytes per kept element (2 of value, 1 of index) for B FMAs each,
// so the card's memory rate is the limit, and reaching it takes megabytes
// of loads in flight across the card.  The first version kept two rows in
// flight per thread, read x from shared memory once per row of x, and ran
// at about 200 GB/s.  Its order leaves eight independent chains per
// output, so the decode kernel, nm_spmm_decode, runs them as the eight
// warps of a block and:
//
// - keeps U kept rows of its chain in flight per lane: a ring of
//   registers, each slot refilled with the row U ahead the moment it is
//   used (the loads read-only and not kept in L1);
// - gives a lane C adjacent output columns, C = 4 (8-byte loads of bf16
//   values, 4-byte of offsets; U = 16) where the columns still make enough
//   blocks to fill the card, else C = 1 (2- and 1-byte loads; U = 32): a
//   warp's load covers 32 * C neighbouring columns of one kept row;
// - stages all of x once per block, as (k, BM) with BM = 4 or 8 rows
//   (zeros past B): f32 for f32 x, for bf16 x words of two rows' bf16
//   (exact), so a kept value reads its BM rows of x as one 8- or 16-byte
//   shared load (two for f32 at BM = 8) and does BM FMAs.
//
// The eight chains' sums meet in shared memory in the fold's order.  The
// wrapper (kernels/nm_spmm.py:decode_cols) picks C from the shapes.  Where
// x does not fit the staging budget (decode of a long K), and for f32 x
// of more than 8 rows, the first version's body runs: the same eight
// warps over 32 columns and 32 rows of x, x staged in chunks of 256 dense
// columns, the weight re-read once per 32-row tile.
//
// What bounds bf16 prefill: at B = 256 a gpt2 matmul does about 90
// operations per byte it must move (bytes bound it, under the card's
// 295), at B = 2048 RecurrentGemma's MLP about 700 (operations do).  The
// first version's body reached neither: f32 FMAs on CUDA cores at about 6
// TFLOP/s, the whole compressed weight re-read once per 32 rows.
// nm_spmm_tc does what the TPU kernel does (decompress a tile in fast
// memory, then one f32-accumulated dot) on the tensor cores:
//
// - a block owns a BM x BN output tile and walks K in steps of bk (a
//   multiple of m and of 32), through a ring of two stages that 16-byte
//   cp.async copies fill, the next step's while this one is used: the
//   step's x tile (BM x bk bf16, rows padded by 16 bytes so ldmatrix reads
//   without bank conflicts), its compressed values (bk n/m x BN) and uint8
//   offsets (zeros past B, K and O; where a row is not 16-byte aligned,
//   plain loads of 2 or 1 bytes fill it);
// - each step expands its compressed tile into one dense bf16 bk x BN tile
//   in shared memory, exactly: a thread takes a group's 4 adjacent columns
//   and writes each of the group's m rows, the kept value whose offset it
//   is or 0 (offsets within a group are distinct, as compression stores
//   them);
// - warps then run ldmatrix (x4, and .trans on the dense tile) and
//   mma.sync.m16n8k16 in bf16 with f32 results.  wgmma would reach more of
//   the card's rate, but asks for its operands in its own shared-memory
//   layouts through descriptors, with async-proxy fences, where
//   mma.sync's fragments can be checked against the PTX ISA by reading
//   alone (the card offers no profiler or sanitizer).  Every 32 columns
//   of K, the chained result is added to the output's f32 sum with an IEEE
//   add: the tensor core's own accumulation over all of K drifted past one
//   bf16 step of the plain version;
// - the epilogue rounds each f32 sum to bf16 once, masking the B and o_true
//   edges.
//
// What still bounds it (builds with a part removed, timed on an H100): at
// B = 2048 the tiles' loads (x re-read per column tile, the weight per row
// tile), the expansion (repeated per row tile) and the MMAs take
// comparable time and overlap little.  The tiles: 64 x 64 over 8 warps
// for one weight, 32 x 128 over 4 for expert stacks (few rows an
// expert).  The wrapper (kernels/nm_spmm.py:prefill_plan) picks the tile
// and bk from the weight's shapes, never from B.
//
// nm_spmm_batched_launch runs the same kernels over a stack of E
// independent products (the compressed MoE expert stacks, which the TPU
// reference vmaps over at src/repro/models/layers.py:66-74): blockIdx.z
// picks the expert and every operand advances by its own 64-bit
// per-expert stride, so one launch streams all E weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Per-expert element strides of a batched launch (all 0 for one product).
struct Strides {
  long long x, w, y;
};

constexpr int CHAINS = 8;     // chains an output folds, one warp each
constexpr int CHUNK = 256;    // dense columns of x a chunk of the order spans

// ---- decode: B <= 8 rows ----

// 32-bit words of staged x per dense column: bf16 pairs, or f32
template <typename T, int BM>
__host__ __device__ constexpr int words_per_k() { return sizeof(T) == 2 ? BM / 2 : BM; }

// NB bytes at p into r (zero-extended below 4 bytes): read-only, not kept
// in L1
template <int NB>
__device__ __forceinline__ void ld_stream(uint32_t* r, const void* p) {
  if constexpr (NB == 1) {
    asm("ld.global.nc.L1::no_allocate.u8 %0, [%1];" : "=r"(r[0]) : "l"(p));
  } else if constexpr (NB == 2) {
    uint16_t v;
    asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
    r[0] = v;
  } else if constexpr (NB == 4) {
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r[0]) : "l"(p));
  } else if constexpr (NB == 8) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(r[0]), "=r"(r[1]) : "l"(p));
  } else {
    static_assert(NB == 16, "1, 2, 4, 8 or 16 bytes");
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "l"(p));
  }
}

// 32-bit words holding NB bytes
template <int NB>
__host__ __device__ constexpr int words_of() { return NB < 4 ? 1 : NB / 4; }

// Column c's value among a lane's loaded value words, as f32
template <typename T>
__device__ __forceinline__ float value_of(const uint32_t* r, int c) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r[c]);
  } else {
    const uint32_t pair = r[c >> 1];
    return __uint_as_float((c & 1) ? pair & 0xffff0000u : pair << 16);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[b] = fma(x[b, k], v, acc[b]) for the BM rows, xk the staged x of
// dense column k.
template <typename T, int BM>
__device__ __forceinline__ void fma_col(float (&acc)[BM], const uint32_t* xk, float v) {
  if constexpr (sizeof(T) == 2 && BM == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(xk);
    acc[0] = fmaf(__uint_as_float(w.x << 16), v, acc[0]);
    acc[1] = fmaf(__uint_as_float(w.x & 0xffff0000u), v, acc[1]);
    acc[2] = fmaf(__uint_as_float(w.y << 16), v, acc[2]);
    acc[3] = fmaf(__uint_as_float(w.y & 0xffff0000u), v, acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < words_per_k<T, BM>() / 4; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(xk)[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t wd = word_of(w, i);
        if constexpr (sizeof(T) == 2) {  // rows 8q + 2i, 8q + 2i + 1
          acc[8 * q + 2 * i] = fmaf(__uint_as_float(wd << 16), v, acc[8 * q + 2 * i]);
          acc[8 * q + 2 * i + 1] =
              fmaf(__uint_as_float(wd & 0xffff0000u), v, acc[8 * q + 2 * i + 1]);
        } else {  // f32: row 4q + i
          acc[4 * q + i] = fmaf(__uint_as_float(wd), v, acc[4 * q + i]);
        }
      }
    }
  }
}

// x rows [0, B) into xs as (k, BM) staged words, zeros in rows B..BM-1:
// a thread reads 16 / sizeof(T) columns of a row at once where x's rows lie
// on 16 bytes (K a multiple of them), several loads in flight; else one
// value at a time.
template <typename T, int BM>
__device__ __forceinline__ void stage_x(uint32_t* xs, const T* x, int B, int K) {
  constexpr int XV = 16 / sizeof(T), XU = 4, NT = 32 * CHAINS, WK = words_per_k<T, BM>();
  const bool wide = K % XV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if constexpr (sizeof(T) == 2) {
    if (wide) {
      const int units = K / XV * WK;  // (column chunk c, row pair p), p fastest
      for (int u0 = threadIdx.x; u0 < units; u0 += NT * XU) {
        uint4 lo[XU], hi[XU];
#pragma unroll
        for (int q = 0; q < XU; ++q) {
          const int u = u0 + q * NT, p = u % WK;
          const uint4* src = reinterpret_cast<const uint4*>(x) + u / WK;
          lo[q] = u < units && 2 * p < B ? __ldg(src + (size_t)(2 * p) * (K / XV)) : zero;
          hi[q] = u < units && 2 * p + 1 < B ? __ldg(src + (size_t)(2 * p + 1) * (K / XV))
                                             : zero;
        }
#pragma unroll
        for (int q = 0; q < XU; ++q) {
          const int u = u0 + q * NT;
          if (u < units) {
            uint32_t* dst = xs + (u / WK) * XV * WK + u % WK;
#pragma unroll
            for (int j = 0; j < XV; ++j) {
              dst[j * WK] = __byte_perm(word_of(lo[q], j / 2), word_of(hi[q], j / 2),
                                        (j & 1) ? 0x7632 : 0x5410);
            }
          }
        }
      }
    } else {
      const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
      for (int i = threadIdx.x; i < K * WK; i += NT) {
        const int k = i / WK, p = i % WK;
        const uint32_t lo = 2 * p < B ? xb[(size_t)(2 * p) * K + k] : 0;
        const uint32_t hi = 2 * p + 1 < B ? xb[(size_t)(2 * p + 1) * K + k] : 0;
        xs[i] = lo | hi << 16;
      }
    }
  } else {
    float* xf = reinterpret_cast<float*>(xs);
    if (wide) {
      const int units = K / XV * BM;  // (column chunk c, row b), b fastest
      for (int u0 = threadIdx.x; u0 < units; u0 += NT * XU) {
        uint4 v[XU];
#pragma unroll
        for (int q = 0; q < XU; ++q) {
          const int u = u0 + q * NT, b = u % BM;
          v[q] = u < units && b < B
                     ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)b * K) + u / BM)
                     : zero;
        }
#pragma unroll
        for (int q = 0; q < XU; ++q) {
          const int u = u0 + q * NT;
          if (u < units) {
            float* dst = xf + (u / BM) * XV * BM + u % BM;
#pragma unroll
            for (int j = 0; j < XV; ++j) dst[j * BM] = __uint_as_float(word_of(v[q], j));
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < K * BM; i += NT) {
        const int k = i / BM, b = i % BM;
        xf[i] = b < B ? x[(size_t)b * K + k] : 0.f;
      }
    }
  }
}

// A lane's place in its chain: the chunk's first group cb, the group's
// place l in the chunk (w, w + 8, ...), the chunk's groups len, and the
// row j of the group.
struct Walk {
  int cb, l, len, j;
  __device__ __forceinline__ void next(int n, int gc, int groups, int w) {
    if (++j == n) {
      j = 0;
      l += CHAINS;
      if (l >= len) {
        cb += gc;
        l = w;
        len = min(gc, groups - cb);
      }
    }
  }
};

// Groups of chain w: (gc - w + 7) / 8 in each full chunk of gc, and of the
// rest in the last one.
__device__ __forceinline__ int chain_groups(int groups, int gc, int w) {
  const int full = groups / gc, rem = groups - full * gc;
  return full * (gc > w ? (gc - w + CHAINS - 1) / CHAINS : 0) +
         (rem > w ? (rem - w + CHAINS - 1) / CHAINS : 0);
}

// The chain row at `at` into a ring slot (value and offset words of the
// lane's C columns, and its group's first dense column), then step `at`
// on.
template <typename T, int C>
__device__ __forceinline__ void load_row(uint32_t (&rv)[words_of<C * (int)sizeof(T)>()],
                                         uint32_t (&ri)[words_of<C>()], int& rk, Walk& at,
                                         const T* vals, const uint8_t* idx, int O, int o,
                                         bool live, int n, int m, int gc, int groups, int w) {
  const size_t off = (size_t)((at.cb + at.l) * n + at.j) * O + o;
  if (live) {
    ld_stream<C * (int)sizeof(T)>(rv, vals + off);
    ld_stream<C>(ri, idx + off);
  }
  rk = (at.cb + at.l) * m;
  at.next(n, gc, groups, w);
}

// blockDim = 32 * CHAINS: warp w walks chain w of the block's 32 * C
// columns, a lane C adjacent ones with U kept rows in flight (a ring of
// registers, slot u refilled with the row U ahead once used); grid =
// (ceil(o_true / (32 * C)), 1, E); dynamic shared memory max(K *
// words_per_k, CHAINS * BM * 32 * C) words: all of x staged, then the
// chains' sums, which meet in the fold's order.
template <typename T, int BM, int C, int U>
__global__ void __launch_bounds__(32 * CHAINS) nm_spmm_decode(
    const T* __restrict__ x, const T* __restrict__ vals,
    const uint8_t* __restrict__ idx, T* __restrict__ y,
    int B, int K, int O, int o_true, int n, int m, Strides st) {
  extern __shared__ float4 smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  constexpr int WK = words_per_k<T, BM>(), COLS = 32 * C;
  x += blockIdx.z * st.x;
  vals += blockIdx.z * st.w;
  idx += blockIdx.z * st.w;
  y += blockIdx.z * st.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int o = blockIdx.x * COLS + lane * C;  // the lane's first column
  const bool live = o < o_true;  // then all C columns lie in O (O % C == 0)
  const int groups = K / m, gc = CHUNK / m;
  const int rows = chain_groups(groups, gc, w) * n;

  uint32_t rv[U][words_of<C * (int)sizeof(T)>()], ri[U][words_of<C>()];
  int rk[U];
  Walk at{0, w, min(gc, groups), 0};  // the next row to load
#pragma unroll
  for (int u = 0; u < U; ++u) {  // the first U rows go out before x is staged
    if (u < rows) {
      load_row<T, C>(rv[u], ri[u], rk[u], at, vals, idx, O, o, live, n, m, gc, groups, w);
    }
  }
  stage_x<T, BM>(xs, x, B, K);
  __syncthreads();

  float acc[C][BM];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int b = 0; b < BM; ++b) acc[c][b] = 0.f;
  }
  for (int t0 = 0; t0 < rows; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < rows) {
        if (live) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint32_t k = (ri[u][c >> 2] >> (8 * (c & 3))) & 0xffu;
            fma_col<T, BM>(acc[c], xs + (rk[u] + k) * WK, value_of<T>(rv[u], c));
          }
        }
        if (t0 + u + U < rows) {
          load_row<T, C>(rv[u], ri[u], rk[u], at, vals, idx, O, o, live, n, m, gc, groups, w);
        }
      }
    }
  }
  __syncthreads();  // x is read: its shared memory takes the chains' sums
  float* red = reinterpret_cast<float*>(smem);  // (CHAINS, BM, COLS)
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int b = 0; b < BM; ++b) red[(w * BM + b) * COLS + lane * C + c] = acc[c][b];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * COLS; i += 32 * CHAINS) {
    const int b = i / COLS, c = i % COLS, oc = blockIdx.x * COLS + c;
    if (b >= B || oc >= o_true) continue;
    float sum = 0.f;
    for (int ww = 0; ww < CHAINS; ++ww) sum += red[(ww * BM + b) * COLS + c];
    y[(size_t)b * o_true + oc] = from_f<T>(sum);
  }
}

template <typename T, int BM, int C>
int launch_decode(const T* x, const T* vals, const uint8_t* idx, T* y, int E, int B, int K,
                  int O, int o_true, int n, int m, cudaStream_t s) {
  constexpr int U = C == 1 ? 32 : 16;  // kept rows in flight a lane: what the registers hold
  const int smem =
      max(K * words_per_k<T, BM>(), CHAINS * BM * 32 * C) * (int)sizeof(float);
  auto kernel = nm_spmm_decode<T, BM, C, U>;
  if (smem > 48 * 1024) {  // past the default: opt in, or fail the launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Strides st{(long long)B * K, (long long)K * n / m * O, (long long)B * o_true};
  kernel<<<dim3((o_true + 32 * C - 1) / (32 * C), 1, E), 32 * CHAINS, smem, s>>>(
      x, vals, idx, y, B, K, O, o_true, n, m, st);
  return static_cast<int>(cudaGetLastError());
}

// ---- the first version's body: f32 prefill (B > 8), and decode where x does not fit ----

constexpr int PBM = 32;    // rows of x a block owns
constexpr int PCOLS = 32;  // output columns a block owns: one per lane

// blockDim = (PCOLS, CHAINS); grid = (column tiles, row tiles, experts)
template <typename T>
__global__ void __launch_bounds__(PCOLS * CHAINS) nm_spmm_prefill(
    const T* __restrict__ x, const T* __restrict__ vals,
    const uint8_t* __restrict__ idx, T* __restrict__ y,
    int B, int K, int O, int o_true, int n, int m, int bk, Strides st) {
  // x tile; after the K loop it holds the warps' partial sums
  __shared__ float xs[PBM * CHUNK];
  x += blockIdx.z * st.x;
  vals += blockIdx.z * st.w;
  idx += blockIdx.z * st.w;
  y += blockIdx.z * st.y;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * PCOLS + lane;
  const int o = blockIdx.x * PCOLS + lane;
  const int b0 = blockIdx.y * PBM;
  const bool col_ok = o < o_true;
  float acc[PBM];
#pragma unroll
  for (int i = 0; i < PBM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    const int kk = min(bk, K - k0);  // a multiple of m: K % m == 0, bk % m == 0
    __syncthreads();                 // previous chunk fully consumed
    for (int e = tid; e < PBM * kk; e += PCOLS * CHAINS) {
      const int r = e / kk, c = e - r * kk;
      const int b = b0 + r;
      xs[r * CHUNK + c] = b < B ? to_f(x[(size_t)b * K + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const int groups = kk / m;
      const size_t row0 = (size_t)(k0 / m) * n;  // first compressed row of the chunk
#pragma unroll 2
      for (int g = w; g < groups; g += CHAINS) {
        for (int j = 0; j < n; ++j) {
          const size_t off = (row0 + (size_t)g * n + j) * O + o;
          const float v = to_f(vals[off]);
          const float* xc = xs + g * m + idx[off];
#pragma unroll
          for (int i = 0; i < PBM; ++i) acc[i] = fmaf(xc[i * CHUNK], v, acc[i]);
        }
      }
    }
  }
  __syncthreads();
  float* red = xs;  // (CHAINS, PBM, PCOLS)
#pragma unroll
  for (int i = 0; i < PBM; ++i) red[(w * PBM + i) * PCOLS + lane] = acc[i];
  __syncthreads();
  for (int e = tid; e < PBM * PCOLS; e += PCOLS * CHAINS) {
    const int i = e / PCOLS, c = e - i * PCOLS;
    const int b = b0 + i, oc = blockIdx.x * PCOLS + c;
    if (b >= B || oc >= o_true) continue;
    float sum = 0.f;
    for (int ww = 0; ww < CHAINS; ++ww) sum += red[(ww * PBM + i) * PCOLS + c];
    y[(size_t)b * o_true + oc] = from_f<T>(sum);
  }
}

template <typename T>
int launch_prefill(const T* x, const T* vals, const uint8_t* idx, T* y, int E, int B, int K,
                   int O, int o_true, int n, int m, cudaStream_t s) {
  static_assert(CHAINS * PCOLS <= CHUNK, "partial sums must fit in the x tile");
  const dim3 grid((o_true + PCOLS - 1) / PCOLS, (B + PBM - 1) / PBM, E);
  const Strides st{(long long)B * K, (long long)K * n / m * O, (long long)B * o_true};
  nm_spmm_prefill<T><<<grid, dim3(PCOLS, CHAINS), 0, s>>>(x, vals, idx, y, B, K, O, o_true, n,
                                                         m, (CHUNK / m) * m, st);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 prefill (B > 8): tensor cores on expanded tiles ----

constexpr int TC_KCHUNK = 32;          // dense columns a chained pair of k16 MMAs sums
constexpr int TC_SMEM_MAX = 232448;    // a block's shared memory on the H100

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared dst, or zeros where bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// d = a b + c on one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A thread's 16-byte chunks of a tile of rows of `per_row` chunks: the
// first chunk's (row, column) and the step to the next, so a tile load
// divides nothing.
struct Chunks {
  int r, k, dr, dk;
  __device__ Chunks(int tid, int nt, int per_row, int v)
      : r(tid / per_row), k(tid % per_row * v), dr(nt / per_row), dk(nt % per_row * v) {}
};

// A rows x cols tile of ES-byte elements at src (row stride ld elements)
// into shared dst (row stride dld elements), zeros in rows from rows_ok
// and columns from cols_ok on, in 16-byte chunks (the thread's own, `at`):
// cp.async where vec (the rows 16-byte aligned and cols_ok a multiple of
// a chunk), else plain 2- or 1-byte loads.  cols is a multiple of 16 / ES.
template <int ES>
__device__ __forceinline__ void load_tile(char* dst, int dld, const void* src, long long ld,
                                          int rows, int cols, int rows_ok, int cols_ok,
                                          bool vec, const Chunks& at) {
  constexpr int V = 16 / ES;
  for (int r = at.r, k = at.k; r < rows;) {
    char* d = dst + ((size_t)r * dld + k) * ES;
    const char* s = static_cast<const char*>(src) + ((size_t)r * ld + k) * ES;
    if (vec) {
      const bool ok = r < rows_ok && k < cols_ok;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (r < rows_ok) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (k + i < cols_ok) {
            const uint32_t e = ES == 2 ? reinterpret_cast<const uint16_t*>(s)[i]
                                       : reinterpret_cast<const uint8_t*>(s)[i];
            w[i * ES / 4] |= e << (8 * ((i * ES) % 4));
          }
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    r += at.dr;
    k += at.dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}

// Where either of the two offsets in ix's low bytes is j, the matching
// bf16 half of v replaces that half of acc.
__device__ __forceinline__ uint32_t pick2(uint32_t acc, uint32_t v, uint32_t ix, int j) {
  const uint32_t mask = ((ix & 0xffu) == (uint32_t)j ? 0x0000ffffu : 0u) |
                        (((ix >> 8) & 0xffu) == (uint32_t)j ? 0xffff0000u : 0u);
  return (acc & ~mask) | (v & mask);
}

// The dense bf16 (bk, BN) tile ws (row stride BN + 8) of a step's
// compressed values vs and offsets is (bk n/m rows of BN): a thread takes
// a group's 4 adjacent columns and writes each of its m rows.  M is m
// where it is known at compile time (its rows then stay in registers while
// the n kept rows are read once), else 0; N likewise n.
template <int BN, int M, int N>
__device__ __forceinline__ void expand(__nv_bfloat16* ws, const __nv_bfloat16* vs,
                                       const uint8_t* is, int bk, int n, int m, int tid,
                                       int nt) {
  if constexpr (N > 0) n = N;
  constexpr int WLD = BN + 8, Q = BN / 4;
  for (int it = tid; it < bk / m * Q; it += nt) {
    const int g = it / Q, c = (it - g * Q) * 4;
    const __nv_bfloat16* vrow = vs + (size_t)g * n * BN + c;
    const uint8_t* irow = is + (size_t)g * n * BN + c;
    __nv_bfloat16* out = ws + (size_t)g * m * WLD + c;
    if constexpr (M > 0) {
      uint2 d[M];
#pragma unroll
      for (int j = 0; j < M; ++j) d[j] = make_uint2(0, 0);
#pragma unroll
      for (int r = 0; r < n; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(vrow + r * BN);
        const uint32_t ix = *reinterpret_cast<const uint32_t*>(irow + r * BN);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          d[j].x = pick2(d[j].x, v.x, ix, j);
          d[j].y = pick2(d[j].y, v.y, ix >> 16, j);
        }
      }
#pragma unroll
      for (int j = 0; j < M; ++j) *reinterpret_cast<uint2*>(out + j * WLD) = d[j];
    } else {
      for (int j = 0; j < m; ++j) {
        uint2 d = make_uint2(0, 0);
        for (int r = 0; r < n; ++r) {
          const uint2 v = *reinterpret_cast<const uint2*>(vrow + r * BN);
          const uint32_t ix = *reinterpret_cast<const uint32_t*>(irow + r * BN);
          d.x = pick2(d.x, v.x, ix, j);
          d.y = pick2(d.y, v.y, ix >> 16, j);
        }
        *reinterpret_cast<uint2*>(out + j * WLD) = d;
      }
    }
  }
}

// Bytes of shared memory nm_spmm_tc takes: two stages of (x tile, values,
// offsets), then the dense tile (kernels/nm_spmm.py: prefill_smem_bytes
// counts the same).
__host__ __device__ constexpr size_t tc_stage_bytes(int bm, int bn, int bk, int rc) {
  return (size_t)bm * (bk + 8) * 2 + (size_t)rc * bn * 3;
}
__host__ __device__ constexpr size_t tc_smem_bytes(int bm, int bn, int bk, int rc) {
  return 2 * tc_stage_bytes(bm, bn, bk, rc) + (size_t)bk * (bn + 8) * 2;
}

// acc += x tile (rows of the warp, bk columns, row stride xld) @ dense
// tile (bk rows, the warp's columns, row stride BN + 8), a warp's MT x
// NTL fragments: every 32 columns of K, two k16 MMAs chained from 0, then
// one f32 add into acc.  (Chaining all of K in the tensor core put
// outputs beyond one bf16 step of the plain version at DeepSeek's and
// RecurrentGemma's widths; this order, none.)
template <int BN, int MT, int NTL>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NTL][4], const __nv_bfloat16* xw,
                                         int xld, const __nv_bfloat16* ww, int bk) {
  constexpr int WLD = BN + 8;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < bk; k += TC_KCHUNK) {
    uint32_t bf[NTL][4];  // per 8 columns: k16 step 0's (b0, b1), then step 1's
#pragma unroll
    for (int j = 0; j < NTL / 2; ++j) {
      ldsm_x4_t(bf[2 * j][0], bf[2 * j][1], bf[2 * j + 1][0], bf[2 * j + 1][1],
                ww + (size_t)k * WLD + j * 16);
      ldsm_x4_t(bf[2 * j][2], bf[2 * j][3], bf[2 * j + 1][2], bf[2 * j + 1][3],
                ww + (size_t)(k + 16) * WLD + j * 16);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, xw + (size_t)i * 16 * xld + k);
      ldsm_x4(a1, xw + (size_t)i * 16 * xld + k + 16);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        float t[4];
        mma_bf16(t, a0, bf[j][0], bf[j][1], zero);
        mma_bf16(t, a1, bf[j][2], bf[j][3], t);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += t[q];
      }
    }
  }
}

// blockDim = 32 * WM * WN: warp (wm, wn) owns rows wm * BM / WM and columns
// wn * BN / WN of the block's BM x BN tile; grid = (ceil(o_true / BN),
// ceil(B / BM), E).  xvec / wvec: x's rows / the weight's rows (values
// and offsets) take 16-byte copies.  A two-stage ring: step kt + 1's
// copies fly while step kt is expanded, then multiplied.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) nm_spmm_tc(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ vals,
    const uint8_t* __restrict__ idx, __nv_bfloat16* __restrict__ y,
    int B, int K, int O, int o_true, int n, int m, int bk, int xvec, int wvec, Strides st) {
  constexpr int NT = 32 * WM * WN, TM = BM / WM, TN = BN / WN, MT = TM / 16, NTL = TN / 8;
  constexpr int WLD = BN + 8;
  static_assert(TM % 16 == 0 && NTL % 2 == 0, "a warp takes 16-row, 16-column units");
  extern __shared__ uint4 tc_smem[];
  x += blockIdx.z * st.x;
  vals += blockIdx.z * st.w;
  idx += blockIdx.z * st.w;
  y += blockIdx.z * st.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int b0 = blockIdx.y * BM, o0 = blockIdx.x * BN;
  const int xld = bk + 8;      // the x tile's padded row stride
  const int rc = bk / m * n;   // compressed rows of a step
  const int kc = K / m * n;    // compressed rows of the weight
  const size_t stage = tc_stage_bytes(BM, BN, bk, rc);
  char* base = reinterpret_cast<char*>(tc_smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(base + 2 * stage);
  const int steps = (K + bk - 1) / bk;
  const Chunks xat(tid, NT, bk / 8, 8), vat(tid, NT, BN / 8, 8), iat(tid, NT, BN / 16, 16);

  auto load = [&](int kt) {
    char* sb = base + (kt & 1) * stage;
    const int k0 = kt * bk, r0 = kt * rc;
    load_tile<2>(sb, xld, x + (size_t)b0 * K + k0, K, BM, bk, B - b0, K - k0, xvec, xat);
    sb += (size_t)BM * xld * 2;
    load_tile<2>(sb, BN, vals + (size_t)r0 * O + o0, O, rc, BN, kc - r0, O - o0, wvec, vat);
    sb += (size_t)rc * BN * 2;
    load_tile<1>(sb, BN, idx + (size_t)r0 * O + o0, O, rc, BN, kc - r0, O - o0, wvec, iat);
    cp_async_commit();
  };
  // lanes 0-15 address rows 0-15 of a 16-row unit, lanes 16-31 the same
  // rows 8 columns on: ldmatrix's four 8 x 8 matrices in fragment order
  const int xoff = (wm * TM + (lane & 15)) * xld + (lane >> 4) * 8;
  const int woff = (lane & 15) * WLD + wn * TN + (lane >> 4) * 8;

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }
  load(0);
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait_all();  // step kt's stage has landed
    __syncthreads();     // ... for every thread; step kt - 1 is read
    if (kt + 1 < steps) load(kt + 1);
    const char* sb = base + (kt & 1) * stage;
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(sb + (size_t)BM * xld * 2);
    const uint8_t* is = reinterpret_cast<const uint8_t*>(sb + (size_t)BM * xld * 2 +
                                                         (size_t)rc * BN * 2);
    if (m == 4 && n == 2) {
      expand<BN, 4, 2>(ws, vs, is, bk, n, m, tid, NT);
    } else if (m == 4) {
      expand<BN, 4, 0>(ws, vs, is, bk, n, m, tid, NT);
    } else {
      expand<BN, 0, 0>(ws, vs, is, bk, n, m, tid, NT);
    }
    __syncthreads();
    mma_tile<BN, MT, NTL>(acc, reinterpret_cast<const __nv_bfloat16*>(sb) + xoff, xld,
                          ws + woff, bk);
  }
  // fragment (i, j): rows +lane/4 and +lane/4 + 8, columns +2 (lane % 4) and +1
  const bool pairs = (o_true & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int col = o0 + wn * TN + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = b0 + wm * TM + i * 16 + (lane >> 2) + 8 * h;
        if (row >= B || col >= o_true) continue;
        __nv_bfloat16* dst = y + (size_t)row * o_true + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = __float2bfloat16(acc[i][j][2 * h]);
          if (col + 1 < o_true) dst[1] = __float2bfloat16(acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN>
int launch_tc_tile(const __nv_bfloat16* x, const __nv_bfloat16* vals, const uint8_t* idx,
                   __nv_bfloat16* y, int E, int B, int K, int O, int o_true, int n, int m,
                   int bk, cudaStream_t s) {
  const size_t smem = tc_smem_bytes(BM, BN, bk, bk / m * n);
  if (smem > TC_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nm_spmm_tc<BM, BN, WM, WN>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wvec = O % 16 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const Strides st{(long long)B * K, (long long)K * n / m * O, (long long)B * o_true};
  const dim3 grid((o_true + BN - 1) / BN, (B + BM - 1) / BM, E);
  kernel<<<grid, 32 * WM * WN, smem, s>>>(x, vals, idx, y, B, K, O, o_true, n, m, bk, xvec,
                                          wvec, st);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's plan: tile (bm, bn) and step bk.  The tiles
// (kernels/nm_spmm.py: TC_SMALL, TC_EXPERTS): 64 x 64 over 8 warps of
// 32 x 16, 32 x 128 over 4 warps of 32 x 32.
int launch_tc(const __nv_bfloat16* x, const __nv_bfloat16* vals, const uint8_t* idx,
              __nv_bfloat16* y, int E, int B, int K, int O, int o_true, int n, int m, int bm,
              int bn, int bk, cudaStream_t s) {
  if (bk <= 0 || bk % TC_KCHUNK || bk % m || bk > 256 || B > 65535 * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define TC_ARGS x, vals, idx, y, E, B, K, O, o_true, n, m, bk, s
  if (bm == 64 && bn == 64) return launch_tc_tile<64, 64, 2, 4>(TC_ARGS);
  if (bm == 32 && bn == 128) return launch_tc_tile<32, 128, 1, 4>(TC_ARGS);
#undef TC_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_type(const void* x, const void* vals, const void* idx, void* y, int E, int B,
                int K, int O, int o_true, int n, int m, int cols, int bm, int bn, int bk,
                cudaStream_t s) {
#define NM_ARGS static_cast<const T*>(x), static_cast<const T*>(vals), \
    static_cast<const uint8_t*>(idx), static_cast<T*>(y), E, B, K, O, o_true, n, m, s
  if (cols == 0 && bm == 0) return launch_prefill<T>(NM_ARGS);
  if (cols == 0) {
    if constexpr (sizeof(T) == 2) {
      return launch_tc(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(vals), static_cast<const uint8_t*>(idx),
                       static_cast<__nv_bfloat16*>(y), E, B, K, O, o_true, n, m, bm, bn, bk, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);  // the tensor-core body takes bf16
  }
  if (B > 8 || (cols != 1 && cols != 4) || O % cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 4) return cols == 1 ? launch_decode<T, 4, 1>(NM_ARGS) : launch_decode<T, 4, 4>(NM_ARGS);
  return cols == 1 ? launch_decode<T, 8, 1>(NM_ARGS) : launch_decode<T, 8, 4>(NM_ARGS);
#undef NM_ARGS
}

int launch_any(const void* x, const void* vals, const void* idx, void* y, int E, int B,
               int K, int O, int o_true, int n, int m, int cols, int bm, int bn, int bk,
               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_type<float>(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, bm, bn, bk, s)
             : launch_type<__nv_bfloat16>(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, bm,
                                          bn, bk, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  cols and (bm, bn, bk) are the
// wrapper's plan (kernels/nm_spmm.py): cols 1 or 4 runs the decode kernel
// with that many columns a lane (B <= 8, O % cols == 0, values and indices
// aligned to cols of their elements, x's staged K * 4 to 16 bytes within
// the block's shared memory); cols 0 runs the tensor-core body with the
// tile (bm, bn) and step bk of prefill_plan (bf16 only), or with bm == 0
// the first version's body.  Returns the first nonzero CUDA error
// of the shared-memory opt-in and the launch, else 0.  The wrapper also
// checks shapes, types and contiguity, including 1 <= n <= m <= 256 and
// K % m == 0.
extern "C" int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                              void* y, int B, int K, int O, int o_true, int n,
                              int m, int cols, int bm, int bn, int bk, int dtype,
                              void* stream) {
  return launch_any(x, vals, idx, y, 1, B, K, O, o_true, n, m, cols, bm, bn, bk, dtype, stream);
}

// E stacked products: x (E, B, K), values/indices (E, K*n/m, O), y (E, B,
// o_true), each contiguous.  E <= 65535 (the grid's z extent).
extern "C" int nm_spmm_batched_launch(const void* x, const void* vals,
                                      const void* idx, void* y, int E, int B,
                                      int K, int O, int o_true, int n, int m,
                                      int cols, int bm, int bn, int bk, int dtype,
                                      void* stream) {
  return launch_any(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, bm, bn, bk, dtype, stream);
}
