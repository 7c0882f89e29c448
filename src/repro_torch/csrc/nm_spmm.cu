// Compressed N:M matmul y = x @ decompress(values, indices), for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/nm_spmm.py:_nm_spmm_kernel
// (launched by nm_spmm_pallas).  Layout: x (B, K) row-major; values and
// uint8 indices (K*n/m, O) row-major, where compressed row r belongs to
// group r / n and expands to dense row (r / n) * m + indices[r, o]; y is
// (B, o_true) with o_true <= O (the trailing O - o_true alignment columns
// of a padded artifact are never read or written).  f32 accumulation,
// output in x's type (bf16 or f32; values share it).
//
// The order of every sum.  An output (b, o) is the fold, in the order w =
// 0, 1, ..., 7 from 0, of eight chains: chain w is the fma, in order, of
// the kept rows of the groups whose place in their chunk of 256 / m groups
// is w, w + 8, ... (chunk by chunk, each group's n rows in turn).  Both
// kernels below sum in exactly this order, whatever B is, so a row of x
// gives the same bytes in decode and in prefill, alone or beside others,
// call after call; and they give the bytes the first version of this
// kernel gave.  No split of a chain across blocks can keep that.
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
// wrapper (kernels/nm_spmm.py:decode_cols) picks C from the shapes.
// Where x does not fit the staging budget, and in prefill (B > 8), the
// first version's body runs: the same eight warps over 32 columns and 32
// rows of x, x staged in chunks of 256 dense columns; it re-reads the
// weight once per 32-row tile, with no tensor cores (mma.sp / wgmma) yet.
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

// ---- prefill (B > 8), and decode where x does not fit: the first version ----

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

template <typename T>
int launch_type(const void* x, const void* vals, const void* idx, void* y, int E, int B,
                int K, int O, int o_true, int n, int m, int cols, cudaStream_t s) {
#define NM_ARGS static_cast<const T*>(x), static_cast<const T*>(vals), \
    static_cast<const uint8_t*>(idx), static_cast<T*>(y), E, B, K, O, o_true, n, m, s
  if (cols == 0) return launch_prefill<T>(NM_ARGS);
  if (B > 8 || (cols != 1 && cols != 4) || O % cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 4) return cols == 1 ? launch_decode<T, 4, 1>(NM_ARGS) : launch_decode<T, 4, 4>(NM_ARGS);
  return cols == 1 ? launch_decode<T, 8, 1>(NM_ARGS) : launch_decode<T, 8, 4>(NM_ARGS);
#undef NM_ARGS
}

int launch_any(const void* x, const void* vals, const void* idx, void* y, int E, int B,
               int K, int O, int o_true, int n, int m, int cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_type<float>(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, s)
             : launch_type<__nv_bfloat16>(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  cols is the wrapper's plan
// (kernels/nm_spmm.py:decode_cols): 0 runs the first version's body, 1 or
// 4 the decode kernel with that many columns a lane (B <= 8, O % cols ==
// 0, values and indices aligned to cols of their elements, x's staged K *
// 4 to 16 bytes within the block's shared memory).  Returns the first
// nonzero CUDA error of the shared-memory opt-in and the launch, else 0.
// The wrapper also checks shapes, types and contiguity, including 1 <= n
// <= m <= 256 and K % m == 0.
extern "C" int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                              void* y, int B, int K, int O, int o_true, int n,
                              int m, int cols, int dtype, void* stream) {
  return launch_any(x, vals, idx, y, 1, B, K, O, o_true, n, m, cols, dtype, stream);
}

// E stacked products: x (E, B, K), values/indices (E, K*n/m, O), y (E, B,
// o_true), each contiguous.  E <= 65535 (the grid's z extent).
extern "C" int nm_spmm_batched_launch(const void* x, const void* vals,
                                      const void* idx, void* y, int E, int B,
                                      int K, int O, int o_true, int n, int m,
                                      int cols, int dtype, void* stream) {
  return launch_any(x, vals, idx, y, E, B, K, O, o_true, n, m, cols, dtype, stream);
}
