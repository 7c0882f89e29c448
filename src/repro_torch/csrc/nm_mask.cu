// N:M mask of |w| and its application, (masked = Pi (.) w, mask = Pi), for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/nm_mask.py:_nm_mask_kernel
// (launched by nm_mask_apply_pallas).  Layout: w is a contiguous
// (S, R, C) stack of S row-major (R, C) slices (a stacked (L, in, out)
// weight, or one 2-D weight with S = 1); groups of m consecutive rows run
// down R, the matmul reduction axis.  In each (slice, group, column) the
// n largest |w| are kept, ties to the lowest row, as jax.lax.top_k and the
// Pallas kernel's iterative argmax break them.  Outputs are in w's type
// (bf16 or f32): mask is 1/0, masked is w where kept and +0.0 elsewhere
// (a select, as the Pallas kernel writes it, not the -0.0 of mask * w).
//
// What bounds it: device memory.  It reads w once and writes two tensors
// of w's size, with about m comparisons per element, so at gpt2-paper's
// 84.9 M maskable elements a bf16 pass moves 509.6 MB (0.152 ms at
// 3.35 TB/s) and the arithmetic is far below the compute roofline.
// The design reads and writes each byte once: one thread per
// (slice, group, column) loads its m values at stride C, so the 32 lanes
// of a warp touch 32 neighbouring columns and every load and store
// coalesces; the m values stay in registers, each element's in-group rank
// (the count of larger values, plus equal ones at a lower row) is computed
// exactly in f32, and the element is kept when its rank is below n.  That
// is O(m^2) comparisons per group, nothing for the m <= 32 this takes.
// For m in {2, 4, 8, 16, 32} the loops unroll on a compile-time m; other m
// take the same code with a runtime bound.  Known costs of this first
// version: 2-byte scalar accesses in bf16 (no vector loads), and one group
// per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_M = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// M > 0: the group size as a compile-time constant; M == 0: m_rt at run
// time (m_rt <= MAX_M).  One thread per (slice, group, column); `total` is
// S * (R / m) * C.
template <typename T, int M>
__global__ void __launch_bounds__(THREADS) nm_mask_kernel(
    const T* __restrict__ w, T* __restrict__ masked, T* __restrict__ mask,
    long long total, int C, int n, int m_rt) {
  constexpr int CAP = M > 0 ? M : MAX_M;
  const int m = M > 0 ? M : m_rt;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long col = t % C;
  const long long sg = t / C;  // slice * (R / m) + group
  // element (slice s, row g*m + i, col) lies at ((s*(R/m) + g)*m + i)*C + col
  const long long base = sg * m * C + col;

  T v[CAP];
  float a[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    if (i < m) {
      v[i] = w[base + (long long)i * C];
      a[i] = fabsf(to_f(v[i]));
    }
  }
  const T one = from_f<T>(1.f), zero = from_f<T>(0.f);
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    if (i >= m) break;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (j >= m) break;
      rank += (a[j] > a[i] || (a[j] == a[i] && j < i)) ? 1 : 0;
    }
    const bool keep = rank < n;
    const long long off = base + (long long)i * C;
    mask[off] = keep ? one : zero;
    masked[off] = keep ? v[i] : zero;
  }
}

template <typename T>
void launch(const void* w, void* masked, void* mask, long long total, int C, int n,
            int m, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(masked);
  T* mp = static_cast<T*>(mask);
  switch (m) {
    case 2: nm_mask_kernel<T, 2><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
    case 4: nm_mask_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
    case 8: nm_mask_kernel<T, 8><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
    case 16: nm_mask_kernel<T, 16><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
    case 32: nm_mask_kernel<T, 32><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
    default: nm_mask_kernel<T, 0><<<blocks, THREADS, 0, stream>>>(wp, op, mp, total, C, n, m); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `slices` * R * C elements, R % m == 0.
// Returns cudaGetLastError() after the launch.  The wrapper
// (kernels/nm_mask.py) checks shapes, types and contiguity, including
// 1 <= n < m <= 32 (n == m never reaches the kernel).
extern "C" int nm_mask_launch(const void* w, void* masked, void* mask, long long slices,
                              int R, int C, int n, int m, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = slices * (long long)(R / m) * C;
  if (dtype == 0) launch<float>(w, masked, mask, total, C, n, m, s);
  else launch<__nv_bfloat16>(w, masked, mask, total, C, n, m, s);
  return static_cast<int>(cudaGetLastError());
}
