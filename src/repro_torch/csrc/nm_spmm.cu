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
// What bounds it: in decode (B <= 8 rows) the weight stream.  A 2:4 bf16
// weight moves 3 bytes per kept element (2 of value, 1 of index), so the
// card's memory rate is the limit and the tensor cores have nothing to do.
// The design streams each weight byte once per row tile: a block owns 32
// output columns, one per lane of a warp, so neighbouring threads read
// neighbouring values[r, o] and indices[r, o] and every load coalesces.
// The block's KW = 8 warps split each K-chunk's groups between them (more
// loads in flight per column than one thread could keep), and their f32
// partial sums meet in shared memory at the end.  The block's BM rows of x
// are staged through shared memory in chunks of BK dense columns and
// expanded against each kept value in registers.  With B <= BM (decode)
// each weight byte is read exactly once.  In prefill (B > 8, BM = 32) the
// weight is re-read once per row tile; that, no tensor cores (mma.sp /
// wgmma) and no split of K across blocks are the known costs of this
// first version.
//
// nm_spmm_batched_launch is the same kernel over a stack of E independent
// products (the compressed MoE expert stacks, which the TPU reference
// vmaps over at src/repro/models/layers.py:66-74): blockIdx.z picks the
// expert and every operand advances by its own 64-bit per-expert stride,
// so one launch streams all E weights and 64 x (1024 x 1408) experts give
// 44 x 64 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BO = 32;   // output columns per block: one per lane of a warp
constexpr int KW = 8;    // warps per block, splitting each chunk's groups
constexpr int BK = 256;  // dense reduction columns of x staged per chunk

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

// blockDim = (BO, KW); grid = (column tiles, row tiles, experts)
template <typename T, int BM>
__global__ void __launch_bounds__(BO * KW) nm_spmm_kernel(
    const T* __restrict__ x, const T* __restrict__ vals,
    const uint8_t* __restrict__ idx, T* __restrict__ y,
    int B, int K, int O, int o_true, int n, int m, int bk, Strides st) {
  // x tile; after the K loop it holds the warps' partial sums (KW*BM*BO <= BM*BK)
  __shared__ float xs[BM * BK];
  x += blockIdx.z * st.x;
  vals += blockIdx.z * st.w;
  idx += blockIdx.z * st.w;
  y += blockIdx.z * st.y;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * BO + lane;
  const int o = blockIdx.x * BO + lane;
  const int b0 = blockIdx.y * BM;
  const bool col_ok = o < o_true;
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    const int kk = min(bk, K - k0);  // a multiple of m: K % m == 0, bk % m == 0
    __syncthreads();                 // previous chunk fully consumed
    for (int e = tid; e < BM * kk; e += BO * KW) {
      const int r = e / kk, c = e - r * kk;
      const int b = b0 + r;
      xs[r * BK + c] = b < B ? to_f(x[(size_t)b * K + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const int groups = kk / m;
      const size_t row0 = (size_t)(k0 / m) * n;  // first compressed row of the chunk
#pragma unroll 2
      for (int g = w; g < groups; g += KW) {
        for (int j = 0; j < n; ++j) {
          const size_t off = (row0 + (size_t)g * n + j) * O + o;
          const float v = to_f(vals[off]);
          const float* xc = xs + g * m + idx[off];
#pragma unroll
          for (int i = 0; i < BM; ++i) acc[i] = fmaf(xc[i * BK], v, acc[i]);
        }
      }
    }
  }
  __syncthreads();
  float* red = xs;  // (KW, BM, BO)
#pragma unroll
  for (int i = 0; i < BM; ++i) red[(w * BM + i) * BO + lane] = acc[i];
  __syncthreads();
  for (int e = tid; e < BM * BO; e += BO * KW) {
    const int i = e / BO, c = e - i * BO;
    const int b = b0 + i, oc = blockIdx.x * BO + c;
    if (b >= B || oc >= o_true) continue;
    float sum = 0.f;
    for (int ww = 0; ww < KW; ++ww) sum += red[(ww * BM + i) * BO + c];
    y[(size_t)b * o_true + oc] = from_f<T>(sum);
  }
}

template <typename T, int BM>
void launch(const void* x, const void* vals, const void* idx, void* y, int E,
            int B, int K, int O, int o_true, int n, int m, cudaStream_t stream) {
  static_assert(KW * BO <= BK, "partial sums must fit in the x tile");
  const dim3 grid((o_true + BO - 1) / BO, (B + BM - 1) / BM, E);
  const dim3 block(BO, KW);
  const int bk = (BK / m) * m;
  const Strides st{(long long)B * K, (long long)K * n / m * O, (long long)B * o_true};
  nm_spmm_kernel<T, BM><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const uint8_t*>(idx), static_cast<T*>(y), B, K, O, o_true,
      n, m, bk, st);
}

int launch_any(const void* x, const void* vals, const void* idx, void* y,
               int E, int B, int K, int O, int o_true, int n, int m, int dtype,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8) {
    if (dtype == 0) launch<float, 8>(x, vals, idx, y, E, B, K, O, o_true, n, m, s);
    else launch<__nv_bfloat16, 8>(x, vals, idx, y, E, B, K, O, o_true, n, m, s);
  } else {
    if (dtype == 0) launch<float, 32>(x, vals, idx, y, E, B, K, O, o_true, n, m, s);
    else launch<__nv_bfloat16, 32>(x, vals, idx, y, E, B, K, O, o_true, n, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch.  The wrapper (kernels/nm_spmm.py) checks shapes, types and
// contiguity, including 1 <= n <= m <= 256 and K % m == 0.
extern "C" int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                              void* y, int B, int K, int O, int o_true, int n,
                              int m, int dtype, void* stream) {
  return launch_any(x, vals, idx, y, 1, B, K, O, o_true, n, m, dtype, stream);
}

// E stacked products: x (E, B, K), values/indices (E, K*n/m, O), y (E, B,
// o_true), each contiguous.  E <= 65535 (the grid's z extent).
extern "C" int nm_spmm_batched_launch(const void* x, const void* vals,
                                      const void* idx, void* y, int E, int B,
                                      int K, int O, int o_true, int n, int m,
                                      int dtype, void* stream) {
  return launch_any(x, vals, idx, y, E, B, K, O, o_true, n, m, dtype, stream);
}
