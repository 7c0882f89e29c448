// Single-query paged decode attention, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py:_paged_attn_kernel
// (launched by paged_attn_pallas, emit_stats=False), in its append-only
// MHA/GQA form with fp pages.  Layout:
//   q        (B, Hkv, G, D)   queries grouped per KV head
//   k_pages  (P, ps, Hkv, D)  physical pool;  v_pages (P, ps, Hkv, Dv)
//   tables   (B, n_slots) int32 page ids, P = sentinel (unmapped)
//   lengths  (B,) int32 live tokens per lane
//   out      (B, Hkv, G, Dv) in q's type (bf16 or f32)
// Slot p of lane b covers logical positions [p*ps, (p+1)*ps); positions at
// or past lengths[b] are dead.  A lane with length 0 writes exact zeros.
//
// What bounds it: the bytes of the live K/V pages (decode does ~1 FMA per
// byte read, far below the tensor cores' break-even).  The design gives
// one block to each (lane, KV head) and walks the lane's table slots in
// order, so every live page is read once and all G query heads of the KV
// head share that read.  Slots that are sentinel, or lie at or past the
// lane's length, are skipped before any load is issued; only the live
// rows of the last page are loaded.  Each page's K and V go through
// shared memory (K rows padded by one float against bank conflicts), and
// a flash-style online softmax in f32 carries (max, denominator,
// accumulator) from page to page, with the finite -1e30 in place of -inf
// so dead positions never make NaNs.  One page per step and a block per
// (lane, head) leave much of the card idle at small batch; splitting the
// page walk across blocks (the stats form, K3) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    T* __restrict__ out, int Hkv, int G, int D, int Dv, int P, int ps,
    int n_slots, float scale) {
  extern __shared__ float smem[];
  const int KS = D + 1;             // padded K row stride
  float* qs = smem;                 // G*D
  float* ks = qs + G * D;           // ps*KS
  float* vs = ks + ps * KS;         // ps*Dv
  float* ss = vs + ps * Dv;         // G*ps  scores, then probabilities
  float* acc = ss + G * ps;         // G*Dv
  float* mrow = acc + G * Dv;       // G   running max
  float* lrow = mrow + G;           // G   running denominator
  float* corr = lrow + G;           // G   this page's rescale factor

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int length = lengths[b];
  const size_t head = (size_t)b * Hkv + h;

  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f(q[head * G * D + e]);
  for (int e = tid; e < G * Dv; e += THREADS) acc[e] = 0.f;
  for (int g = tid; g < G; g += THREADS) { mrow[g] = NEG; lrow[g] = 0.f; }
  __syncthreads();

  const int live_slots = length > 0 ? min(n_slots, (length + ps - 1) / ps) : 0;
  for (int p = 0; p < live_slots; ++p) {
    const int phys = tables[(size_t)b * n_slots + p];  // uniform across the block
    if (phys < 0 || phys >= P) continue;               // sentinel: nothing loaded
    const int nv = min(ps, length - p * ps);           // live rows of this page
    for (int e = tid; e < nv * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      ks[r * KS + d] = to_f(kp[(((size_t)phys * ps + r) * Hkv + h) * D + d]);
    }
    for (int e = tid; e < nv * Dv; e += THREADS) {
      const int r = e / Dv, d = e - r * Dv;
      vs[e] = to_f(vp[(((size_t)phys * ps + r) * Hkv + h) * Dv + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * nv; e += THREADS) {
      const int g = e / nv, r = e - g * nv;
      const float* qg = qs + g * D;
      const float* kr = ks + r * KS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
      ss[g * ps + r] = s * scale;
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
      for (int r = 0; r < nv; ++r) a = fmaf(pg[r], vs[r * Dv + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }
  for (int e = tid; e < G * Dv; e += THREADS) {
    out[head * G * Dv + e] = from_f<T>(acc[e] / fmaxf(lrow[e / Dv], 1e-30f));
  }
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper keeps it <= 48 KB).
extern "C" int paged_attn_smem_bytes(int G, int D, int Dv, int ps) {
  return (int)sizeof(float) *
         (G * D + ps * (D + 1) + ps * Dv + G * ps + G * Dv + 3 * G);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch.  The wrapper (kernels/paged_attn.py) checks shapes, types and
// contiguity.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* v,
                                 const void* tables, const void* lengths,
                                 void* out, int B, int Hkv, int G, int D,
                                 int Dv, int P, int ps, int n_slots,
                                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, Hkv);
  const int smem = paged_attn_smem_bytes(G, D, Dv, ps);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  if (dtype == 0) {
    paged_attn_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), t, l, static_cast<float*>(out), Hkv, G,
        D, Dv, P, ps, n_slots, scale);
  } else {
    paged_attn_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), t, l,
        static_cast<__nv_bfloat16*>(out), Hkv, G, D, Dv, P, ps, n_slots, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
