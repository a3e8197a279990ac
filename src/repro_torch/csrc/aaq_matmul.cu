// Dequantization-free AAQ matmul:
//   y[t, :] = sigma[t] * (q[t, :] @ W) + sum_j ovals[t, j] * W[oidx[t, j], :]
//
// Replaces the Pallas TPU kernel repro/kernels/aaq_matmul/aaq_matmul.py:
// aaq_matmul_pallas (body _qmm_kernel).  The int4/int8 inliers are widened
// to float32 (exact), multiplied against W widened to float32 and summed in
// float32; the per-token scale is applied once after the contraction, then
// the rank-k outlier term gathers k rows of W.  The output is rounded to
// W's type (bf16 or f32).
//
// Bound on the H100: bytes.  At the main-path shapes (T = 65536 tokens,
// H in {128, 512}, D in {4, 128, 384, 512}) a call is 2*T*H*D operations
// against ~T*(H/2 + 2*D) bytes: 90 to 240 operations a byte, below the
// card's bf16 balance point (~295), so the (T, D) output write dominates.
// This first version reads each q and W tile once per block and keeps the
// 64x64 accumulator in registers (4x4 outputs a thread), but runs the
// product on the CUDA cores in float32 (H staged through shared memory 32
// at a time), so it is far from that bound; bf16 tensor cores (widening
// |q| <= 127 to bf16 is exact) are later work.
// The ragged T and D edges are masked here; D = 4 is a real case.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 64, BD = 64, BH = 32, NTHREADS = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Signed value of column h of token row `row` (packed nibbles when bits == 4).
__device__ __forceinline__ int inlier(const int8_t* row, int h, int bits) {
  if (bits == 8) return row[h];
  const int8_t b = row[h >> 1];
  return (h & 1) ? (b >> 4) : ((int8_t)(b << 4) >> 4);
}

template <typename T>
__global__ void aaq_matmul_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                                  const __nv_bfloat16* __restrict__ ovals,
                                  const int32_t* __restrict__ oidx,
                                  const T* __restrict__ w, T* __restrict__ y,
                                  int n_tokens, int h, int d, int bits, int k, int kk) {
  __shared__ float qs[BT][BH + 1];
  __shared__ float ws[BH][BD];
  const int t0 = blockIdx.x * BT, d0 = blockIdx.y * BD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hp = bits == 4 ? (h + 1) / 2 : h;       // bytes per token row

  float acc[4][4] = {};
  for (int h0 = 0; h0 < h; h0 += BH) {
    for (int e = threadIdx.x; e < BT * BH; e += NTHREADS) {
      const int t = e / BH, hh = e % BH;
      const int tg = t0 + t, hg = h0 + hh;
      qs[t][hh] = (tg < n_tokens && hg < h)
                      ? (float)inlier(q + (int64_t)tg * hp, hg, bits) : 0.f;
    }
    for (int e = threadIdx.x; e < BH * BD; e += NTHREADS) {
      const int hh = e / BD, dd = e % BD;
      const int hg = h0 + hh, dg = d0 + dd;
      ws[hh][dd] = (hg < h && dg < d) ? to_f32(w[(int64_t)hg * d + dg]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int hh = 0; hh < BH; ++hh) {
      float wv[4], qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[hh][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[ty + 16 * i][hh];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_tokens) continue;
    const float s = scale[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dg = d0 + tx + 16 * j;
      if (dg >= d) continue;
      float o = 0.f;                         // rank-k outlier term
      for (int r = 0; r < k; ++r) {
        const int row = oidx[(int64_t)t * kk + r];
        o = fmaf(__bfloat162float(ovals[(int64_t)t * kk + r]),
                 to_f32(w[(int64_t)row * d + dg]), o);
      }
      y[(int64_t)t * d + dg] = from_f32<T>(acc[i][j] * s + o);
    }
  }
}

}  // namespace

// q (T, ceil(H/2) or H) int8; scale (T) f32; ovals, oidx (T, kk) bf16/int32
// with kk >= max(k, 1); w (H, D) and y (T, D) both bf16 (is_bf16) or f32,
// all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int aaq_matmul_launch(const void* q, const void* scale, const void* ovals,
                                 const void* oidx, const void* w, void* y, int is_bf16,
                                 int n_tokens, int h, int d, int bits, int k, int kk,
                                 void* stream) {
  if (n_tokens == 0 || d == 0) return 0;
  const dim3 grid((n_tokens + BT - 1) / BT, (d + BD - 1) / BD), block(NTHREADS);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const int8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<const __nv_bfloat16*>(ovals);
  auto* ip = static_cast<const int32_t*>(oidx);
  if (is_bf16)
    aaq_matmul_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        qp, sp, op, ip, static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), n_tokens, h, d, bits, k, kk);
  else
    aaq_matmul_kernel<float><<<grid, block, 0, s>>>(
        qp, sp, op, ip, static_cast<const float*>(w), static_cast<float*>(y),
        n_tokens, h, d, bits, k, kk);
  return (int)cudaGetLastError();
}
