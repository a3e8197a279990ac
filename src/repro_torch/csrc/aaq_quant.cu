// AAQ runtime quantization, token-wise: one warp per token.
//
// Replaces the Pallas TPU kernel repro/kernels/aaq_quant/aaq_quant.py:
// aaq_quantize_pallas (body _quant_kernel).  Semantics, bitwise with the
// plain version (repro_torch/kernels/aaq_quant/ref.py):
//   top-k of |x| (k <= 4), ties to the lower index, in descending order;
//   outlier slots zeroed before the max; sigma = max(max|inlier| / qmax,
//   1e-12) with IEEE division; q = clip(rint(inl / sigma), +-qmax) (rint is
//   round-half-even, as jnp.round); 4-bit values nibble-packed, low nibble
//   = even column; ovals rounded to bf16 (round to nearest even).
//
// Bound on the H100: bytes.  At the main-path shape (T = 65536 tokens,
// H = 128, bf16 in) it reads 2 B and writes ~0.6 B per value; the top-k
// rounds are k warp-shuffle argmax reductions over registers.  Design: a
// lane owns adjacent pairs of columns (2 loads per pair, and the two
// nibbles of one output byte come from the same lane, so packing needs no
// shuffle); the row stays in registers from load to store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kWarps = 8;   // tokens per block

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (a, idx) beats (b, jdx): larger magnitude, ties to the lower index.
__device__ __forceinline__ bool better(float a, int i, float b, int j) {
  return a > b || (a == b && i < j);
}

// NP = pairs of columns per lane: lane l owns columns 2*(l + 32*p) + {0,1}.
template <typename T, int NP>
__global__ void aaq_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                 float* __restrict__ scale,
                                 __nv_bfloat16* __restrict__ ovals,
                                 int32_t* __restrict__ oidx,
                                 int n_tokens, int h, int bits, int k) {
  const int lane = threadIdx.x & 31;
  const int token = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (token >= n_tokens) return;            // whole warp leaves together
  const T* row = x + (int64_t)token * h;
  const int kk = k > 0 ? k : 1;

  float v[NP][2];
  float a[NP][2];                           // |v|; -1 once taken or absent
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 2 * (lane + 32 * p) + c;
      const bool in = col < h;
      v[p][c] = in ? to_f32(row[col]) : 0.f;
      a[p][c] = in ? fabsf(v[p][c]) : -1.f;
    }
  }

  for (int r = 0; r < k; ++r) {
    float ba = -1.f, bv = 0.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 2 * (lane + 32 * p) + c;
        if (better(a[p][c], col, ba, bi)) { ba = a[p][c]; bi = col; bv = v[p][c]; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_xor_sync(0xffffffffu, ba, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      if (better(oa, oi, ba, bi)) { ba = oa; bi = oi; bv = ov; }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (2 * (lane + 32 * p) + c == bi) { a[p][c] = -1.f; v[p][c] = 0.f; }
      }
    }
    if (lane == 0) {
      ovals[(int64_t)token * kk + r] = __float2bfloat16_rn(bv);
      oidx[(int64_t)token * kk + r] = bi;
    }
  }
  if (k == 0 && lane == 0) {                 // (T, 1) zero dummies
    ovals[token] = __float2bfloat16_rn(0.f);
    oidx[token] = 0;
  }

  float m = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) m = fmaxf(m, fmaxf(fabsf(v[p][0]), fabsf(v[p][1])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float qm = (float)((1 << (bits - 1)) - 1);
  const float sigma = fmaxf(m / qm, kEps);   // IEEE division (no fast-math)
  if (lane == 0) scale[token] = sigma;

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int pair = lane + 32 * p;
    if (2 * pair >= h) continue;
    int qi[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
      qi[c] = (int)fminf(fmaxf(rintf(v[p][c] / sigma), -qm), qm);
    if (bits == 4) {
      q[(int64_t)token * (h / 2) + pair] = (int8_t)((qi[0] & 0x0F) | ((qi[1] & 0x0F) << 4));
    } else {
      int8_t* out = q + (int64_t)token * h + 2 * pair;
      out[0] = (int8_t)qi[0];
      if (2 * pair + 1 < h) out[1] = (int8_t)qi[1];
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, void* q, float* scale, void* ovals, int32_t* oidx,
                         int n_tokens, int h, int bits, int k, cudaStream_t stream) {
  const dim3 grid((n_tokens + kWarps - 1) / kWarps), block(32 * kWarps);
  const int np = (h + 63) / 64;
  auto* xp = static_cast<const T*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* op = static_cast<__nv_bfloat16*>(ovals);
  if (np <= 1)
    aaq_quant_kernel<T, 1><<<grid, block, 0, stream>>>(xp, qp, scale, op, oidx, n_tokens, h, bits, k);
  else if (np <= 2)
    aaq_quant_kernel<T, 2><<<grid, block, 0, stream>>>(xp, qp, scale, op, oidx, n_tokens, h, bits, k);
  else if (np <= 4)
    aaq_quant_kernel<T, 4><<<grid, block, 0, stream>>>(xp, qp, scale, op, oidx, n_tokens, h, bits, k);
  else
    aaq_quant_kernel<T, 8><<<grid, block, 0, stream>>>(xp, qp, scale, op, oidx, n_tokens, h, bits, k);
  return cudaGetLastError();
}

}  // namespace

// x (T, H) bf16 or f32, contiguous; H <= 512, even when bits == 4; k <= 4.
// q (T, H/2 or H) int8; scale (T) f32; ovals (T, max(k,1)) bf16;
// oidx (T, max(k,1)) int32.  Returns cudaGetLastError() after the launch.
extern "C" int aaq_quantize_launch(const void* x, int x_is_bf16, void* q, void* scale,
                                   void* ovals, void* oidx, int n_tokens, int h,
                                   int bits, int k, void* stream) {
  if (n_tokens == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<float*>(scale);
  auto* ip = static_cast<int32_t*>(oidx);
  return x_is_bf16
      ? (int)launch_typed<__nv_bfloat16>(x, q, sp, ovals, ip, n_tokens, h, bits, k, s)
      : (int)launch_typed<float>(x, q, sp, ovals, ip, n_tokens, h, bits, k, s);
}
