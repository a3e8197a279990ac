// Token-wise multi-head attention with online softmax (FlashAttention style).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py: flash_mha_pallas (body
// _flash_kernel).  q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D); optional additive
// bias (Bb,Hq,Sq,Skv) in f32 or bf16, broadcast by block (bias row
// b / (B/Bb): the B*N rows of triangular attention share one (B,H,N,N)
// bias that is never repeated in memory); GQA (head h reads kv head
// h / (Hq/Hkv)); causal, sliding window and kv_valid_len masks.  Masked
// logits are set to NEG = -1e30 and their probabilities to exactly 0, the
// running (m, l, o) state is float32, a fully masked row returns 0, and the
// output is o / max(l, 1e-30) in q's type.
//
// The TPU kernel walks the KV blocks as a sequential grid axis and carries
// (m, l, o) in revisited output blocks.  CUDA blocks run in no order, so
// here one block owns one (batch row, head, 64-query tile) and loops over
// the 64-key tiles itself; the state lives in registers.  Each of the 8
// warps owns 8 query rows; a lane computes 2 of a row's 64 logits per tile
// and owns the output columns lane + 32*j.
//
// Bound on the H100: bytes.  At the main-path triangular-attention shape
// (B*N = 256 rows, N = 256, 4 heads, D = 32) a call is
// 4*B*N*H*N*N*D = 8.6 GFLOP against ~67 MB of q, k, v, o and bias, about
// 128 operations a byte, below the card's bf16 balance point.  Reading
// q, k, v and the bias through their strides keeps the split qkv
// projection and the transposed bf16 bias from being copied, and the
// shared bias is read from L2 by all N rows of a protein.  This first
// version does the two products on the CUDA cores in float32 out of
// shared memory (Q, K, V, P tiles), so it is bound by those cores, far
// from the byte bound; tensor cores (mma/wgmma on bf16) and TMA
// pipelining are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64, BK = 64, NWARPS = 8, ROWS = BQ / NWARPS;

struct Params {
  const void* q; const void* k; const void* v; const void* bias; const int32_t* kvlen;
  void* o;
  int bias_kind;                   // 0 none, 1 f32, 2 bf16
  int B, Sq, Skv, Hq, Hkv, Bb;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int64_t bsb, bsh, bsq, bsk;
  int causal, window;              // window < 0: no sliding window
  float scale;
};

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

template <int D> constexpr int smem_floats() { return BQ * D + BK * (D + 1) + BK * D + BQ * BK; }

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_kernel(const Params p) {
  constexpr int DPL = (D + 31) / 32;           // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                            // [BQ][D]
  float* ks = qs + BQ * D;                     // [BK][D+1]
  float* vs = ks + BK * (D + 1);               // [BK][D]
  float* ps = vs + BK * D;                     // [BQ][BK]

  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;
  const int h = bh % p.Hq, b = bh / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int bb = b / (p.B / p.Bb);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  const int kvl = p.kvlen ? p.kvlen[b] : p.Skv;

  for (int e = threadIdx.x; e < BQ * D; e += NWARPS * 32) {
    const int r = e / D, dd = e % D, qpos = q0 + r;
    qs[e] = qpos < p.Sq ? to_f32(qg[qpos * p.qss + dd]) : 0.f;
  }

  float m[ROWS], l[ROWS], o[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.Skv; kv0 += BK) {
    __syncthreads();                           // previous tile fully consumed
    for (int e = threadIdx.x; e < BK * D; e += NWARPS * 32) {
      const int j = e / D, dd = e % D, kpos = kv0 + j;
      const bool in = kpos < p.Skv;
      ks[j * (D + 1) + dd] = in ? to_f32(kg[kpos * p.kss + dd]) : 0.f;
      vs[e] = in ? to_f32(vg[kpos * p.vss + dd]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float k0 = ks[lane * (D + 1) + dd], k1 = ks[(lane + 32) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = qs[(warp * ROWS + i) * D + dd];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i, qpos = q0 + r;
      float val[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kv0 + lane + 32 * c;
        bool good = kpos < p.Skv && qpos < p.Sq && kpos < kvl;
        if (p.causal) good = good && kpos <= qpos;
        if (p.window >= 0) good = good && kpos > qpos - p.window;
        float x = s[i][c] * p.scale;
        if (p.bias_kind && kpos < p.Skv && qpos < p.Sq) {
          const int64_t off = bb * p.bsb + h * p.bsh + qpos * p.bsq + kpos * p.bsk;
          x += p.bias_kind == 1 ? static_cast<const float*>(p.bias)[off]
                                : __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off]);
        }
        ok[c] = good;
        val[c] = good ? x : NEG;
      }
      float mt = fmaxf(val[0], val[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float p0 = ok[0] ? expf(val[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(val[1] - m_new) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[i][j] *= alpha;
      ps[r * BK + lane] = p0;
      ps[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) {
        const int dd = lane + 32 * jj;
        if (dd < D) {
          const float vv = vs[j * D + dd];
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            o[i][jj] = fmaf(ps[(warp * ROWS + i) * BK + j], vv, o[i][jj]);
        }
      }
    }
    __syncwarp();
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + warp * ROWS + i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) {
      const int dd = lane + 32 * jj;
      if (dd < D)
        og[(((int64_t)b * p.Sq + qpos) * p.Hq + h) * D + dd] = from_f32<T>(o[i][jj] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Sq + BQ - 1) / BQ) * p.Hq * p.B;
  flash_kernel<T, D><<<dim3((unsigned)blocks), dim3(NWARPS * 32), bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 8: return launch_d<T, 8>(p, s);
    case 16: return launch_d<T, 16>(p, s);
    case 32: return launch_d<T, 32>(p, s);
    case 64: return launch_d<T, 64>(p, s);
    case 128: return launch_d<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements; the head dim of q, k, v has unit stride and o is
// a contiguous (B, Sq, Hq, D) tensor of q's type.  kvlen is null or (B,)
// int32.  Returns cudaGetLastError() after the launch.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v, const void* bias,
                                const void* kvlen, void* o, int qkv_is_bf16, int bias_kind,
                                int B, int Sq, int Skv, int Hq, int Hkv, int D, int Bb,
                                int qsb, int qss, int qsh, int ksb, int kss, int ksh,
                                int vsb, int vss, int vsh, int bsb, int bsh, int bsq, int bsk,
                                int causal, int window, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  Params p{q, k, v, bias, static_cast<const int32_t*>(kvlen), o, bias_kind,
           B, Sq, Skv, Hq, Hkv, Bb, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           bsb, bsh, bsq, bsk, causal, window, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(qkv_is_bf16 ? launch_typed<__nv_bfloat16>(p, D, s) : launch_typed<float>(p, D, s));
}
