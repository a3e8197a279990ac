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
// output is o / max(l, 1e-30) in q's type.  Every offset is 64-bit: the
// strides come in as int64_t, so no length the model folds overflows them.
//
// The TPU kernel walks the KV blocks as a sequential grid axis and carries
// (m, l, o) in revisited output blocks.  CUDA blocks run in no order, so a
// block owns its query rows and loops over the 64-key tiles itself, with
// the state in registers.  Two variants, chosen by a fixed rule on the
// type and head dim:
//
// bf16 q/k/v, D in {16, 32, 64, 96, 128, 192, 256} (the main path): flash_tc_kernel,
//   FlashAttention-2 on the tensor cores.  Bound on the H100: bytes.  At
//   the triangular-attention shape (B*N = 256 rows, N = 256, 4 heads,
//   D = 32) a call is 4*B*N*H*N*N*D = 8.6 GFLOP against ~67 MB of q, k, v, o
//   and bias, about 128 operations a byte, below the card's bf16 balance
//   point (~295).  The design:
//   - A block owns one (batch row, 64 query rows, HB heads); each of its
//     4*HB warps owns 16 query rows of one head, whose Q fragments it loads
//     once with ldmatrix.  HB is all 4 heads at triangular attention, so
//     one block reads a (row, key-tile) of q, k and v as 256 contiguous
//     bytes per key straight out of the split qkv projection.
//   - K, V and the bias tile come through a two-stage cp.async ring in
//     16-byte chunks, the next tile's copy overlapping this tile's math.
//     Where the bias keeps a (q, k) pair's heads together and the block
//     holds all of them (the transposed bf16 (1, N, N, 4) bias of
//     triangular attention), a bias row of the tile is one contiguous run
//     read 16 bytes at a time, once for all heads; other layouts are read
//     element by element into the same tile.
//   - S = Q K^T with mma.sync m16n8k16 bf16 -> float32 (exact products).
//     Bias, scale and the masks (one predicate each) are applied to the
//     accumulator fragments; the online softmax state is float32.
//   - P V without a new rounding: P is split into P_hi + P_lo, both bf16,
//     and both go through the PV mma into one float32 accumulator, so P
//     keeps ~16 bits (rounding P once to bf16 would put up to 2^-9 on
//     every weight).  The kernel is bound by bytes, so the second mma costs
//     little.  V is bf16 and exact.
//   - Key tiles wholly past kv_valid_len, the causal edge or before the
//     window are skipped (their probabilities are exactly 0).
//   - The output is staged through shared memory and written 16 bytes a
//     thread.
//   - Head dims 96 to 256 (the LM zoo: phi-3-vision 96, DeepSeek's MLA 192,
//     RecurrentGemma 256) take one head a block (4 warps).  Above 128 the
//     O accumulator is D/2 floats a thread (128 at D = 256), so the key tile
//     halves to 32 and a warp reloads its Q fragments from shared memory
//     for each tile instead of holding them; the block then takes 99 KB of
//     shared memory at D = 256 (119 KB with an f32 bias), which the launch
//     opts into past the default 48 KB.
//
// float32 q/k/v or D = 8: flash_simt_kernel, both products on the CUDA
//   cores in float32 out of shared memory (one block per (row, head,
//   64-query tile), 8 warps of 8 query rows).  Not on the main path; it
//   keeps float32 inputs in float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; const void* bias; const int32_t* kvlen;
  void* o;
  int bias_kind;                   // 0 none, 1 f32, 2 bf16
  int B, Sq, Skv, Hq, Hkv, Bb;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int64_t bsb, bsh, bsq, bsk;
  int causal, window;              // window < 0: no sliding window
  float scale;
  int hb, packed_bias;             // tensor-core variant: heads a block, bias loader
};

// ---------------------------------------------------------------------------
// float32 SIMT variant
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64, BK = 64, NWARPS = 8, ROWS = BQ / NWARPS;

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
flash_simt_kernel(const Params p) {
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
int launch_d(const Params& p, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_simt_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return hopper::status(err, 2);
  const long long blocks = (long long)((p.Sq + BQ - 1) / BQ) * p.Hq * p.B;
  if (blocks >= (1ll << 31)) return hopper::status(cudaErrorInvalidValue, 3);
  flash_simt_kernel<T, D><<<dim3((unsigned)blocks), dim3(NWARPS * 32), bytes, stream>>>(p);
  return hopper::status(cudaGetLastError(), 4);
}

template <typename T>
int launch_typed(const Params& p, int d, cudaStream_t s) {
  switch (d) {
    case 8: return launch_d<T, 8>(p, s);
    case 16: return launch_d<T, 16>(p, s);
    case 32: return launch_d<T, 32>(p, s);
    case 64: return launch_d<T, 64>(p, s);
    case 128: return launch_d<T, 128>(p, s);
    default: return hopper::status(cudaErrorInvalidValue, 1);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------
namespace tc {

constexpr int RG = 4, BQ = 16 * RG;             // warps a head, query rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int max_threads() {
  return D <= 32 ? 512 : (D == 64 ? 256 : 128);
}
// Keys a tile.  At D > 128 the O accumulator alone is D/2 floats a thread,
// so the tile halves (the S fragment with it) to stay inside 255 registers.
template <int D> __host__ __device__ constexpr int kv_tile() { return D > 128 ? 32 : 64; }
// Up to D = 128 a warp keeps its Q fragments in registers for the whole
// loop; above, it reloads them from shared memory for each key tile.
template <int D> __host__ __device__ constexpr bool q_in_regs() { return D <= 128; }
template <int BK> __host__ __device__ constexpr int bias_bytes() {
  return BK == 1 ? 4 : (BK == 2 ? 2 : 0);
}

// Bytes of one bias tile: packed, the raw [BQ][BKV][hb] rows (16 bytes hold
// two keys of all hb heads); unpacked, float32 [hb][BQ][BKV + 8].
template <int BK, int BKV> __host__ __device__ int bias_tile_bytes(int hb, int packed) {
  if (BK == 0) return 0;
  return packed ? BQ * BKV * hb * bias_bytes<BK>() : hb * BQ * (BKV + 8) * 4;
}

template <int D, int BK> size_t smem_bytes(int hb, int packed) {
  constexpr int BKV = kv_tile<D>();
  const size_t tile = static_cast<size_t>(hb) * BKV * (D + 8) * 2;    // one K or V tile
  return static_cast<size_t>(hb) * BQ * (D + 8) * 2 +
         2 * (2 * tile + bias_tile_bytes<BK, BKV>(hb, packed));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pair of (x0, x1) and the bf16 pair of what that rounding left out
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = hopper::pack_bf16(x0, x1);
  lo = hopper::pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// 16-byte chunk `ch` of packed bias row `r`, swizzled so that the 8 lanes of
// a quarter warp reading one chunk each hit 8 different bank groups.
__device__ __forceinline__ int bias_chunk(int r, int ch) { return ch ^ ((r & 1) << 2); }

// Bias of keys (j, j + 1), j even, for head slot hs at tile row r.
template <int BK, int BKV>
__device__ __forceinline__ float2 bias_pair(const unsigned char* bs, int packed, int hb, int hs,
                                            int r, int j) {
  if (packed) {               // 16 bytes: keys j, j + 1 x all heads (hb * bias_bytes == 8)
    const uint4 v = *reinterpret_cast<const uint4*>(
        bs + (r * (BKV / 2) + bias_chunk(r, j >> 1)) * 16);
    if constexpr (BK == 1) {
      return hs ? make_float2(__uint_as_float(v.y), __uint_as_float(v.w))
                : make_float2(__uint_as_float(v.x), __uint_as_float(v.z));
    } else {
      const unsigned w0 = hs & 2 ? v.y : v.x, w1 = hs & 2 ? v.w : v.z;
      return hs & 1 ? make_float2(__uint_as_float(w0 & 0xffff0000u),
                                  __uint_as_float(w1 & 0xffff0000u))
                    : make_float2(__uint_as_float(w0 << 16), __uint_as_float(w1 << 16));
    }
  }
  return *reinterpret_cast<const float2*>(bs + ((hs * BQ + r) * (BKV + 8) + j) * 4);
}

template <int D, int BK>
__global__ void __launch_bounds__(max_threads<D>())
flash_tc_kernel(const Params p) {
  constexpr int DS = D + 8;                       // smem row stride: no bank conflicts
  constexpr int CPR = D / 8;                      // 16-byte chunks a (position, head) row
  constexpr int ES = bias_bytes<BK>();
  constexpr int BKV = kv_tile<D>(), BRS = BKV + 8, NT = BKV / 8;  // keys, bias row, n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int hb = p.hb, nthreads = 32 * RG * hb, packed = p.packed_bias;
  const int tile = hb * BKV * DS;                 // elements of one K or V tile
  const int stage_bytes = 4 * tile + bias_tile_bytes<BK, BKV>(hb, packed);
  bf16* qs = reinterpret_cast<bf16*>(smem);       // [hb][BQ][DS]
  unsigned char* stages = smem + hb * BQ * DS * 2;
  auto ks_of = [&](int st) { return reinterpret_cast<bf16*>(stages + st * stage_bytes); };
  auto vs_of = [&](int st) { return ks_of(st) + tile; };
  auto bs_of = [&](int st) { return stages + st * stage_bytes + 4 * tile; };

  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  const int nqt = (p.Sq + BQ - 1) / BQ, nhb = p.Hq / hb;
  int bx = blockIdx.x;
  const int q0 = (bx % nqt) * BQ;
  bx /= nqt;
  const int h0 = (bx % nhb) * hb, b = bx / nhb;
  const int bb = b / (p.B / p.Bb);
  const int group = p.Hq / p.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hs = warp / RG, rg = warp % RG;       // this warp's head slot and row group
  const int g = lane >> 2, c = lane & 3;

  int kv_end = p.Skv;
  if (p.kvlen) kv_end = min(kv_end, max(p.kvlen[b], 0));
  if (p.causal) kv_end = min(kv_end, min(p.Sq, q0 + BQ));
  const int kv_start = p.window >= 0 ? max(0, q0 - p.window + 1) / BKV * BKV : 0;

  for (int e = tid; e < hb * BQ * CPR; e += nthreads) {
    const int ch = e % CPR, hh = (e / CPR) % hb, r = e / (CPR * hb);
    const bool in = q0 + r < p.Sq;
    const bf16* src = in ? qg + b * p.qsb + (q0 + r) * p.qss + (h0 + hh) * p.qsh + ch * 8 : qg;
    hopper::cp_async16(qs + (hh * BQ + r) * DS + ch * 8, src, in ? 16 : 0);
  }

  auto issue = [&](int kv0, int st) {
    bf16* ks = ks_of(st);
    bf16* vs = vs_of(st);
    for (int e = tid; e < hb * BKV * CPR; e += nthreads) {
      const int ch = e % CPR, hh = (e / CPR) % hb, j = e / (CPR * hb);
      const int kpos = kv0 + j, hk = (h0 + hh) / group;
      const bool in = kpos < kv_end;
      const bf16* ksrc = in ? kg + b * p.ksb + kpos * p.kss + hk * p.ksh + ch * 8 : kg;
      const bf16* vsrc = in ? vg + b * p.vsb + kpos * p.vss + hk * p.vsh + ch * 8 : vg;
      hopper::cp_async16(ks + (hh * BKV + j) * DS + ch * 8, ksrc, in ? 16 : 0);
      hopper::cp_async16(vs + (hh * BKV + j) * DS + ch * 8, vsrc, in ? 16 : 0);
    }
    if constexpr (BK != 0) {
      if (packed) {             // a tile row: BKV keys x all heads, contiguous
        unsigned char* bs = bs_of(st);
        const unsigned char* bias = static_cast<const unsigned char*>(p.bias);
        for (int e = tid; e < BQ * (BKV / 2); e += nthreads) {
          const int r = e / (BKV / 2), ch = e % (BKV / 2);
          const int key0 = kv0 + 2 * ch;
          int valid = q0 + r < p.Sq ? (kv_end - key0) * 8 : 0;
          valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
          const unsigned char* src =
              valid ? bias + ES * (bb * p.bsb + (q0 + r) * p.bsq + key0 * p.bsk) : bias;
          hopper::cp_async16(bs + (r * (BKV / 2) + bias_chunk(r, ch)) * 16, src, valid);
        }
      }
    }
  };
  auto load_bias = [&](int kv0, int st) {      // any strides: element by element
    if constexpr (BK != 0) {
      if (packed) return;
      float* bs = reinterpret_cast<float*>(bs_of(st));
      for (int e = tid; e < BQ * BKV * hb; e += nthreads) {
        const int hh = e % hb, j = (e / hb) % BKV, r = e / (hb * BKV);
        const int qpos = q0 + r, kpos = kv0 + j;
        const bool in = qpos < p.Sq && kpos < kv_end;
        const int64_t off = bb * p.bsb + (h0 + hh) * p.bsh + qpos * p.bsq + kpos * p.bsk;
        float x = 0.f;
        if (in) {
          if constexpr (BK == 1) x = static_cast<const float*>(p.bias)[off];
          else x = __bfloat162float(static_cast<const bf16*>(p.bias)[off]);
        }
        bs[(hh * BQ + r) * BRS + j] = x;
      }
    }
  };

  // online softmax in the log2 domain: logits times log2(e), p = 2^(x - m)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;
  unsigned qa[q_in_regs<D>() ? D / 16 : 1][4];
  const int mat = lane >> 3, r8 = lane & 7;
  const bf16* qw = qs + (hs * BQ + rg * 16 + (lane & 15)) * DS + 8 * (lane >> 4);

  if (kv_start < kv_end) issue(kv_start, 0);
  hopper::cp_async_commit();                      // Q and the first tile
  if (kv_start < kv_end) load_bias(kv_start, 0);
  int it = 0;
  for (int kv0 = kv_start; kv0 < kv_end; kv0 += BKV, ++it) {
    const int st = it & 1;
    const bool more = kv0 + BKV < kv_end;
    if (more) issue(kv0 + BKV, st ^ 1);
    hopper::cp_async_commit();
    if (more) load_bias(kv0 + BKV, st ^ 1);
    hopper::cp_async_wait<1>();
    __syncthreads();                              // this tile (and Q) visible
    if constexpr (q_in_regs<D>()) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) hopper::ldsm_x4(qa[kk], qw + kk * 16);
      }
    }
    const bf16* ks = ks_of(st) + hs * BKV * DS;
    const bf16* vs = vs_of(st) + hs * BKV * DS;
    const unsigned char* bs = bs_of(st);

    float s[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[ni][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned(&qf)[4] = qa[q_in_regs<D>() ? kk : 0];
      if constexpr (!q_in_regs<D>()) hopper::ldsm_x4(qa[0], qw + kk * 16);
#pragma unroll
      for (int nj = 0; nj < NT; nj += 2) {
        unsigned bk[4];
        hopper::ldsm_x4(bk, ks + (nj * 8 + 8 * (mat >> 1) + r8) * DS + kk * 16 + 8 * (mat & 1));
        hopper::mma_bf16(s[nj], qf, bk[0], bk[1]);
        hopper::mma_bf16(s[nj + 1], qf, bk[2], bk[3]);
      }
    }

    // logits: scale, bias, masks (skipped on a tile no mask reaches); row
    // max over the quad of a row
    const bool full = kv0 + BKV <= kv_end && q0 + BQ <= p.Sq && !p.causal && p.window < 0;
    unsigned good = 0xffffffffu;
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {            // rows g, g + 8
        const int r = rg * 16 + g + 8 * e2, j = ni * 8 + 2 * c;
        float2 x = make_float2(s[ni][2 * e2] * p.scale, s[ni][2 * e2 + 1] * p.scale);
        if constexpr (BK != 0) {
          const float2 bv = bias_pair<BK, BKV>(bs, packed, hb, hs, r, j);
          x.x += bv.x;
          x.y += bv.y;
        }
        x.x *= LOG2E;
        x.y *= LOG2E;
        if (!full) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qpos = q0 + r, kpos = kv0 + j + e;
            bool ok = kpos < kv_end && qpos < p.Sq;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.window >= 0) ok = ok && kpos > qpos - p.window;
            if (!ok) good &= ~(1u << (ni * 4 + 2 * e2 + e));
          }
        }
        const int bit = ni * 4 + 2 * e2;
        s[ni][2 * e2] = (good >> bit) & 1u ? x.x : NEG;
        s[ni][2 * e2 + 1] = (good >> (bit + 1)) & 1u ? x.y : NEG;
        mt[e2] = fmaxf(mt[e2], fmaxf(s[ni][2 * e2], s[ni][2 * e2 + 1]));
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (good >> (ni * 4 + e)) & 1u ? ex2(s[ni][e] - m[e >> 1]) : 0.f;
        s[ni][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }

    // O += (P_hi + P_lo) V, 16 keys a step
#pragma unroll
    for (int j2 = 0; j2 < BKV / 16; ++j2) {
      unsigned ahi[4], alo[4];
      split_bf16(s[2 * j2][0], s[2 * j2][1], ahi[0], alo[0]);
      split_bf16(s[2 * j2][2], s[2 * j2][3], ahi[1], alo[1]);
      split_bf16(s[2 * j2 + 1][0], s[2 * j2 + 1][1], ahi[2], alo[2]);
      split_bf16(s[2 * j2 + 1][2], s[2 * j2 + 1][3], ahi[3], alo[3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        unsigned bv[4];
        hopper::ldsm_x4_trans(bv, vs + (j2 * 16 + r8 + 8 * (mat & 1)) * DS + dn * 8 +
                                      8 * (mat >> 1));
        hopper::mma_bf16(o[dn], ahi, bv[0], bv[1]);
        hopper::mma_bf16(o[dn], alo, bv[0], bv[1]);
        hopper::mma_bf16(o[dn + 1], ahi, bv[2], bv[3]);
        hopper::mma_bf16(o[dn + 1], alo, bv[2], bv[3]);
      }
    }
    __syncthreads();                              // the stage may be refilled
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                                // Q's copy done even with no tile

  // o / max(l, 1e-30) through this warp's own Q rows, 16-byte stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* os = qs + (hs * BQ + rg * 16) * DS;
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * c;
    *reinterpret_cast<unsigned*>(os + g * DS + col) = hopper::pack_bf16(o[dn][0] / d0, o[dn][1] / d0);
    *reinterpret_cast<unsigned*>(os + (g + 8) * DS + col) =
        hopper::pack_bf16(o[dn][2] / d1, o[dn][3] / d1);
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.o);
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, ch = e % CPR, qpos = q0 + rg * 16 + r;
    if (qpos >= p.Sq) continue;
    *reinterpret_cast<uint4*>(og + ((static_cast<int64_t>(b) * p.Sq + qpos) * p.Hq + h0 + hs) * D +
                              ch * 8) = *reinterpret_cast<const uint4*>(os + r * DS + ch * 8);
  }
}

template <int D, int BK>
int launch_d(Params p, cudaStream_t stream) {
  // per instantiation: the device's shared-memory limit and the size last set
  static int optin = 0;
  static size_t set_bytes = 0;
  cudaError_t err;
  if (!optin) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess)
      return hopper::status(err, 1);
  }
  constexpr int ES = bias_bytes<BK>();
  int hb = max_threads<D>() / (32 * RG), packed = 0;
  for (;; hb /= 2) {
    // the bias tile is copied raw when a tile row is one contiguous run
    // holding two keys of all the block's heads in 16 bytes
    packed = BK != 0 && hb == p.Hq && hb * ES == 8 && p.bsh == 1 && p.bsk == hb &&
             reinterpret_cast<uintptr_t>(p.bias) % 16 == 0 && (p.bsq * ES) % 16 == 0 &&
             (p.Bb == 1 || (p.bsb * ES) % 16 == 0);
    if (hb == 1 || (p.Hq % hb == 0 && smem_bytes<D, BK>(hb, packed) <= static_cast<size_t>(optin)))
      break;
  }
  p.hb = hb;
  p.packed_bias = packed;
  const size_t bytes = smem_bytes<D, BK>(hb, packed);
  if (bytes != set_bytes) {
    err = cudaFuncSetAttribute(flash_tc_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return hopper::status(err, 2);
    set_bytes = bytes;
  }
  const long long blocks = static_cast<long long>((p.Sq + BQ - 1) / BQ) * (p.Hq / hb) * p.B;
  if (blocks >= (1ll << 31)) return hopper::status(cudaErrorInvalidValue, 3);
  flash_tc_kernel<D, BK><<<dim3(static_cast<unsigned>(blocks)), dim3(32 * RG * hb), bytes,
                           stream>>>(p);
  return hopper::status(cudaGetLastError(), 4);
}

template <int D>
int launch_bias(const Params& p, cudaStream_t s) {
  switch (p.bias_kind) {
    case 0: return launch_d<D, 0>(p, s);
    case 1: return launch_d<D, 1>(p, s);
    case 2: return launch_d<D, 2>(p, s);
    default: return hopper::status(cudaErrorInvalidValue, 1);
  }
}

}  // namespace tc

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* kvlen, void* o, int bias_kind, int B, int Sq, int Skv, int Hq,
                   int Hkv, int Bb, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                   int64_t bsb, int64_t bsh, int64_t bsq, int64_t bsk, int causal, int window,
                   float scale) {
  return Params{q, k, v, bias, static_cast<const int32_t*>(kvlen), o, bias_kind,
                B, Sq, Skv, Hq, Hkv, Bb, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                bsb, bsh, bsq, bsk, causal, window, scale, 1, 0};
}

}  // namespace

// Strides are in elements; the head dim of q, k, v has unit stride and o is
// a contiguous (B, Sq, Hq, D) tensor of q's type.  kvlen is null or (B,)
// int32.  Returns the launch status (hopper::status).
//
// flash_mha_launch: bf16 q, k, v (qkv_is_bf16 = 1), D in {16, 32, 64, 96, 128, 192, 256},
// every base pointer and every (b, s, h) stride 16-byte aligned.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v, const void* bias,
                                const void* kvlen, void* o, int qkv_is_bf16, int bias_kind,
                                int B, int Sq, int Skv, int Hq, int Hkv, int D, int Bb,
                                int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                                int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                                int64_t vsh, int64_t bsb, int64_t bsh, int64_t bsq,
                                int64_t bsk, int causal, int window, float scale,
                                void* stream) {
  if (B == 0 || Sq == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!qkv_is_bf16) return hopper::status(cudaErrorInvalidValue, 1);
  const Params p = make_params(q, k, v, bias, kvlen, o, bias_kind, B, Sq, Skv, Hq, Hkv, Bb,
                               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsq,
                               bsk, causal, window, scale);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return tc::launch_bias<16>(p, s);
    case 32: return tc::launch_bias<32>(p, s);
    case 64: return tc::launch_bias<64>(p, s);
    case 96: return tc::launch_bias<96>(p, s);
    case 128: return tc::launch_bias<128>(p, s);
    case 192: return tc::launch_bias<192>(p, s);
    case 256: return tc::launch_bias<256>(p, s);
    default: return hopper::status(cudaErrorInvalidValue, 1);
  }
}

// flash_mha_simt_launch: f32 or bf16 q, k, v, D in {8, 16, 32, 64, 128}.
extern "C" int flash_mha_simt_launch(const void* q, const void* k, const void* v,
                                     const void* bias, const void* kvlen, void* o,
                                     int qkv_is_bf16, int bias_kind, int B, int Sq, int Skv,
                                     int Hq, int Hkv, int D, int Bb, int64_t qsb, int64_t qss,
                                     int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                                     int64_t vsb, int64_t vss, int64_t vsh, int64_t bsb,
                                     int64_t bsh, int64_t bsq, int64_t bsk, int causal,
                                     int window, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  const Params p = make_params(q, k, v, bias, kvlen, o, bias_kind, B, Sq, Skv, Hq, Hkv, Bb,
                               qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsq,
                               bsk, causal, window, scale);
  auto s = static_cast<cudaStream_t>(stream);
  return qkv_is_bf16 ? simt::launch_typed<bf16>(p, D, s) : simt::launch_typed<float>(p, D, s);
}
