// Dequantization-free AAQ matmul:
//   y[t, :] = sigma[t] * (q[t, :] @ W) + sum_j ovals[t, j] * W[oidx[t, j], :]
//
// Replaces the Pallas TPU kernel repro/kernels/aaq_matmul/aaq_matmul.py:
// aaq_matmul_pallas (body _qmm_kernel).  Two variants, chosen by W's type:
//
// bf16 W (the main path): aaq_matmul_tc_kernel, on the tensor cores.
//   Bound on the H100: bytes.  At the main-path shapes (T = N^2 tokens,
//   (H, D) in {(128,4), (128,128), (128,384), (128,512), (512,128)}) a call
//   is 2*T*H*D operations against T*(H/2 + 2*D) bytes, 90 to 240 operations
//   a byte, below the card's bf16 balance point (~295): the packed q read
//   and the (T, D) bf16 write set the time.  So the design moves each of
//   those bytes once while the products ride on the tensor cores:
//   - W (H x BD) is loaded once per block into shared memory and stays
//     there; a persistent grid of ~occupancy x SM blocks per D tile walks
//     the 128-token tiles, so W is read once per block, not per tile.
//   - q tiles (128 tokens x H/2 bytes), with their sigma and outlier
//     values and indices, stream through a two-stage cp.async ring, 16
//     bytes a thread, the next tile's copy overlapping this tile's
//     products; W's own copy rides with the first tile.
//   - Each thread reads one 32-bit word of q (8 int4 or 4 int8 inliers)
//     per row and k step and widens it to bf16 in registers (exact for
//     |q| <= 127) as an m16n8k16 A fragment.  The word holds the thread's
//     inliers in a permuted k order; W's rows are stored in shared memory in
//     the same order (phys_row below), so the sum is the same and every
//     fragment is one load.  B fragments come from ldmatrix.trans (W is
//     (H, D) row-major).  mma.sync bf16 x bf16 -> float32: the products
//     are exact, only the order of the float32 sums differs.
//   - Epilogue: times sigma[t], plus the rank-k outlier term gathered from
//     the W rows already in shared memory (the reference's "VMEM gather"),
//     rounded once to bf16, staged through shared memory and written with
//     16-byte coalesced stores.  The ragged T edge and D not a multiple of
//     the tile (D = 4: one masked n8 tile) are masked.
//
// f32 W: aaq_matmul_simt_kernel, IEEE float32 on the CUDA cores (64x64
//   output tiles, H staged through shared memory 32 at a time).  No main
//   path call uses it; it keeps the reference's f32 precision.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------
constexpr int TC_BT = 128, TC_THREADS = 256;

template <int BD> struct TcTile {
  static constexpr int WT = BD == 8 ? 8 : 4;        // warps along tokens
  static constexpr int WD = 8 / WT;                 // warps along D
  static constexpr int MT = TC_BT / WT / 16;        // m16 tiles a warp
  static constexpr int NT = BD / WD / 8;            // n8 tiles a warp
  static constexpr int WS = BD == 8 ? 24 : BD + 8;  // W/Y smem row stride (elements)
};

// Row of W stored at shared row L.  A thread's A fragment of one k step
// holds logical k = 2c + e + 8h (c = lane % 4, e, h in {0, 1}); it reads
// them as 4 consecutive physical columns of one 32-bit word of q: columns
// 8c + 4s + 2h + e of a 32-column block (int4, k step s of the block's
// two) or 4c + 2h + e of a 16-column block (int8).
template <int BITS> __device__ __forceinline__ int phys_row(int L) {
  if (BITS == 4) {
    const int b = L & ~31, i = L & 31;
    const int s = i >> 4, h = (i >> 3) & 1, c = (i & 7) >> 1, e = i & 1;
    return b + 8 * c + 4 * s + 2 * h + e;
  }
  const int b = L & ~15, i = L & 15;
  const int h = i >> 3, c = (i & 7) >> 1, e = i & 1;
  return b + 4 * c + 2 * h + e;
}
template <int BITS> __device__ __forceinline__ int logical_row(int p) {
  if (BITS == 4) {
    const int b = p & ~31, i = p & 31;
    const int c = i >> 3, s = (i >> 2) & 1, h = (i >> 1) & 1, e = i & 1;
    return b + 16 * s + 8 * h + 2 * c + e;
  }
  const int b = p & ~15, i = p & 15;
  const int c = i >> 2, h = (i >> 1) & 1, e = i & 1;
  return b + 8 * h + 2 * c + e;
}

// Two inliers of `word` (k step s, half h) widened to a bf16 pair.
template <int BITS> __device__ __forceinline__ unsigned widen(unsigned word, int s, int h) {
  int lo, hi;
  if (BITS == 4) {
    const int n = 4 * s + 2 * h;                    // nibble index
    lo = static_cast<int>(word << (28 - 4 * n)) >> 28;
    hi = static_cast<int>(word << (24 - 4 * n)) >> 28;
  } else {
    const int n = 2 * h;                            // byte index
    lo = static_cast<int>(word << (24 - 8 * n)) >> 24;
    hi = static_cast<int>(word << (16 - 8 * n)) >> 24;
  }
  return hopper::pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// Bytes of one ring stage: the q tile and the epilogue's per-token operands.
__host__ __device__ inline int tc_stage_bytes(int rowb, int kk) {
  return TC_BT * (rowb + 16) + TC_BT * 4 + TC_BT * kk * 6;
}

// cp.async bytes [off, off + n) of a `total`-byte array into dst, 16 at a
// time, zero past its end (n a multiple of 16, src 16-byte aligned).
__device__ __forceinline__ void stage_rows(unsigned char* dst, const void* src, int64_t off,
                                           int64_t total, int n, int tid) {
  for (int i = tid * 16; i < n; i += TC_THREADS * 16) {
    const int64_t left = total - (off + i);
    const int valid = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    hopper::cp_async16(dst + i, valid ? static_cast<const unsigned char*>(src) + off + i : src,
                       valid);
  }
}

template <int BITS, int BD>
__global__ void __launch_bounds__(TC_THREADS)
aaq_matmul_tc_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                     const bf16* __restrict__ ovals, const int32_t* __restrict__ oidx,
                     const bf16* __restrict__ w, bf16* __restrict__ y,
                     int n_tokens, int h, int d, int k, int kk) {
  using C = TcTile<BD>;
  constexpr int KB = BITS == 4 ? 32 : 16;           // k columns per q word
  constexpr int STEPS = KB / 16;                    // k steps per q word
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowb = BITS == 4 ? h / 2 : h;           // bytes of q a token
  const int qstride = rowb + 16;                    // padded: no bank conflicts
  const int stage_bytes = tc_stage_bytes(rowb, kk);
  bf16* ws = reinterpret_cast<bf16*>(smem);                         // [h][WS]
  unsigned char* stages = smem + static_cast<size_t>(h) * C::WS * 2;
  bf16* ys = reinterpret_cast<bf16*>(stages + 2 * stage_bytes);     // [BT][WS]

  const int d0 = blockIdx.y * BD;
  const int ntiles = (n_tokens + TC_BT - 1) / TC_BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm0 = (warp / C::WD) * (TC_BT / C::WT);
  const int wn0 = (warp % C::WD) * (BD / C::WD);
  const int chunks = rowb / 16;

  // One stage: q [BT][qstride], then sigma [BT] f32, ovals [BT][kk] bf16,
  // oidx [BT][kk] int32 (the epilogue's operands ride with the tile).
  auto issue = [&](int tile, int stage) {
    unsigned char* dst = stages + stage * stage_bytes;
    const int64_t t0 = static_cast<int64_t>(tile) * TC_BT;
    for (int e = tid; e < TC_BT * chunks; e += TC_THREADS) {
      const int r = e / chunks, ch = e % chunks;
      const bool in = t0 + r < n_tokens;
      const int8_t* src = q + (in ? (t0 + r) * rowb + ch * 16 : 0);
      hopper::cp_async16(dst + r * qstride + ch * 16, src, in ? 16 : 0);
    }
    dst += TC_BT * qstride;
    stage_rows(dst, scale, t0 * 4, static_cast<int64_t>(n_tokens) * 4, TC_BT * 4, tid);
    if (k > 0) {
      dst += TC_BT * 4;
      stage_rows(dst, ovals, t0 * kk * 2, static_cast<int64_t>(n_tokens) * kk * 2,
                 TC_BT * kk * 2, tid);
      dst += TC_BT * kk * 2;
      stage_rows(dst, oidx, t0 * kk * 4, static_cast<int64_t>(n_tokens) * kk * 4,
                 TC_BT * kk * 4, tid);
    }
  };

  int tile = blockIdx.x;
  // the W tile, rows in the fragments' k order, zero beyond D: 16-byte
  // copies in the first tile's group where D is a multiple of 8
  if ((d & 7) == 0) {
    for (int e = tid; e < h * (BD / 8); e += TC_THREADS) {
      const int L = e / (BD / 8), dg = d0 + 8 * (e % (BD / 8));
      const bool in = dg < d;
      hopper::cp_async16(ws + L * C::WS + dg - d0,
                         in ? w + static_cast<int64_t>(phys_row<BITS>(L)) * d + dg : w,
                         in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < h * BD; e += TC_THREADS) {
      const int L = e / BD, dd = e % BD, dg = d0 + dd;
      ws[L * C::WS + dd] = dg < d ? w[static_cast<int64_t>(phys_row<BITS>(L)) * d + dg]
                                  : __float2bfloat16(0.f);
    }
  }
  if (tile < ntiles) issue(tile, 0);
  hopper::cp_async_commit();

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    if (tile + static_cast<int>(gridDim.x) < ntiles) issue(tile + gridDim.x, stage ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();                        // this tile's q (and W) visible

    const unsigned char* qt = stages + stage * stage_bytes;
    const float* st_scale = reinterpret_cast<const float*>(qt + TC_BT * qstride);
    const bf16* st_ovals = reinterpret_cast<const bf16*>(st_scale + TC_BT);
    const int32_t* st_oidx = reinterpret_cast<const int32_t*>(st_ovals + TC_BT * kk);
    float acc[C::MT][C::NT][4];
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

    for (int kb = 0; kb < h; kb += KB) {
      unsigned word[C::MT][2];
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          word[mi][hr] = *reinterpret_cast<const unsigned*>(
              qt + (wm0 + 16 * mi + g + 8 * hr) * qstride + kb * BITS / 8 + 4 * c);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        unsigned a[C::MT][4];
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi) {
          a[mi][0] = widen<BITS>(word[mi][0], s, 0);
          a[mi][1] = widen<BITS>(word[mi][1], s, 0);
          a[mi][2] = widen<BITS>(word[mi][0], s, 1);
          a[mi][3] = widen<BITS>(word[mi][1], s, 1);
        }
        const int k0 = kb + 16 * s;
        const int mat = lane >> 3, r8 = lane & 7;
        if constexpr (C::NT == 1) {
          unsigned b[2];
          hopper::ldsm_x2_trans(b, ws + (k0 + r8 + 8 * (mat & 1)) * C::WS + wn0);
#pragma unroll
          for (int mi = 0; mi < C::MT; ++mi) hopper::mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
        } else {
#pragma unroll
          for (int nj = 0; nj < C::NT; nj += 2) {
            unsigned b[4];
            hopper::ldsm_x4_trans(
                b, ws + (k0 + r8 + 8 * (mat & 1)) * C::WS + wn0 + 8 * (nj + (mat >> 1)));
#pragma unroll
            for (int mi = 0; mi < C::MT; ++mi) {
              hopper::mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
              hopper::mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
    }

    // epilogue: sigma, the outlier term from the resident W rows, bf16
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm0 + 16 * mi + g + 8 * hr;
        const float sig = st_scale[r];             // 0 past the last token
        float ov[4] = {0.f, 0.f, 0.f, 0.f};
        int orow[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < k) {
            ov[j] = __bfloat162float(st_ovals[r * kk + j]);
            orow[j] = logical_row<BITS>(st_oidx[r * kk + j]);
          }
#pragma unroll
        for (int ni = 0; ni < C::NT; ++ni) {
          const int col = wn0 + 8 * ni + 2 * c;
          float v0 = acc[mi][ni][2 * hr] * sig, v1 = acc[mi][ni][2 * hr + 1] * sig;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < k) {
              const float2 wv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(ws + orow[j] * C::WS + col));
              v0 = fmaf(ov[j], wv.x, v0);
              v1 = fmaf(ov[j], wv.y, v1);
            }
          *reinterpret_cast<unsigned*>(ys + r * C::WS + col) = hopper::pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();                        // the y tile staged
    constexpr int CPR = BD / 8;             // 16-byte chunks a row
    for (int e = tid; e < TC_BT * CPR; e += TC_THREADS) {
      const int r = e / CPR, dg = d0 + 8 * (e % CPR);
      const int64_t t = static_cast<int64_t>(tile) * TC_BT + r;
      if (t >= n_tokens || dg >= d) continue;
      bf16* dst = y + t * d + dg;
      const bf16* src = ys + r * C::WS + (dg - d0);
      if ((d & 7) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8 && dg + j < d; ++j) dst[j] = src[j];
      }
    }
  }
  hopper::cp_async_wait<0>();
}

template <int BITS, int BD>
int launch_tc(const int8_t* q, const float* scale, const bf16* ovals, const int32_t* oidx,
              const bf16* w, bf16* y, int n_tokens, int h, int d, int k, int kk,
              cudaStream_t stream) {
  using C = TcTile<BD>;
  const int bytes = h * C::WS * 2 + 2 * tc_stage_bytes(BITS == 4 ? h / 2 : h, kk) +
                    TC_BT * C::WS * 2;
  auto kern = aaq_matmul_tc_kernel<BITS, BD>;
  // per instantiation: the shared-memory size last set and its occupancy
  static int set_bytes = -1, per_sm = 0, sms = 0;
  if (bytes != set_bytes) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return hopper::status(err, 1);
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return hopper::status(err, 2);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS, bytes);
    if (err != cudaSuccess || per_sm < 1)
      return hopper::status(err != cudaSuccess ? err : cudaErrorInvalidConfiguration, 3);
    set_bytes = bytes;
  }
  const int dtiles = (d + BD - 1) / BD;
  const int ntiles = (n_tokens + TC_BT - 1) / TC_BT;
  const int walkers = (per_sm * sms + dtiles - 1) / dtiles;
  const dim3 grid(ntiles < walkers ? ntiles : walkers, dtiles);
  kern<<<grid, TC_THREADS, bytes, stream>>>(q, scale, ovals, oidx, w, y, n_tokens, h, d, k, kk);
  return hopper::status(cudaGetLastError(), 4);
}

// ---------------------------------------------------------------------------
// float32 SIMT variant
// ---------------------------------------------------------------------------
constexpr int BT = 64, BD = 64, BH = 32, NTHREADS = 256;

// Signed value of column h of token row `row` (packed nibbles when bits == 4).
__device__ __forceinline__ int inlier(const int8_t* row, int h, int bits) {
  if (bits == 8) return row[h];
  const int8_t b = row[h >> 1];
  return (h & 1) ? (b >> 4) : ((int8_t)(b << 4) >> 4);
}

__global__ void aaq_matmul_simt_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       const bf16* __restrict__ ovals,
                                       const int32_t* __restrict__ oidx,
                                       const float* __restrict__ w, float* __restrict__ y,
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
      ws[hh][dd] = (hg < h && dg < d) ? w[(int64_t)hg * d + dg] : 0.f;
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
        o = fmaf(__bfloat162float(ovals[(int64_t)t * kk + r]), w[(int64_t)row * d + dg], o);
      }
      y[(int64_t)t * d + dg] = acc[i][j] * s + o;
    }
  }
}

}  // namespace

// q (T, H/2) int4 packed or (T, H) int8; scale (T) f32; ovals, oidx (T, kk)
// bf16/int32 with kk >= max(k, 1); w (H, D) and y (T, D) bf16; all
// contiguous and 16-byte aligned; H a multiple of 32 (int4) or 16 (int8),
// at most 512.  Returns the launch status (hopper::status).
extern "C" int aaq_matmul_launch(const void* q, const void* scale, const void* ovals,
                                 const void* oidx, const void* w, void* y, int n_tokens,
                                 int h, int d, int bits, int k, int kk, void* stream) {
  if (n_tokens == 0 || d == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  auto s = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const int8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<const bf16*>(ovals);
  auto* ip = static_cast<const int32_t*>(oidx);
  auto* wp = static_cast<const bf16*>(w);
  auto* yp = static_cast<bf16*>(y);
  int err;
  if (d <= 8)
    err = bits == 4 ? launch_tc<4, 8>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s)
                    : launch_tc<8, 8>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s);
  else if (h <= 128)
    err = bits == 4 ? launch_tc<4, 128>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s)
                    : launch_tc<8, 128>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s);
  else if (bits == 4)
    err = launch_tc<4, 64>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s);
  else        // int8 q tiles are twice as wide: a narrower W tile keeps the ring in 227 KB
    err = launch_tc<8, 32>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s);
  return err;
}

// As aaq_matmul_launch with w (H, D) and y (T, D) float32, any H.
extern "C" int aaq_matmul_f32_launch(const void* q, const void* scale, const void* ovals,
                                     const void* oidx, const void* w, void* y, int n_tokens,
                                     int h, int d, int bits, int k, int kk, void* stream) {
  if (n_tokens == 0 || d == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  const dim3 grid((n_tokens + BT - 1) / BT, (d + BD - 1) / BD), block(NTHREADS);
  aaq_matmul_simt_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const bf16*>(ovals), static_cast<const int32_t*>(oidx),
      static_cast<const float*>(w), static_cast<float*>(y), n_tokens, h, d, bits, k, kk);
  return hopper::status(cudaGetLastError(), 4);
}
