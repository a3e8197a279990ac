// Dequantization-free AAQ matmul:
//   y[t, :] = sigma[t] * (q[t, :] @ W) + sum_j ovals[t, j] * W[oidx[t, j], :]
//
// Replaces the Pallas TPU kernel repro/kernels/aaq_matmul/aaq_matmul.py:
// aaq_matmul_pallas (body _qmm_kernel).  Bound on the H100: bytes.  At the
// main-path shapes (T = N^2 tokens, (H, D) in {(128,4), (128,128),
// (128,384), (128,512), (512,128)}) a call is 2*T*H*D operations against
// T*(H/2 + 2*D) bytes, 90 to 240 operations a byte, below the card's bf16
// balance point (~295): the packed q read and the (T, D) bf16 write set the
// time.  So each design moves each of those bytes once while the products
// ride on the tensor cores.  Four variants, chosen by the wrapper's fixed
// rule on W's type and the shape (kernels/aaq_matmul/aaq_matmul.py):
//
// bf16 W, int4 q, H and D multiples of 128 (every main-path call but
// D = 4): aaq_matmul_wg_kernel (namespace mmwg), Hopper's wgmma and TMA.
//   - Persistent: one block an SM, up to four warpgroups, each walking its
//     own 64-token tiles; W (all of it, H x D) is copied into shared memory
//     once a block, in wgmma's 128-byte-swizzled N-major layout, rows in
//     the fragments' k order (mmwg::phys_row); a tile loops over D in
//     64-column chunks, so q is read once.
//   - A ring of up to 8 stages, each serving one warpgroup: its thread 0
//     loads the q tile (64 x H/2 bytes) by TMA and sigma, ovals and oidx by
//     bulk copies, on the stage's mbarrier, and loads the warpgroup's next
//     tile there as soon as it is done with the stage.  The last, ragged
//     tile comes by TMA boxes zero-filled past the last token, so sigma = 0
//     there and nothing is masked.  No producer warp: with four warpgroups
//     of 128 threads a thread keeps 128 registers, and spills none.
//   - A thread reads 16 bytes of q a row and 128 columns and widens each
//     pair of nibbles to a bf16 pair with bit operations (the nibbles XOR 8
//     ORed into 128.0 = 0x4300, then 136 subtracted: exact), straight into
//     wgmma's register A fragment; wgmma.m64n64k16 with B (W) from shared
//     memory accumulates in float32, then times sigma.
//   - The rank-k outlier term on the tensor cores too: each warpgroup keeps
//     a bf16 tile (64 tokens x 128 k, zero but for each token's outliers at
//     their k); a second wgmma of that tile by W adds exact products, summed
//     in float32.  (Gathering the W rows from shared memory instead read
//     about as slowly as the tensor-core kernel's epilogue: PERF.md.)
//   - Epilogue: rounded once to bf16, written by stmatrix into a swizzled
//     shared tile (double-buffered where it fits) and stored by TMA,
//     asynchronously: the store overlaps the next chunk's or tile's work.
//     No atomics, no split-K: a token's sum runs in the same order wherever
//     it falls, so a row launched alone is bitwise its row of a batch.
//
// other bf16 W (D = 4, int8 q) with H up to 512, a multiple of 32 at 4 bits
// or 16 at 8: aaq_matmul_tc_kernel, Ampere's mma.sync.
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
// f32 W, and bf16 W that neither kernel above takes (H above 512, or an H
//   off their multiples): aaq_matmul_split_kernel (namespace mmsp).  Bound
//   on the H100: bytes (128 -> 128 at 65,536 tokens: the float32 y is 32 MiB
//   of 36, 0.011 ms).  The float32 rule: a float32 W stays float32, so it is
//   split as it is staged into shared memory into three bf16 parts that sum
//   to it exactly (W1 = bf16(W), W2 = bf16(W - W1), W3 = W - W1 - W2); an
//   inlier is exact in bf16, so each of the three bf16 products is exact
//   and their float32 sum keeps float32's precision (three times the
//   tensor work, ~6.4 GFLOP at that shape, about the bytes' time).  A bf16
//   W is its own one part.
//   - A persistent grid walks 128-token tiles of one 64-column tile of y;
//     H in 128-column panels, each a step of a two-stage ring: q's panel by
//     cp.async (16 bytes where rows are 16-byte aligned, 4, else bytes), and
//     W's panel where W does not fit the block whole (H above 384 in
//     float32, above 1,408 in bf16); where it fits, W's parts stay resident.
//   - The tensor-core kernel's fragments: q words widened to bf16 in
//     registers (phys_row's k order), ldmatrix.trans of each part, mma.sync
//     m16n8k16 into one float32 accumulator, panels, k steps and parts in a
//     fixed order.  No atomics, no split-K: a row alone is bitwise its row
//     of a batch.
//   - Epilogue: times sigma, plus the outlier term ovals * W[oidx] in
//     float32 from W itself in device memory (float32 W is exact there),
//     written from registers (8-byte stores in float32).
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
// Hopper variant: wgmma on int4 widened in registers, a TMA ring, TMA stores
// ---------------------------------------------------------------------------
namespace mmwg {

constexpr int MAX_WG = 4;                   // warpgroups, at most
constexpr int MAX_THREADS = MAX_WG * 128;   // 512 threads: 128 registers each
constexpr int BT = 64;                      // tokens of a tile: one warpgroup's
constexpr int BN = 64;                      // output columns of one product and store
constexpr int KMAX = 4;                     // outliers a token, at most
constexpr int OUT_BYTES = BT * BN * 2;      // one staged output chunk
constexpr int OL_BYTES = BT * 128 * 2;      // an outlier tile: 64 tokens x 128 k, bf16
constexpr int SMEM_LIMIT = 232448;          // opt-in shared memory of one H100 block
// a ring stage after its q tile: sigma [BT] f32, ovals [BT][k] bf16, oidx [BT][k] int32
constexpr int SIG_OFF = 0, OV_OFF = BT * 4, OI_OFF = OV_OFF + BT * KMAX * 2;
constexpr int META_BYTES = OI_OFF + BT * KMAX * 4;

__host__ __device__ constexpr int stage_bytes(int h) { return BT * h / 2 + META_BYTES; }
// W, each warpgroup's staged output chunks and (with outliers)
// outlier tile, the ring, its barriers
__host__ __device__ constexpr int smem_bytes(int h, int d, int warpgroups, int stages,
                                             int out_buffers, bool outliers) {
  return 1024 + h * d * 2 + warpgroups * (out_buffers * OUT_BYTES + (outliers ? OL_BYTES : 0)) +
         stages * stage_bytes(h) + 8 * stages;
}

// Row of W at the fragments' logical k = L (wgmma's A fragment of k step t
// of a 128-column segment m holds k = 128 m + 16 t + 8 h + 2 c + e, for
// lane % 4 = c, register half e and register pair h).  A thread reads the
// 16 bytes 64 m + 16 c .. + 15 of its token's packed row (physical columns
// 128 m + 32 c .. + 31) as four words; word t / 2 gives k steps t with
// nibble 4 e + 2 (t % 2) + h, so a register's two nibbles lie 16 bits apart.
__host__ __device__ constexpr int phys_row(int L) {
  return (L & ~127) + 32 * ((L >> 1) & 3) + 8 * ((L >> 5) & 3) + 4 * (L & 1) +
         2 * ((L >> 4) & 1) + ((L >> 3) & 1);
}
__host__ __device__ constexpr int logical_row(int p) {
  return (p & ~127) + 16 * (2 * ((p >> 3) & 3) + ((p >> 1) & 1)) + 8 * (p & 1) +
         2 * ((p >> 5) & 3) + ((p >> 2) & 1);
}

// Two int4 inliers of `word` (nibbles n and n + 4) as a bf16 pair, exactly:
// 0x4300 | (v ^ 8) is 128 + (v ^ 8) = 136 + q, minus 136.
__device__ __forceinline__ unsigned widen4(unsigned word, int n) {
  const unsigned x = ((word >> (4 * n)) & 0x000F000Fu) ^ 0x43084308u;
  unsigned y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(y) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return y;
}

// A fragments of one 128-column segment m for rows r and r + 8 (k steps 0..7).
__device__ __forceinline__ void build_a(unsigned (&a)[8][4], const unsigned char* qs, int rowb,
                                        int r, int m, int c) {
  const uint4 u0 = *reinterpret_cast<const uint4*>(qs + r * rowb + 64 * m + 16 * c);
  const uint4 u1 = *reinterpret_cast<const uint4*>(qs + (r + 8) * rowb + 64 * m + 16 * c);
  const unsigned w0[4] = {u0.x, u0.y, u0.z, u0.w}, w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int n = 2 * (t & 1);
    a[t][0] = widen4(w0[t >> 1], n);
    a[t][1] = widen4(w1[t >> 1], n);
    a[t][2] = widen4(w0[t >> 1], n + 1);
    a[t][3] = widen4(w1[t >> 1], n + 1);
  }
}

// Byte of (row, k) in a K-major, 128-byte-swizzled bf16 tile of BT rows and
// 128 k: [k / 64][row][128 B], 16-byte chunk (k % 64) / 8 XOR row % 8.
__device__ __forceinline__ int kmajor_off(int row, int k) {
  return (k >> 6) * (BT * 128) + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) + (k & 7) * 2;
}

// wgmma's descriptor of a 128-byte-swizzled tile `off` bytes past `base`,
// built where it is used: the base address passes through an empty asm, so
// the compiler cannot hoist the descriptors out of the loops and keep them
// all in registers, which the four warpgroups do not have.
__device__ __forceinline__ uint64_t desc_here(const void* base, int off) {
  unsigned a = hopper::smem_addr(base);
  asm volatile("" : "+r"(a));
  a += off;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (static_cast<uint64_t>(hopper::SWIZZLE_128B) << 62);
}

struct Params {
  const float* scale;
  const bf16* ovals;
  const int32_t* oidx;
  int n_tokens, h, d, k, warpgroups, stages, out_buffers, ntiles;
};

// OUTLIERS: the rank-k term is added (k > 0); without it the kernel keeps
// no outlier code at all.  SEGS: H / 128 where that is 1 (the fold's H but
// one: A and the outliers once a tile), else 0 (any H, from p.h).
template <bool OUTLIERS, int SEGS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
aaq_matmul_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap ts,
                     const __grid_constant__ CUtensorMap tov,
                     const __grid_constant__ CUtensorMap toi,
                     const __grid_constant__ CUtensorMap ty, const bf16* __restrict__ w,
                     const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int h = p.h, d = p.d, k = OUTLIERS ? p.k : 0, rowb = h / 2, qbytes = BT * rowb;
  const int stb = stage_bytes(h), nthreads = 128 * p.warpgroups;
  const int per_wg = p.out_buffers * OUT_BYTES + (OUTLIERS ? OL_BYTES : 0);
  unsigned char* ws = smem;                                   // W [D/64][H/8][8][128 B]
  unsigned char* wgs = ws + h * d * 2;                        // [warpgroups] {outputs, outliers}
  unsigned char* ring = wgs + p.warpgroups * per_wg;           // [stages] {q, meta}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stb);
  const int tid = threadIdx.x;
  const int my_tiles = (p.ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int wgi = tid >> 7, tw = tid & 127, wi = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, c = lane & 3, r0 = 16 * wi + g;

  // The block's tile i goes to warpgroup i % warpgroups and stage
  // i % stages; stages is a multiple of warpgroups, so each stage serves one
  // warpgroup, whose thread 0 loads it: the first tiles now, each next one
  // once the warpgroup is done with the stage.
  auto load = [&](int i) {
    const int s = i % p.stages, t0 = (blockIdx.x + i * gridDim.x) * BT;
    unsigned char* st = ring + s * stb;
    hopper::mbar_expect_tx(&full[s], qbytes + BT * 4 + BT * k * 6);
    hopper::tma_load_2d(st, &tq, &full[s], 0, t0);
    if (t0 + BT <= p.n_tokens) {
      // a whole tile: sigma and the outliers are contiguous runs, one bulk
      // copy each
      hopper::bulk_load(st + qbytes + SIG_OFF, p.scale + t0, BT * 4, &full[s]);
      if (OUTLIERS) {
        hopper::bulk_load(st + qbytes + OV_OFF, p.ovals + static_cast<int64_t>(t0) * k,
                          BT * k * 2, &full[s]);
        hopper::bulk_load(st + qbytes + OI_OFF, p.oidx + static_cast<int64_t>(t0) * k,
                          BT * k * 4, &full[s]);
      }
    } else {
      // the last, ragged tile: boxes zero-filled past the last token
      hopper::tma_load_1d(st + qbytes + SIG_OFF, &ts, &full[s], t0);
      if (OUTLIERS) {
        hopper::tma_load_1d(st + qbytes + OV_OFF, &tov, &full[s], t0 * k);
        hopper::tma_load_1d(st + qbytes + OI_OFF, &toi, &full[s], t0 * k);
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tw == 0)
    for (int i = wgi; i < my_tiles && i < p.stages; i += p.warpgroups) load(i);

  unsigned char* my_out = wgs + wgi * per_wg;                 // [out_buffers] chunks
  unsigned char* my_ol = my_out + p.out_buffers * OUT_BYTES;  // the outlier tile
  // W, once a block: logical row L holds W[phys_row(L)], 16 bytes a copy,
  // at chunk (column / 8) % 8 XOR L % 8 of its 128-byte row (128-byte
  // swizzle); the outlier tiles start at zero
  for (int e = tid; e < h * (d / 8); e += nthreads) {
    const int L = e / (d / 8), c8 = e % (d / 8), r = L & 7;
    hopper::cp_async16(ws + (c8 >> 3) * (h * 128) + (L >> 3) * 1024 + r * 128 +
                           (((c8 & 7) ^ r) << 4),
                       w + static_cast<int64_t>(phys_row(L)) * d + 8 * c8, 16);
  }
  hopper::cp_async_commit();
  if (OUTLIERS)
    for (int e = tw; e < OL_BYTES / 16; e += 128)
      *reinterpret_cast<uint4*>(my_ol + 16 * e) = make_uint4(0, 0, 0, 0);
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  hopper::named_sync(1 + MAX_WG, nthreads);

  const int segs = SEGS ? SEGS : h / 128, chunks = d / BN;
  const int atom = h * 128;                                   // bytes of one 64-column atom of W
  const int bar = 1 + wgi;                                    // this warpgroup's barrier
  int nout = 0;                                               // chunks this warpgroup stored
  unsigned a[8][4];
  float acc[32];

  for (int i = wgi; i < my_tiles; i += p.warpgroups) {
    const int s = i % p.stages, t0 = (blockIdx.x + i * gridDim.x) * BT;
    hopper::mbar_wait(&full[s], (i / p.stages) & 1);
    const unsigned char* qs = ring + s * stb;
    const unsigned char* meta = qs + qbytes;
    float sig[2];
    int ol_k[2] = {-1, -1};                                   // this thread's outliers' k
    bf16 ol_v[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      sig[hf] = reinterpret_cast<const float*>(meta + SIG_OFF)[r];   // 0 past the last token
      // outlier c of the row, placed at its logical k in the outlier tile
      // (at once where H is one segment: the placement overlaps the
      // products; the epilogue's barriers order it after the last tile's
      // zeros)
      if (OUTLIERS && c < k) {
        ol_k[hf] = logical_row(reinterpret_cast<const int32_t*>(meta + OI_OFF)[r * k + c]);
        ol_v[hf] = reinterpret_cast<const bf16*>(meta + OV_OFF)[r * k + c];
        if (segs == 1)
          *reinterpret_cast<bf16*>(my_ol + kmajor_off(r, ol_k[hf])) = ol_v[hf];
      }
    }
    if (OUTLIERS && segs == 1) hopper::fence_proxy_async();
    for (int nc = 0; nc < chunks; ++nc) {
      const unsigned char* wn = ws + nc * atom;               // W's 64 columns of this chunk
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      for (int m = 0; m < segs; ++m) {
        // A once a tile where H is one segment (held through the chunks),
        // else once a segment
        if (segs > 1 || nc == 0) build_a(a, qs, rowb, r0, m, c);
#pragma unroll
        for (int t = 0; t < 8; ++t) hopper::reg_fence(a[t]);
        hopper::reg_fence(acc);
        hopper::wgmma_fence();
        const unsigned char* wb = wn + 16 * m * 1024;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          hopper::wgmma_m64n64k16_rs(acc, a[t], desc_here(wb, t * 2048));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(acc);
#pragma unroll
        for (int t = 0; t < 8; ++t) hopper::reg_fence(a[t]);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] *= sig[(j >> 1) & 1];
      if (OUTLIERS) {
        // + the outlier tile (each token's bf16 outliers at their k, zero
        // elsewhere) x W, 128 k at a time: exact products summed in float32
        for (int m = 0; m < segs; ++m) {
          if (segs > 1) {
            hopper::named_sync(bar, 128);                     // the last segment's zeros written
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              if ((ol_k[hf] >> 7) == m)
                *reinterpret_cast<bf16*>(my_ol + kmajor_off(r0 + 8 * hf, ol_k[hf] & 127)) =
                    ol_v[hf];
            hopper::fence_proxy_async();
          }
          if (segs > 1 || nc == 0) hopper::named_sync(bar, 128);   // every thread's outliers placed
          hopper::reg_fence(acc);
          hopper::wgmma_fence();
          const unsigned char* wb = wn + 16 * m * 1024;
#pragma unroll
          for (int t = 0; t < 8; ++t)
            hopper::wgmma_m64n64k16_ss_nt(acc,
                                          desc_here(my_ol, (t >> 2) * (BT * 128) + (t & 3) * 32),
                                          desc_here(wb, t * 2048));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::reg_fence(acc);
          if (segs > 1 || nc == chunks - 1) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              if ((ol_k[hf] >> 7) == m)
                *reinterpret_cast<unsigned short*>(
                    my_ol + kmajor_off(r0 + 8 * hf, ol_k[hf] & 127)) = 0;
          }
        }
      }

      // epilogue: the staged chunk's buffer is free once the store that
      // last read it has read it; bf16 pairs by stmatrix, stored by TMA
      unsigned char* ob = my_out + (nout % p.out_buffers) * OUT_BYTES;
      if (tw == 0) {
        if (p.out_buffers == 2) hopper::bulk_wait_read<1>();
        else hopper::bulk_wait_read<0>();
      }
      hopper::named_sync(bar, 128);
      // the warpgroup is done with the stage: its next tile there
      if (tw == 0 && nc == chunks - 1 && i + p.stages < my_tiles) load(i + p.stages);
#pragma unroll
      for (int q2 = 0; q2 < BN / 16; ++q2) {
        unsigned pk[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j8 = 2 * q2 + jj;
            pk[2 * jj + hf] = hopper::pack_bf16(acc[4 * j8 + 2 * hf], acc[4 * j8 + 2 * hf + 1]);
          }
        // lane l: row l % 8 of matrix l / 8 (rows + 8 for odd matrices,
        // the next 8 columns for matrices 2 and 3)
        const int mi = lane >> 3, row = 16 * wi + (lane & 7) + 8 * (mi & 1);
        const int c8 = 2 * q2 + (mi >> 1);
        hopper::stsm_x4(ob + row * 128 + ((c8 ^ (row & 7)) << 4), pk);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(bar, 128);
      if (tw == 0) {
        hopper::tma_store_2d(&ty, ob, nc * BN, t0);
        hopper::bulk_commit();
      }
      ++nout;
    }
  }
  if (tw == 0) hopper::bulk_wait_all();
}

int launch(const void* q, const void* scale, const void* ovals, const void* oidx, const bf16* w,
           void* y, int n_tokens, int h, int d, int k, int warpgroups, int stages, int out_buffers,
           cudaStream_t stream) {
  const int bytes = smem_bytes(h, d, warpgroups, stages, out_buffers, k > 0);
  // each stage serves one warpgroup: stages is a multiple of warpgroups
  if (h % 128 || h > 512 || d % BN || k < 0 || k > KMAX || warpgroups < 1 || warpgroups > MAX_WG ||
      stages < warpgroups || stages % warpgroups || out_buffers < 1 || out_buffers > 2 ||
      bytes > SMEM_LIMIT)
    return hopper::status(cudaErrorInvalidValue, 1);
  static bool attr = false;
  static int sms = 0;
  if (!attr) {
    cudaError_t err = cudaSuccess;
    for (auto kern : {aaq_matmul_wg_kernel<true, 1>, aaq_matmul_wg_kernel<false, 1>,
                      aaq_matmul_wg_kernel<true, 0>, aaq_matmul_wg_kernel<false, 0>})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return hopper::status(err, 2);
    attr = true;
  }
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return hopper::status(err, 1);
  }
  const uint64_t T = static_cast<uint64_t>(n_tokens);
  CUtensorMap tq, ts, tov, toi, ty;
  const uint64_t qd[2] = {static_cast<uint64_t>(h / 2), T}, qs[1] = {static_cast<uint64_t>(h / 2)};
  const uint32_t qbox[2] = {static_cast<uint32_t>(h / 2), BT};
  const uint64_t sd[1] = {T}, od[1] = {T * static_cast<uint64_t>(k)};
  const uint32_t sbox[1] = {BT}, obox[1] = {static_cast<uint32_t>(BT * k)};
  const uint64_t yd[2] = {static_cast<uint64_t>(d), T}, ys[1] = {static_cast<uint64_t>(d) * 2};
  const uint32_t ybox[2] = {BN, BT};
  bool ok = hopper::encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qd, qs, qbox,
                           CU_TENSOR_MAP_SWIZZLE_NONE) &&
            hopper::encode(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, scale, sd, nullptr, sbox,
                           CU_TENSOR_MAP_SWIZZLE_NONE) &&
            hopper::encode(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, yd, ys, ybox,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (k) {
    ok = ok && hopper::encode(&tov, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1, ovals, od, nullptr, obox,
                              CU_TENSOR_MAP_SWIZZLE_NONE) &&
         hopper::encode(&toi, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, oidx, od, nullptr, obox,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    tov = ts;                                   // not read without outliers
    toi = ts;
  }
  if (!ok) return hopper::status(cudaErrorInvalidValue, 5);
  const int ntiles = (n_tokens + BT - 1) / BT;
  const Params prm{static_cast<const float*>(scale), static_cast<const bf16*>(ovals),
                   static_cast<const int32_t*>(oidx), n_tokens, h, d, k, warpgroups, stages,
                   out_buffers, ntiles};
  const dim3 grid(ntiles < sms ? ntiles : sms), block(128 * warpgroups);
  auto kern = h == 128 ? (k ? aaq_matmul_wg_kernel<true, 1> : aaq_matmul_wg_kernel<false, 1>)
                       : (k ? aaq_matmul_wg_kernel<true, 0> : aaq_matmul_wg_kernel<false, 0>);
  kern<<<grid, block, bytes, stream>>>(tq, ts, tov, toi, ty, w, prm);
  return hopper::status(cudaGetLastError(), 4);
}

}  // namespace mmwg

// ---------------------------------------------------------------------------
// Split-W variant: float32 W on the bf16 tensor cores (three exact parts),
// and every bf16 call the other two variants do not take (any H)
// ---------------------------------------------------------------------------
namespace mmsp {

constexpr int BT = 128, BD = 64, THREADS = 256;
constexpr int KP = 128;                     // H columns a panel
constexpr int WS = BD + 8;                  // W panel row stride (bf16): ldmatrix rows on
                                            // distinct banks
constexpr int WT = 4, WD = 2;               // warps along tokens, along columns
constexpr int MT = BT / WT / 16;            // m16 tiles a warp
constexpr int NT = BD / WD / 8;             // n8 tiles a warp
constexpr int SMEM_LIMIT = 232448;

// One panel's q bytes a token, padded by 16 (the A words of rows g and
// words c on distinct banks); one q stage with the epilogue's per-token
// operands after it (sigma [BT] f32, oidx [BT][kk] int32, ovals [BT][kk]
// bf16, kk <= 4); one W panel of NP parts.
constexpr int META = BT * 4 + BT * 4 * 4 + BT * 4 * 2;
__host__ __device__ constexpr int q_stride(int bits) { return KP * bits / 8 + 16; }
__host__ __device__ constexpr int q_stage(int bits) { return BT * q_stride(bits) + META; }
__host__ __device__ constexpr int w_panel(int np) { return np * KP * WS * 2; }
// Resident: every W panel once, then two q stages.  Streaming: two stages
// of a q panel and its W panel.
__host__ __device__ inline int smem_bytes(int bits, int np, int panels, bool resident) {
  return resident ? panels * w_panel(np) + 2 * q_stage(bits)
                  : 2 * (q_stage(bits) + w_panel(np));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// W's values at p and, where `two`, p + 1: one 8-byte (float) or 4-byte
// (bf16) load where `pair` says such loads are aligned.
__device__ __forceinline__ void load_pair(const float* p, bool two, int pair, float (&v)[2]) {
  if (two && pair) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = p[0];
    v[1] = two ? p[1] : 0.f;
  }
}
__device__ __forceinline__ void load_pair(const bf16* p, bool two, int pair, float (&v)[2]) {
  if (two && pair) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __bfloat162float(p[0]);
    v[1] = two ? __bfloat162float(p[1]) : 0.f;
  }
}
__device__ __forceinline__ void put(float* y, float v) { *y = v; }
__device__ __forceinline__ void put(bf16* y, float v) { *y = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* y, float a, float b) {
  *reinterpret_cast<unsigned*>(y) = hopper::pack_bf16(a, b);
}

// W's value x as NP bf16 parts that sum to it exactly: NP = 1 a bf16 W
// value itself; NP = 3 a float32 one, x1 = bf16(x), x2 = bf16(x - x1),
// x3 = x - x1 - x2 (each difference exact in float32; x3 keeps the last 8
// of x's 24 significant bits, so it is exact in bf16 too).  Every product
// of an inlier (exact in bf16) by a part is exact in the float32 sum.
template <int NP> __device__ __forceinline__ void w_parts(float x, bf16 (&p)[NP]) {
  p[0] = __float2bfloat16_rn(x);
  if constexpr (NP == 3) {
    const float r1 = x - __bfloat162float(p[0]);
    p[1] = __float2bfloat16_rn(r1);
    p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
  }
}

// The W panel of H columns [p0, p0 + KP) and output columns [d0, d0 + BD):
// row L holds W row phys_row(p0 + L) (the A words' k order), NP parts
// [NP][KP][WS], zero past H or D; staged through registers.
template <int BITS, int NP, typename TW>
__device__ __forceinline__ void stage_w(bf16* dst, const TW* __restrict__ w, int h, int d,
                                        int p0, int d0, int tid) {
  for (int e = tid; e < KP * BD; e += THREADS) {
    const int L = e / BD, col = e % BD;
    const int row = phys_row<BITS>(p0 + L), dg = d0 + col;
    bf16 parts[NP];
    w_parts<NP>(row < h && dg < d ? to_f(w[static_cast<int64_t>(row) * d + dg]) : 0.f, parts);
#pragma unroll
    for (int i = 0; i < NP; ++i) dst[(i * KP + L) * WS + col] = parts[i];
  }
}

// Panel p of the q rows of tokens [t0, t0 + BT) into [BT][q_stride] bytes,
// zero past the row or the last token: cp.async of 16 bytes where every
// row starts 16-byte aligned (qvec 16), of 4 where every row starts 4-byte
// aligned (qvec 4), else byte by byte (visible after the block's next
// barrier either way).
template <int BITS>
__device__ __forceinline__ void stage_q(unsigned char* dst, const int8_t* __restrict__ q,
                                        int rowb, int64_t t0, int n_tokens, int p, int qvec,
                                        int tid) {
  constexpr int PB = KP * BITS / 8, QS = q_stride(BITS);
  const int b0 = p * PB, nb = min(PB, rowb - b0);
  if (qvec == 16) {
    for (int e = tid; e < BT * (PB / 16); e += THREADS) {
      const int r = e / (PB / 16), ch = 16 * (e % (PB / 16));
      const bool in = t0 + r < n_tokens && ch < nb;
      hopper::cp_async16(dst + r * QS + ch, in ? q + (t0 + r) * rowb + b0 + ch : q, in ? 16 : 0);
    }
  } else if (qvec == 4) {
    for (int e = tid; e < BT * (PB / 4); e += THREADS) {
      const int r = e / (PB / 4), ch = 4 * (e % (PB / 4));
      const bool in = t0 + r < n_tokens && ch < nb;
      hopper::cp_async4(dst + r * QS + ch, in ? q + (t0 + r) * rowb + b0 + ch : q, in ? 4 : 0);
    }
  } else {
    for (int e = tid; e < BT * PB; e += THREADS) {
      const int r = e / PB, ch = e % PB;
      dst[r * QS + ch] = t0 + r < n_tokens && ch < nb ? q[(t0 + r) * rowb + b0 + ch] : 0;
    }
  }
}

// Bytes [off, off + n) of a `total`-byte array into dst, cp.async 4 bytes
// at a time, zero past its end (src and off 4-byte aligned, n a multiple of
// 4).
__device__ __forceinline__ void stage_words(unsigned char* dst, const void* src, int64_t off,
                                            int64_t total, int n, int tid) {
  for (int i = tid * 4; i < n; i += THREADS * 4) {
    const int64_t left = total - (off + i);
    const int valid = left <= 0 ? 0 : (left >= 4 ? 4 : static_cast<int>(left));
    hopper::cp_async4(dst + i, valid ? static_cast<const unsigned char*>(src) + off + i : src,
                      valid);
  }
}

// A persistent block walks 128-token tiles of one 64-column tile of y; a
// tile's H in 128-column panels, each a ring step (q's panel, and W's where
// W does not stay resident).  The products: mma.sync m16n8k16, the A
// fragments widened from q's words in registers (the tensor-core kernel's
// layout), B by ldmatrix.trans from each W part, all into one float32
// accumulator, parts in order.  Epilogue: times sigma, plus the outlier
// term ovals * W[oidx] in float32 from W itself, written from registers.
template <int BITS, int NP, typename TW>
__global__ void __launch_bounds__(THREADS)
aaq_matmul_split_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                        const bf16* __restrict__ ovals, const int32_t* __restrict__ oidx,
                        const TW* __restrict__ w, TW* __restrict__ y, int n_tokens, int h,
                        int d, int k, int kk, int resident, int qvec, int ovec, int wpair) {
  constexpr int KB = BITS == 4 ? 32 : 16;           // k columns a q word
  constexpr int STEPS = KB / 16;                    // k steps a q word
  constexpr int QS = q_stride(BITS), QSTAGE = q_stage(BITS), WP = w_panel(NP);
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowb = BITS == 4 ? (h + 1) / 2 : h;
  const int panels = (h + KP - 1) / KP;
  bf16* wres = reinterpret_cast<bf16*>(smem);                    // resident W panels
  unsigned char* ring = resident ? smem + panels * WP : smem;
  const int stage_bytes = resident ? QSTAGE : QSTAGE + WP;
  constexpr int QBYTES = BT * QS;                   // a stage's q panel; its META follows

  const int d0 = blockIdx.y * BD;
  const int ntiles = (n_tokens + BT - 1) / BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, mat = lane >> 3, r8 = lane & 7;
  const int wm0 = (warp / WD) * (BT / WT), wn0 = (warp % WD) * (BD / WD);

  if (resident)
    for (int p = 0; p < panels; ++p)
      stage_w<BITS, NP>(wres + p * (WP / 2), w, h, d, p * KP, d0, tid);
  // ring step s: tile blockIdx.x + (s / panels) gridDim.x, panel s % panels
  auto issue = [&](int s, int st) {
    const int tile = blockIdx.x + (s / panels) * static_cast<int>(gridDim.x), p = s % panels;
    unsigned char* dst = ring + st * stage_bytes;
    const int64_t t0 = static_cast<int64_t>(tile) * BT;
    stage_q<BITS>(dst, q, rowb, t0, n_tokens, p, qvec, tid);
    if (p == panels - 1) {                  // the tile's sigma and outliers ride with its last
      unsigned char* meta = dst + QBYTES;   // panel, into the epilogue of that step
      stage_words(meta, scale, t0 * 4, static_cast<int64_t>(n_tokens) * 4, BT * 4, tid);
      if (k > 0) {
        stage_words(meta + BT * 4, oidx, t0 * kk * 4, static_cast<int64_t>(n_tokens) * kk * 4,
                    BT * kk * 4, tid);
        unsigned char* ov = meta + BT * 4 + BT * 4 * 4;
        if (ovec) {
          stage_words(ov, ovals, t0 * kk * 2, static_cast<int64_t>(n_tokens) * kk * 2,
                      BT * kk * 2, tid);
        } else {
          for (int i = tid; i < BT * kk; i += THREADS)
            reinterpret_cast<bf16*>(ov)[i] = t0 * kk + i < static_cast<int64_t>(n_tokens) * kk
                                                 ? ovals[t0 * kk + i] : __float2bfloat16(0.f);
        }
      }
    }
    if (!resident)
      stage_w<BITS, NP>(reinterpret_cast<bf16*>(dst + QSTAGE), w, h, d, p * KP, d0, tid);
  };
  const int tiles = static_cast<int>(blockIdx.x) < ntiles
                        ? (ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nsteps = tiles * panels;
  if (nsteps > 0) issue(0, 0);
  hopper::cp_async_commit();

  float acc[MT][NT][4];
  for (int s = 0; s < nsteps; ++s) {
    const int st = s & 1, p = s % panels;
    hopper::cp_async_wait<0>();
    __syncthreads();                        // this step's q (and W) visible; the other
                                            // stage no longer read
    if (s + 1 < nsteps) issue(s + 1, st ^ 1);
    hopper::cp_async_commit();
    if (p == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
    const unsigned char* qt = ring + st * stage_bytes;
    const bf16* ws = resident ? wres + p * (WP / 2) : reinterpret_cast<const bf16*>(qt + QSTAGE);
#pragma unroll
    for (int kb = 0; kb < KP; kb += KB) {
      unsigned word[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          word[mi][hr] = *reinterpret_cast<const unsigned*>(
              qt + (wm0 + 16 * mi + g + 8 * hr) * QS + kb * BITS / 8 + 4 * c);
#pragma unroll
      for (int s2 = 0; s2 < STEPS; ++s2) {
        unsigned a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          a[mi][0] = widen<BITS>(word[mi][0], s2, 0);
          a[mi][1] = widen<BITS>(word[mi][1], s2, 0);
          a[mi][2] = widen<BITS>(word[mi][0], s2, 1);
          a[mi][3] = widen<BITS>(word[mi][1], s2, 1);
        }
        const int k0 = kb + 16 * s2;
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int nj = 0; nj < NT; nj += 2) {
            unsigned b[4];
            hopper::ldsm_x4_trans(b, ws + (i * KP + k0 + r8 + 8 * (mat & 1)) * WS + wn0 +
                                         8 * (nj + (mat >> 1)));
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              hopper::mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
              hopper::mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
            }
          }
      }
    }
    if (p != panels - 1) continue;

    // epilogue: sigma, the outlier term in float32 (W's rows gathered from
    // device memory, where W is exact), y from registers
    const int64_t t0 =
        static_cast<int64_t>(blockIdx.x + (s / panels) * static_cast<int>(gridDim.x)) * BT;
    const float* st_scale = reinterpret_cast<const float*>(qt + QBYTES);
    const int32_t* st_oidx = reinterpret_cast<const int32_t*>(st_scale + BT);
    const bf16* st_ovals = reinterpret_cast<const bf16*>(st_oidx + BT * 4);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm0 + 16 * mi + g + 8 * hr;
        const int64_t t = t0 + r;
        if (t >= n_tokens) continue;
        const float sig = st_scale[r];
        float ov[4] = {0.f, 0.f, 0.f, 0.f};
        const TW* orow[4] = {w, w, w, w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < k) {
            ov[j] = __bfloat162float(st_ovals[r * kk + j]);
            orow[j] = w + static_cast<int64_t>(st_oidx[r * kk + j]) * d;
          }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = d0 + wn0 + 8 * ni + 2 * c;
          if (col >= d) continue;
          const bool two = col + 1 < d;
          float v0 = acc[mi][ni][2 * hr] * sig, v1 = acc[mi][ni][2 * hr + 1] * sig;
          float wv[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < k) load_pair(orow[j] + col, two, wpair, wv[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < k) {
              v0 = fmaf(ov[j], wv[j][0], v0);
              v1 = fmaf(ov[j], wv[j][1], v1);
            }
          TW* dst = y + t * d + col;
          if (two && d % 2 == 0) {
            put2(dst, v0, v1);
          } else {
            put(dst, v0);
            if (two) put(dst + 1, v1);
          }
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
}

template <int BITS, int NP, typename TW>
int launch(const int8_t* q, const float* scale, const bf16* ovals, const int32_t* oidx,
           const TW* w, TW* y, int n_tokens, int h, int d, int k, int kk, cudaStream_t stream) {
  const int panels = (h + KP - 1) / KP;
  const int resident = smem_bytes(BITS, NP, panels, true) <= SMEM_LIMIT;
  const int bytes = smem_bytes(BITS, NP, panels, resident);
  auto kern = aaq_matmul_split_kernel<BITS, NP, TW>;
  // per instantiation: the shared-memory size last sized and its occupancy
  static int set_bytes = -1, per_sm = 0, sms = 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return hopper::status(err, 2);
    attr = true;
  }
  if (bytes != set_bytes) {
    int dev = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return hopper::status(err, 1);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, bytes);
    if (err != cudaSuccess || per_sm < 1)
      return hopper::status(err != cudaSuccess ? err : cudaErrorInvalidConfiguration, 3);
    set_bytes = bytes;
  }
  const int dtiles = (d + BD - 1) / BD;
  const int ntiles = (n_tokens + BT - 1) / BT;
  const int walkers = (per_sm * sms + dtiles - 1) / dtiles;
  if (dtiles > 65535) return hopper::status(cudaErrorInvalidValue, 3);
  const dim3 grid(ntiles < walkers ? ntiles : walkers, dtiles);
  const int rowb = BITS == 4 ? (h + 1) / 2 : h;
  const uintptr_t at = reinterpret_cast<uintptr_t>(q) | static_cast<uintptr_t>(rowb);
  const int qvec = at % 16 == 0 ? 16 : at % 4 == 0 ? 4 : 1;
  const int ovec = reinterpret_cast<uintptr_t>(ovals) % 4 == 0;
  const int wpair = d % 2 == 0 && reinterpret_cast<uintptr_t>(w) % (2 * sizeof(TW)) == 0;
  kern<<<grid, THREADS, bytes, stream>>>(q, scale, ovals, oidx, w, y, n_tokens, h, d, k, kk,
                                         resident, qvec, ovec, wpair);
  return hopper::status(cudaGetLastError(), 4);
}

template <int NP, typename TW>
int launch_bits(const void* q, const void* scale, const void* ovals, const void* oidx,
                const void* w, void* y, int n_tokens, int h, int d, int bits, int k, int kk,
                void* stream) {
  if (n_tokens == 0 || d == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (h <= 0 || d < 0 || k < 0 || k > 4 || kk < (k > 0 ? k : 1) || (bits != 4 && bits != 8))
    return hopper::status(cudaErrorInvalidValue, 1);
  auto* qp = static_cast<const int8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<const bf16*>(ovals);
  auto* ip = static_cast<const int32_t*>(oidx);
  auto* wp = static_cast<const TW*>(w);
  auto* yp = static_cast<TW*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  return bits == 4 ? launch<4, NP, TW>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s)
                   : launch<8, NP, TW>(qp, sp, op, ip, wp, yp, n_tokens, h, d, k, kk, s);
}

}  // namespace mmsp

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

// As aaq_matmul_launch at bits 4, on the Hopper kernel: H a multiple of 128
// up to 512, D a multiple of 64, k <= 4, and the block's warpgroups (1-4),
// ring stages (a multiple of the warpgroups) and staged output chunks a warpgroup
// (`out_buffers`, 1 or 2) that the wrapper's plan fits into the block's
// shared memory.
extern "C" int aaq_matmul_wg_launch(const void* q, const void* scale, const void* ovals,
                                    const void* oidx, const void* w, void* y, int n_tokens,
                                    int h, int d, int k, int warpgroups, int stages,
                                    int out_buffers, void* stream) {
  if (n_tokens == 0 || d == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  return mmwg::launch(q, scale, ovals, oidx, static_cast<const bf16*>(w), y, n_tokens, h, d, k,
                      warpgroups, stages, out_buffers, static_cast<cudaStream_t>(stream));
}

// As aaq_matmul_launch with w (H, D) and y (T, D) float32, any H and D,
// rows of q at any byte alignment: the split-W kernel, three bf16 parts.
extern "C" int aaq_matmul_f32_launch(const void* q, const void* scale, const void* ovals,
                                     const void* oidx, const void* w, void* y, int n_tokens,
                                     int h, int d, int bits, int k, int kk, void* stream) {
  return mmsp::launch_bits<3, float>(q, scale, ovals, oidx, w, y, n_tokens, h, d, bits, k, kk,
                                     stream);
}

// As aaq_matmul_launch (bf16 w and y) at any H and D, rows of q at any byte
// alignment: the split-W kernel with W as its one part (the calls neither
// other bf16 variant takes: H above 512, or not a multiple of 32 at bits 4
// or of 16 at bits 8).
extern "C" int aaq_matmul_wide_launch(const void* q, const void* scale, const void* ovals,
                                      const void* oidx, const void* w, void* y, int n_tokens,
                                      int h, int d, int bits, int k, int kk, void* stream) {
  return mmsp::launch_bits<1, bf16>(q, scale, ovals, oidx, w, y, n_tokens, h, d, bits, k, kk,
                                    stream);
}
