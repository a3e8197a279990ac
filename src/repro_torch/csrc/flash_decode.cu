// Decode attention: one query row a slot against a KV ring, split over keys.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py: flash_mha_pallas (body
// _flash_kernel) at its decode calls: q (B, 1, Hq, D) bf16, k, v (B, W, Hkv,
// D) bf16 (a ring, any (b, s, h) strides), kv_valid_len (B,) or none, no
// bias, causal or window mask (the wrapper's variant_for sends only those
// here).  The same function as the other variants: masked keys get
// probability exactly 0, the (m, l, o) state is float32, a slot with no
// valid key returns 0, and the output is o / max(l, 1e-30) in bf16.
//
// Bound on the H100: bytes.  A step reads each valid ring row of K and V
// once (qwen1.5-0.5b: 529 rows x 16 heads x 64 x 4 bytes, 0.65 us at 3.35
// TB/s) and does ~1 operation a byte; what costs is latency and spreading
// those bytes over enough SMs.  The tensor-core kernel this replaces gave a
// slot's query row a 64-row tile (63 rows padding), walked the whole ring
// in one block, and read every K/V byte once for each query head of a GQA
// group.  The design:
//   - Rows: a block holds all G = Hq / Hkv query heads of one KV head (up to
//     16: mma.sync's M; more go to further head groups), so each K/V byte
//     of a head group is read once.  At G = 1 15 rows are padding, which
//     costs tensor work, not bytes.
//   - Splits: a slot's keys are cut into splits of a fixed number of keys,
//     `split`, chosen from the ring length W and the head counts alone (the
//     wrapper's dec_plan: the smallest multiple of 64 that makes at most 8
//     splits, at least 128 where a slot has 8 or more head blocks), never
//     from B or the other slots' lengths, so a slot launched alone computes
//     exactly what it computes in a batch.  A split past the slot's
//     kv_valid_len loads nothing.
//   - A block takes one split: 4 warps, K/V tiles of 64 keys through a
//     two-stage cp.async ring, warp w the keys 16w..16w+15 of each tile
//     (S = Q K^T and O += (P_hi + P_lo) V with mma.sync m16n8k16, the
//     tensor-core kernel's fragments), its own (m, l, o) in registers.
//   - Merge, in a fixed order and without atomics: the 4 warps' states in
//     shared memory (warp 0..3), then the slot's splits, which are one
//     thread-block cluster (cluster rank = split): after a cluster barrier
//     each block merges a share of the output columns, reading every
//     split's (m, l, o) from the others' shared memory (split 0..C-1), and
//     a second barrier keeps that memory alive until all have read.  One
//     launch, so a CUDA graph step keeps one node.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

namespace dec {

constexpr int NW = 4;               // warps a block
constexpr int BK = 16 * NW;         // keys a tile: 16 a warp
constexpr int ROWS = 16;            // query heads a block (mma's M)
constexpr int MAX_CLUSTER = 8;      // splits of a slot: the portable cluster size
static_assert(NW <= MAX_CLUSTER, "the warps' merge weights share the splits' array");

struct Params {
  const bf16* q; const bf16* k; const bf16* v; const int32_t* kvlen; bf16* o;
  int Skv, Hq, G, HG;               // G = Hq / Hkv query heads a KV head, HG groups of 16
  int split;                        // keys a block
  int64_t qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float cs;                         // softmax scale * log2(e)
};

template <int D> __host__ __device__ constexpr int row_stride() { return D + 8; }
// stages of the K/V ring (four gained nothing at a 1,500-key split of
// three tiles: the tiles of a split are few, and the latency is the loads')
constexpr int NST = 2;
// Q rows, then the ring's stages of a K and a V tile (bf16, rows padded by 8
// so that ldmatrix's 8 rows hit distinct banks); after the key loop the
// ring holds the merge's float32 partials
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return (ROWS + 2 * NST * BK) * row_stride<D>() * 2;
}

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_dec_kernel(const Params p) {
  constexpr int DS = row_stride<D>();
  constexpr int CPR = D / 8;                     // 16-byte chunks a row
  constexpr int TILE = BK * DS;                  // elements of one K or V tile
  constexpr bool Q_IN_REGS = D <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);      // [ROWS][DS]
  bf16* ring = qs + ROWS * DS;                   // [NST][K, V][BK][DS]
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x;                  // the block's rank in its cluster
  const int nsplit = gridDim.x;
  const int hk = blockIdx.y / p.HG, hg = blockIdx.y % p.HG;
  const int b = blockIdx.z;
  const int h0 = hk * p.G + hg * ROWS;
  const int nrows = min(ROWS, p.G - hg * ROWS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, mat = lane >> 3, r8 = lane & 7;

  int kv_end = p.Skv;
  if (p.kvlen) kv_end = min(kv_end, max(p.kvlen[b], 0));
  const int k_begin = split * p.split;
  const int k_stop = min(kv_end, k_begin + p.split);

  for (int e = tid; e < ROWS * CPR; e += NW * 32) {
    const int r = e / CPR, ch = e % CPR;
    const bool in = r < nrows;
    const bf16* src = in ? p.q + b * p.qsb + (h0 + r) * p.qsh + ch * 8 : p.q;
    hopper::cp_async16(qs + r * DS + ch * 8, src, in ? 16 : 0);
  }
  auto issue = [&](int k0, int st) {
    bf16* ks = ring + st * 2 * TILE;
    bf16* vs = ks + TILE;
    for (int e = tid; e < BK * CPR; e += NW * 32) {
      const int j = e / CPR, ch = e % CPR, kpos = k0 + j;
      const bool in = kpos < k_stop;
      const bf16* ksrc = in ? p.k + b * p.ksb + kpos * p.kss + hk * p.ksh + ch * 8 : p.k;
      const bf16* vsrc = in ? p.v + b * p.vsb + kpos * p.vss + hk * p.vsh + ch * 8 : p.v;
      hopper::cp_async16(ks + j * DS + ch * 8, ksrc, in ? 16 : 0);
      hopper::cp_async16(vs + j * DS + ch * 8, vsrc, in ? 16 : 0);
    }
  };

  // online softmax in the log2 domain: x = s * scale * log2(e), p = 2^(x - m)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;
  unsigned qa[Q_IN_REGS ? D / 16 : 1][4];
  const bf16* qw = qs + (lane & 15) * DS + 8 * (lane >> 4);

  // the first NST - 1 tiles in flight (Q with the first), then one more
  // each tile: a copy group a tile, empty past the split's end
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (k_begin + i * BK < k_stop) issue(k_begin + i * BK, i);
    hopper::cp_async_commit();
  }
  int it = 0;
  for (int k0 = k_begin; k0 < k_stop; k0 += BK, ++it) {
    const int st = it % NST;
    hopper::cp_async_wait<NST - 2>();
    __syncthreads();                             // this tile (and Q) visible; the stage
                                                 // refilled next is no longer read
    const int knext = k0 + (NST - 1) * BK;
    if (knext < k_stop) issue(knext, (it + NST - 1) % NST);
    hopper::cp_async_commit();
    if constexpr (Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) hopper::ldsm_x4(qa[kk], qw + kk * 16);
      }
    }
    const int kw0 = k0 + 16 * warp;              // this warp's 16 keys
    const bf16* ks = ring + st * 2 * TILE + 16 * warp * DS;
    const bf16* vs = ks + TILE;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const unsigned(&qf)[4] = qa[Q_IN_REGS ? kk : 0];
      if constexpr (!Q_IN_REGS) hopper::ldsm_x4(qa[0], qw + kk * 16);
      unsigned bk[4];
      hopper::ldsm_x4(bk, ks + (8 * (mat >> 1) + r8) * DS + kk * 16 + 8 * (mat & 1));
      hopper::mma_bf16(s[0], qf, bk[0], bk[1]);
      hopper::mma_bf16(s[1], qf, bk[2], bk[3]);
    }
    // keys past this split's end (the slot's length, the split, the ring)
    // are masked; every row of the block attends to the same keys
    const bool full = kw0 + 16 <= k_stop;
    unsigned good = 0xffu;
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[ni][e] * p.cs;
        if (!full && kw0 + ni * 8 + 2 * c + (e & 1) >= k_stop) {
          good &= ~(1u << (ni * 4 + e));
          x = NEG;
        }
        s[ni][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = hopper::ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (good >> (ni * 4 + e)) & 1u ? hopper::ex2(s[ni][e] - m[e >> 1]) : 0.f;
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
    // O += (P_hi + P_lo) V over the warp's 16 keys
    unsigned ahi[4], alo[4];
    hopper::split_bf16(s[0][0], s[0][1], ahi[0], alo[0]);
    hopper::split_bf16(s[0][2], s[0][3], ahi[1], alo[1]);
    hopper::split_bf16(s[1][0], s[1][1], ahi[2], alo[2]);
    hopper::split_bf16(s[1][2], s[1][3], ahi[3], alo[3]);
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      unsigned bv[4];
      hopper::ldsm_x4_trans(bv, vs + (r8 + 8 * (mat & 1)) * DS + dn * 8 + 8 * (mat >> 1));
      hopper::mma_bf16(o[dn], ahi, bv[0], bv[1]);
      hopper::mma_bf16(o[dn], alo, bv[0], bv[1]);
      hopper::mma_bf16(o[dn + 1], ahi, bv[2], bv[3]);
      hopper::mma_bf16(o[dn + 1], alo, bv[2], bv[3]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // the warps' states: m and l by row, o by (row, column), in float32
  float* pm = reinterpret_cast<float*>(ring);    // [NW][ROWS]
  float* pl = pm + NW * ROWS;                    // [NW][ROWS]
  float* po = pl + NW * ROWS;                    // [NW][ROWS][D]; the block's in [0]
  float* bm = po + NW * ROWS * D;                // [ROWS]: the block's m, then l
  float* bl = bm + ROWS;
  float* gw = bl + ROWS;                         // [MAX_CLUSTER][ROWS]: each warp's, then
                                                 // each split's weight
  float* gd = gw + MAX_CLUSTER * ROWS;           // [ROWS]: max(l, 1e-30) of the slot
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (c == 0) {
    pm[warp * ROWS + g] = m[0];
    pm[warp * ROWS + g + 8] = m[1];
    pl[warp * ROWS + g] = l[0];
    pl[warp * ROWS + g + 8] = l[1];
  }
  float* pw = po + warp * ROWS * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<float2*>(pw + g * D + dn * 8 + 2 * c) = make_float2(o[dn][0], o[dn][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * D + dn * 8 + 2 * c) =
        make_float2(o[dn][2], o[dn][3]);
  }
  __syncthreads();
  // the block's state: per row each warp's weight (in gw until the merge
  // across splits needs it), then the warps 0..3 in order, each element by
  // one thread
  if (tid < ROWS) {
    float mx = pm[tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, pm[w * ROWS + tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float ww = hopper::ex2(pm[w * ROWS + tid] - mx);
      gw[w * ROWS + tid] = ww;
      ls += pl[w * ROWS + tid] * ww;
    }
    bm[tid] = mx;
    bl[tid] = ls;
  }
  __syncthreads();
  for (int e = tid; e < ROWS * D; e += NW * 32) {
    const int r = e / D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) acc += po[w * ROWS * D + e] * gw[w * ROWS + r];
    po[e] = acc;
  }
  cluster.sync();                                // every split's state is ready

  // the slot's splits 0..C-1: per row, each split's weight and the sum's
  // denominator, then a share of the (row, column pair) outputs a block.
  // Every remote read of a row or an element is issued before any is used
  // (unrolled over the most splits): a read of another block's shared
  // memory takes hundreds of cycles, and a chain of them made the merge
  // most of a short launch
  if (tid < ROWS) {
    float ms[MAX_CLUSTER], ls[MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      ms[j] = j < nsplit ? *cluster.map_shared_rank(bm + tid, j) : NEG;
      ls[j] = j < nsplit ? *cluster.map_shared_rank(bl + tid, j) : 0.f;
    }
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) mx = fmaxf(mx, ms[j]);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      const float wj = hopper::ex2(ms[j] - mx);
      gw[j * ROWS + tid] = wj;
      den += ls[j] * wj;
    }
    gd[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int e = split * NW * 32 + tid; e < nrows * (D / 2); e += nsplit * NW * 32) {
    const int r = e / (D / 2), col = 2 * (e % (D / 2));
    float2 v[MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      v[j] = j < nsplit ? *reinterpret_cast<const float2*>(
                              cluster.map_shared_rank(po + r * D + col, j))
                        : make_float2(0.f, 0.f);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      const float wj = gw[j * ROWS + r];
      acc.x += v[j].x * wj;
      acc.y += v[j].y * wj;
    }
    const float den = gd[r];
    *reinterpret_cast<unsigned*>(p.o + ((int64_t)b * p.Hq + h0 + r) * D + col) =
        hopper::pack_bf16(acc.x / den, acc.y / den);
  }
  cluster.sync();                                // no block leaves while others read it
}

template <int D>
int launch(const Params& p, int B, int Hkv, int nsplit, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<D>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dec_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return hopper::status(err, 2);
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nsplit), static_cast<unsigned>(Hkv * p.HG),
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr_cluster[1];
  attr_cluster[0].id = cudaLaunchAttributeClusterDimension;
  attr_cluster[0].val.clusterDim.x = static_cast<unsigned>(nsplit);
  attr_cluster[0].val.clusterDim.y = 1;
  attr_cluster[0].val.clusterDim.z = 1;
  cfg.attrs = attr_cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_dec_kernel<D>, p);
  if (err != cudaSuccess) return hopper::status(err, 4);
  return hopper::status(cudaGetLastError(), 4);
}

}  // namespace dec
}  // namespace

// flash_mha_dec_launch: bf16 q (B, 1, Hq, D), k, v (B, Skv, Hkv, D), D in
// {64, 96, 128, 192, 256}, no bias (bias_kind 0), no causal or window mask;
// strides in elements, the head dim of q, k, v with unit stride, every base
// pointer and (b, s, h) stride 16-byte aligned; o a contiguous (B, 1, Hq, D)
// bf16 tensor; kvlen null or (B,) int32.  `split` keys a block (a multiple
// of 64) and `nsplit` = ceil(Skv / split) blocks a slot, 1..8, from the
// wrapper's dec_plan.  Returns the launch status (hopper::status).
extern "C" int flash_mha_dec_launch(const void* q, const void* k, const void* v,
                                    const void* bias, const void* kvlen, void* o,
                                    int qkv_is_bf16, int bias_kind, int B, int Sq, int Skv,
                                    int Hq, int Hkv, int D, int Bb, int64_t qsb, int64_t qss,
                                    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                                    int64_t vsb, int64_t vss, int64_t vsh, int64_t bsb,
                                    int64_t bsh, int64_t bsq, int64_t bsk, int causal,
                                    int window, float scale, int split, int nsplit,
                                    void* stream) {
  (void)qss; (void)Bb; (void)bsb; (void)bsh; (void)bsq; (void)bsk;
  if (B == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!qkv_is_bf16 || bias || bias_kind || Sq != 1 || causal || window >= 0 || Hkv <= 0 ||
      Hq % Hkv || split <= 0 || split % dec::BK || nsplit > dec::MAX_CLUSTER ||
      nsplit != (Skv > 0 ? (Skv + split - 1) / split : 1) || B > 65535)
    return hopper::status(cudaErrorInvalidValue, 1);
  const int G = Hq / Hkv, HG = (G + dec::ROWS - 1) / dec::ROWS;
  if (static_cast<int64_t>(Hkv) * HG > 65535) return hopper::status(cudaErrorInvalidValue, 3);
  const dec::Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<const int32_t*>(kvlen),
                      static_cast<bf16*>(o), Skv, Hq, G, HG, split, qsb, qsh, ksb, kss, ksh,
                      vsb, vss, vsh, scale * LOG2E};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return dec::launch<64>(p, B, Hkv, nsplit, s);
    case 96: return dec::launch<96>(p, B, Hkv, nsplit, s);
    case 128: return dec::launch<128>(p, B, Hkv, nsplit, s);
    case 192: return dec::launch<192>(p, B, Hkv, nsplit, s);
    case 256: return dec::launch<256>(p, B, Hkv, nsplit, s);
    default: return hopper::status(cudaErrorInvalidValue, 1);
  }
}
