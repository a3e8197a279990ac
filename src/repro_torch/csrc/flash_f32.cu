// Float32 attention on the tensor cores: two kernels, the float32 calls of
// the flash wrapper (kernels/flash_attention/flash_attention.py).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py: flash_mha_pallas (body
// _flash_kernel) at its float32 calls: q (B, Sq, Hq, D), k, v (B, Skv, Hkv,
// D) float32 with any (b, s, h) strides (the head dim unit-stride), an
// additive bias (Bb, Hq, Sq, Skv) in f32 or bf16 broadcast by block, GQA,
// causal, sliding window and kv_valid_len.  The same function as the bf16
// variants: masked logits get probability exactly 0, the (m, l, o) state is
// float32, a fully masked row returns 0, and o = o / max(l, 1e-30) in
// float32.
//
// The float32 rule: a float32 call stays float32.  TF32 alone keeps ~3
// decimal digits, so every product runs as three TF32 products of operands
// split into hi + lo (hopper.cuh: split_tf32), which keep
// float32's precision within ~2^-21 relative; P (in [0, 1]) is split the same
// way.  The split costs an integer add, an AND and a subtraction an operand,
// in registers, as each fragment is loaded.  mma.sync m16n8k8.tf32 and not
// wgmma: wgmma takes TF32 operands from shared memory only K-major, which
// V's (keys, D) tile is not, and a split operand in shared memory would need
// its lo part written there too; mma.sync takes fragments from registers,
// where both splits are free.  (The wgmma route, V transposed in shared
// memory, was not built; PERF.md's findings say so.)
//
// The fragments: with QK^T's k index c taken as head-dim column 2c and c + 4
// as 2c + 1, a thread's A and B fragments are pairs of adjacent floats (one
// 8-byte load of K a fragment); with PV's k index c taken as key 2c and
// c + 4 as key 2c + 1, the A fragment of P is the thread's own S accumulator
// (no shuffles) and V's B fragment two scalar loads.  Row strides of the Q
// and K tiles are 8 mod 16 floats, V's 4 mod 16: no bank conflicts.
//
// flash_f32_kernel (every float32 call but the decode's: more than one query
//   row, a bias, a causal or window mask; and every head dim above 256 but
//   a decode row's up to 320).
//   Bound on the H100: operations at the prefills (MLA's (2, 512, 16, 192)
//   causal: 3.2 GFLOP, three TF32 products a multiply-add), bytes at the
//   reduced fold's D = 8 and 16.
//   - A block: 64 or 128 query rows of one head and batch row (16 a warp)
//     and one panel of output columns; the query tiles of a causal call are
//     issued last tile first (they see the most keys).  The wrapper's
//     f32_plan chooses the instance (its columns, keys a tile and rows),
//     the panels and whether Q is staged in shared memory; the entry point
//     launches what the plan names and checks that it fits.
//   - Key tiles of 64 keys up to 64 columns, else 32 or 16, through a
//     two-stage cp.async ring, 16 bytes at a time where q, k and v and
//     their (b, s, h) strides are 16-byte aligned, else 4.  Tiles that the
//     causal, window or key-length mask hides from every row of the block
//     are never loaded; the masks run on a warp's tile only where it
//     crosses an edge.
//   - Q: in shared memory, loaded once, where it fits beside the tiles;
//     else (head dims far above 256) its fragments are read from device
//     memory (L1).  Up to head dim 320 one panel holds every output column.
//     The 320-column instance pairs its warps (o would take 160 registers a
//     thread: a 4-warp instance spilled): two warps share 16 query rows,
//     each computes the logits of half of a key tile and holds half of the
//     columns, and the pair swaps its logits through shared memory, so the
//     logits are computed once.  Above 320 QK^T sums over the whole head
//     dim and the output columns are cut into panels of at most 256, one
//     set of blocks each (every panel recomputes the logits: twice the
//     QK^T work at D = 512, which no caller has).  A warp whose 16 rows are
//     all past the last query row (a decode row, a short prefill) only
//     loads.
//   - The bias is read straight from device memory at each logit (any
//     layout, any strides), scaled by log2(e); the softmax is one ex2 a
//     logit in the log2 domain.
//
// flash_f32_dec_kernel (one query row, no bias, no causal or window mask,
//   D <= 320: every float32 decode step).  Bound on the H100: bytes
//   (recurrentgemma's step against a 2,048-row MQA ring reads ~8.5 MB of
//   float32 K and V, 2.5 us at 3.35 TB/s, and does ~5 operations a byte).
//   flash_decode.cu's design, in float32: a block holds the query heads of
//   one KV head (up to 16, mma's M; more take further head groups), so each
//   K/V byte is read once; a slot's keys are cut into the wrapper's dec_plan
//   splits (from the ring length and head counts only, never from B), one
//   thread-block cluster a slot, whose splits merge their (m, l, o) in a
//   fixed order through each other's shared memory.  K and V come 16 bytes
//   at a time (4 where unaligned) through a two-stage cp.async ring of
//   64-key tiles (32 above head dim 128), 16 (8) keys a warp.  Head dims up
//   to 320 (a 320-column instance, 160 accumulator registers a thread).
//   The products ride on the tensor cores with the split: at G = 1 15 of
//   the 16 rows are padding, which costs tensor work, not bytes.
//
// No atomics, and a block's arithmetic does not depend on which batch rows
// or slots share the launch: a row launched alone is bitwise its row of a
// batch, and two launches are bitwise equal.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;     // bytes a block may opt into

namespace f32a {

constexpr int NW = 4;                  // warps a block (flash_f32_dec_kernel; 4 or 8 in
                                       // flash_f32_kernel, 16 query rows each)
constexpr int DEC_ROWS = 16;           // query heads a block (flash_f32_dec_kernel)
constexpr int MAX_CLUSTER = 8;         // splits of a slot: the portable cluster size
constexpr int DEC_MAX_D = 320;         // head dims flash_f32_dec_kernel takes

struct Params {
  const float* q; const float* k; const float* v; const void* bias; const int32_t* kvlen;
  float* o;
  int bias_kind;                       // 0 none, 1 f32, 2 bf16
  int B, Sq, Skv, Hq, Hkv, Bb, D;
  int dv;                              // output columns a panel
  int nqt;                             // query tiles
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk;
  int causal, window;                  // window < 0: no sliding window
  float cs;                            // softmax scale * log2(e)
  int vec;                             // q, k, v read 16 bytes at a time (else 4)
  int q_smem;                          // flash_f32_kernel: Q staged in shared memory
  int split, G, HG;                    // decode: keys a block, heads a KV head, groups of 16
};

// Row strides in floats: Q and K 8 mod 16 (a quarter-warp's 8-byte loads of
// rows g and columns 2c hit distinct banks), V 4 mod 16 (rows 2c, columns g);
// both multiples of 4, so every row starts 16-byte aligned.
__host__ __device__ constexpr int qk_stride(int d) { return d % 16 ? d : d + 8; }
__host__ __device__ constexpr int v_stride(int dv) { return dv + 4; }

// The decode kernel's instance for head dim d: its columns (the zoo's head
// dims 96 and 192, the powers of two, and 320); a head dim narrower than its
// instance computes the instance's columns all the same (no branch splits
// the PV products' independent chains) and stores its own.
__host__ __device__ constexpr int dec_cols(int d) {
  return d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : d <= 192 ? 192 : d <= 256 ? 256 : 320;
}
// The general kernel's shared memory: Q's `rows` rows where Q is staged
// there, then the two-stage ring of K and V tiles (V rows as wide as the
// instance's columns), then, above 256 columns, the pairs' logits of a key
// tile.  The wrapper's f32_plan chooses the instance and
// layout; the launch only checks that they fit.
__host__ __device__ inline int smem_bytes(int d, int dvmax, int bk, int rows, bool q_smem) {
  return ((q_smem ? rows * qk_stride(d) : 0) + 2 * bk * (qk_stride(d) + v_stride(dvmax)) +
          (dvmax > 256 ? rows * bk : 0)) * 4;
}
__host__ __device__ inline int dec_smem_bytes(int d, int dmax, int bk) {
  return (DEC_ROWS * qk_stride(d) + 2 * bk * (qk_stride(d) + v_stride(dmax))) * 4;
}

// `rows` rows of `n` floats (row r at src + r * rs; rows from `valid` on
// zero) into shared rows of stride `ss`, as cp.async copies of 16 bytes
// (vec) or 4.  n is a multiple of 4.
template <int THREADS = NW * 32>
__device__ __forceinline__ void load_tile(float* dst, int ss, const float* src, int64_t rs,
                                          int rows, int valid, int n, int vec, int tid) {
  if (vec) {
    const int cpr = n / 4;
    for (int e = tid; e < rows * cpr; e += THREADS) {
      const int r = e / cpr, ch = e % cpr;
      const bool in = r < valid;
      hopper::cp_async16(dst + r * ss + ch * 4, in ? src + r * rs + ch * 4 : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * n; e += THREADS) {
      const int r = e / n, col = e % n;
      const bool in = r < valid;
      hopper::cp_async4(dst + r * ss + col, in ? src + r * rs + col : src, in ? 4 : 0);
    }
  }
}

// The A fragment of rows (r0, r1) at head-dim columns d0 + 2c, d0 + 2c + 1
// (r0, r1 already offset by 2c), split.
__device__ __forceinline__ void q_frag(const float* r0, const float* r1, int d0,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  hopper::split_tf32(r0[d0], hi[0], lo[0]);
  hopper::split_tf32(r1[d0], hi[1], lo[1]);
  hopper::split_tf32(r0[d0 + 1], hi[2], lo[2]);
  hopper::split_tf32(r1[d0 + 1], hi[3], lo[3]);
}

// s = Q K^T over the thread's NT n8 tiles of keys (kr: its key row, key g
// of the tile, at head-dim column 2c; the tiles 8 rows of stride qs apart),
// summed over nk k steps of 8 columns.  The hi*hi products and the cross
// terms go to separate accumulators, and with PAR = 2 (the callers' choice
// where NT <= 2 and the registers allow) also by the k step's parity: 2 NT
// (4 NT) independent chains of mma, where one chain of three dependent
// products a step would wait on the tensor core's latency.
template <int NT, int PAR>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const float* qrow0,
                                        const float* qrow1, const float* kr, int qs, int nk) {
  float hh[PAR][NT][4], cx[PAR][NT][4];
#pragma unroll
  for (int i = 0; i < PAR; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[i][j][e] = cx[i][j][e] = 0.f;
  auto step = [&](int kk, int par) {
    unsigned ahi[4], alo[4], bh[NT][2], bl[NT][2];
    q_frag(qrow0, qrow1, kk * 8, ahi, alo);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(kr + j * 8 * qs + kk * 8);
      hopper::split_tf32(kv.x, bh[j][0], bl[j][0]);
      hopper::split_tf32(kv.y, bh[j][1], bl[j][1]);
    }
    // each product across the n-tiles in turn: NT independent mma in a row
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::mma_tf32(cx[par][j], alo, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::mma_tf32(cx[par][j], ahi, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) hopper::mma_tf32(hh[par][j], ahi, bh[j][0], bh[j][1]);
  };
  int kk = 0;
  for (; kk + 1 < nk; kk += 2) {
    step(kk, 0);
    step(kk + 1, PAR - 1);
  }
  if (kk < nk) step(kk, 0);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int i = 0; i < PAR; ++i) {
        x += hh[i][j][e];
        y += cx[i][j][e];
      }
      s[j][e] = x + y;
    }
}

// P's A fragment of keys 8 kk.. from the S accumulator (k index c = key 2c,
// c + 4 = key 2c + 1), split.
__device__ __forceinline__ void p_frag(const float (&s)[4], unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  hopper::split_tf32(s[0], hi[0], lo[0]);
  hopper::split_tf32(s[2], hi[1], lo[1]);
  hopper::split_tf32(s[1], hi[2], lo[2]);
  hopper::split_tf32(s[3], hi[3], lo[3]);
}

// o += P V over 8 keys (P's split A fragment) and all NDN n8 tiles of
// columns: vr is V's row of key 2c at column g; the next row is key 2c + 1.
// Four tiles at a time, each of the three products across the four in
// turn, so the mma in a row are independent.
template <int NDN, int VS>
__device__ __forceinline__ void pv_keys(float (&o)[NDN][4], const unsigned (&ahi)[4],
                                        const unsigned (&alo)[4], const float* vr) {
  constexpr int CH = NDN < 4 ? NDN : 4;
  static_assert(NDN % CH == 0, "column tiles in groups of four");
#pragma unroll
  for (int d0 = 0; d0 < NDN; d0 += CH) {
    unsigned bh[CH][2], bl[CH][2];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      hopper::split_tf32(vr[(d0 + i) * 8], bh[i][0], bl[i][0]);
      hopper::split_tf32(vr[VS + (d0 + i) * 8], bh[i][1], bl[i][1]);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) hopper::mma_tf32(o[d0 + i], alo, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < CH; ++i) hopper::mma_tf32(o[d0 + i], ahi, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < CH; ++i) hopper::mma_tf32(o[d0 + i], ahi, bh[i][0], bh[i][1]);
  }
}

// The online softmax of one key tile for a thread's two rows (g and g + 8
// of its warp's 16): s holds x = logit * scale * log2(e) (+ bias * log2(e)),
// `good` a bit per element (0: masked, probability exactly 0).  On return s
// holds the probabilities, m and l (the thread's partial sum) are updated
// and alpha is each row's rescale of o.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], unsigned good, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mt[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i]);
    alpha[i] = hopper::ex2(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = (good >> (j * 4 + e)) & 1u ? hopper::ex2(s[j][e] - m[e >> 1]) : 0.f;
      s[j][e] = pv;
      rs[e >> 1] += pv;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
}

// ROWS query rows a block, 16 a warp.  Above 256 output columns (o would
// take 160 registers a thread and spill) the block's warps pair up: warps
// w and w + ROWS/16 share 16 query rows, each computes the logits of half
// of a key tile and holds half of the output columns, and the pair swaps
// its logits through shared memory, so the logits are computed once.
template <int DVMAX, int BK, int ROWS>
__global__ void __launch_bounds__(ROWS / 16 * (DVMAX > 256 ? 2 : 1) * 32)
flash_f32_kernel(const Params p) {
  constexpr bool PAIR = DVMAX > 256;
  constexpr int SIDES = PAIR ? 2 : 1;
  constexpr int RW = ROWS / 16;                  // warps of distinct rows
  constexpr int THREADS = RW * SIDES * 32;
  constexpr int NT = BK / 8;                     // n8 tiles of keys a tile
  constexpr int NTO = NT / SIDES;                // ... whose logits a warp computes
  constexpr int NDO = DVMAX / 8 / SIDES;         // n8 tiles of output columns a warp holds
  static_assert(NT * 4 <= 32 && NTO * SIDES == NT, "one mask bit an element; keys halve");
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, QS = qk_stride(D);
  constexpr int VS = v_stride(DVMAX);
  const bool q_smem = p.q_smem;
  float* qs = smem;                              // [ROWS][QS] where Q is staged
  float* ring = smem + (q_smem ? ROWS * QS : 0); // [2][K: BK][QS, V: BK][VS]
  const int stage = BK * (QS + VS);
  float* xs = ring + 2 * stage;                  // PAIR: [RW][16][BK], the pairs' logits
  const float NEG_INF = __int_as_float(static_cast<int>(0xff800000u));  // a pair's masked logit

  int bid = blockIdx.x;
  const int qt = p.nqt - 1 - bid % p.nqt;        // the last query tile first
  bid /= p.nqt;
  const int h = bid % p.Hq, b = bid / p.Hq;
  const int c0 = blockIdx.y * p.dv, ndv = min(p.dv, D - c0);
  const int hk = h / (p.Hq / p.Hkv), bb = b / (p.B / p.Bb);
  const int q0 = qt * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int rw = warp % RW, side = warp / RW;    // the warp's rows, its half (PAIR)
  const float* qg = p.q + b * p.qsb + h * p.qsh;
  const float* kg = p.k + b * p.ksb + hk * p.ksh;
  const float* vg = p.v + b * p.vsb + hk * p.vsh + c0;

  // the keys some row of the block sees: [k_begin, k_end), whole tiles
  int kv_end = p.Skv;
  if (p.kvlen) kv_end = min(kv_end, max(p.kvlen[b], 0));
  int k_end = kv_end;
  if (p.causal) k_end = min(k_end, min(p.Sq, q0 + ROWS));
  int k_begin = p.window >= 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = k_begin / BK * BK;

  if (q_smem)
    load_tile<THREADS>(qs, QS, qg + static_cast<int64_t>(q0) * p.qss, p.qss, ROWS, p.Sq - q0, D,
                       p.vec, tid);
  auto issue = [&](int k0, int st) {
    float* ks = ring + st * stage;
    load_tile<THREADS>(ks, QS, kg + static_cast<int64_t>(k0) * p.kss, p.kss, BK, k_end - k0, D,
                       p.vec, tid);
    load_tile<THREADS>(ks + BK * QS, VS, vg + static_cast<int64_t>(k0) * p.vss, p.vss, BK,
                       k_end - k0, ndv, p.vec, tid);
  };

  // the thread's rows: r0 = 16 rw + g and r0 + 8 of the tile
  const int r0 = rw * 16 + g;
  const int qa = q0 + r0, qb = qa + 8;           // their query positions
  const float* qrow0 = (q_smem ? qs + r0 * QS
                                : qg + static_cast<int64_t>(min(qa, p.Sq - 1)) * p.qss) + 2 * c;
  const float* qrow1 = (q_smem ? qs + (r0 + 8) * QS
                                : qg + static_cast<int64_t>(min(qb, p.Sq - 1)) * p.qss) + 2 * c;
  const int w0 = q0 + rw * 16;                   // the warp's first row
  const int kw = side * NTO * 8;                 // the warp's first key of a tile
  const int cw = side * NDO * 8;                 // and its first output column

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NDO][4];
#pragma unroll
  for (int dn = 0; dn < NDO; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;

  if (k_begin < k_end) issue(k_begin, 0);
  hopper::cp_async_commit();
  int it = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, ++it) {
    const int st = it & 1;
    hopper::cp_async_wait<0>();
    __syncthreads();                             // this tile (and Q) visible; the other
                                                 // stage, and the pairs' logits, no longer read
    if (k0 + BK < k_end) issue(k0 + BK, st ^ 1);
    hopper::cp_async_commit();
    if (w0 >= p.Sq) continue;                    // a warp past the last query row: loads only
                                                 // (both warps of a pair)
    const float* ks = ring + st * stage;
    const float* vs = ks + BK * QS;

    float x[NTO][4];
    // a second parity of accumulators where the registers allow: up to two
    // n8 tiles
    constexpr int PAR = NTO <= 2 ? 2 : 1;
    qk_tile<NTO, PAR>(x, qrow0, qrow1, ks + (kw + g) * QS + 2 * c, QS, D / 8);

    // every (row, key) of the warp's 16 rows valid: no predicate
    const bool full = w0 + 15 < p.Sq && k0 + BK <= kv_end && (!p.causal || k0 + BK - 1 <= w0) &&
                      (p.window < 0 || k0 > w0 + 15 - p.window);
    unsigned good = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NTO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? qa : qb;
        const int kpos = k0 + kw + j * 8 + 2 * c + (e & 1);
        float xv = x[j][e] * p.cs;
        const bool in = full || (row < p.Sq && kpos < p.Skv);
        if (p.bias_kind && in) {
          const int64_t off = bb * p.bsb + h * p.bsh + static_cast<int64_t>(row) * p.bsq +
                              static_cast<int64_t>(kpos) * p.bsk;
          const float bv = p.bias_kind == 1
                               ? static_cast<const float*>(p.bias)[off]
                               : __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off]);
          xv = fmaf(bv, LOG2E, xv);
        }
        if (!full) {
          const bool ok = in && kpos < kv_end && (!p.causal || kpos <= row) &&
                          (p.window < 0 || kpos > row - p.window);
          if (!ok) {
            good &= ~(1u << (j * 4 + e));
            xv = PAIR ? NEG_INF : NEG;           // a pair passes the mask as -inf
          }
        }
        x[j][e] = xv;
      }
    float s[NT][4];
    if constexpr (PAIR) {
      // swap halves: each warp writes its keys' logits, reads the tile's
      float* xp = xs + rw * 16 * BK;
#pragma unroll
      for (int j = 0; j < NTO; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(xp + (g + 8 * i) * BK + kw + j * 8 + 2 * c) =
              make_float2(x[j][2 * i], x[j][2 * i + 1]);
      hopper::named_sync(1 + rw, 64);
      good = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 v2 = *reinterpret_cast<const float2*>(xp + (g + 8 * i) * BK + j * 8 + 2 * c);
          s[j][2 * i] = v2.x;
          s[j][2 * i + 1] = v2.y;
          good |= static_cast<unsigned>(v2.x != NEG_INF) << (j * 4 + 2 * i);
          good |= static_cast<unsigned>(v2.y != NEG_INF) << (j * 4 + 2 * i + 1);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = x[j][e];
    }
    float alpha[2];
    softmax_tile<NT>(s, good, m, l, alpha);
#pragma unroll
    for (int dn = 0; dn < NDO; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }
    const float* vr = vs + 2 * c * VS + g + cw;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ahi[4], alo[4];
      p_frag(s[kk], ahi, alo);
      pv_keys<NDO, VS>(o, ahi, alo, vr + kk * 8 * VS);
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int dn = 0; dn < NDO; ++dn) {
    if (cw + dn * 8 >= ndv) continue;
    const int col = c0 + cw + dn * 8 + 2 * c;
    if (qa < p.Sq)
      *reinterpret_cast<float2*>(p.o + ((static_cast<int64_t>(b) * p.Sq + qa) * p.Hq + h) * D +
                                 col) = make_float2(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (qb < p.Sq)
      *reinterpret_cast<float2*>(p.o + ((static_cast<int64_t>(b) * p.Sq + qb) * p.Hq + h) * D +
                                 col) = make_float2(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

template <int DMAX, int BK>
__global__ void __launch_bounds__(NW * 32)
flash_f32_dec_kernel(const Params p) {
  constexpr int WK = BK / NW;                    // keys a warp a tile
  constexpr int NT = WK / 8;
  constexpr int ROWS = DEC_ROWS;
  static_assert(NW <= MAX_CLUSTER, "the warps' merge weights share the splits' array");
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, QS = qk_stride(D);
  constexpr int VS = v_stride(DMAX);
  float* qs = smem;                              // [ROWS][QS]
  float* ring = qs + ROWS * QS;                  // [2][K: BK][QS, V: BK][VS]
  const int stage = BK * (QS + VS);
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x;                  // the block's rank in its cluster
  const int nsplit = gridDim.x;
  const int hk = blockIdx.y / p.HG, hg = blockIdx.y % p.HG;
  const int b = blockIdx.z;
  const int h0 = hk * p.G + hg * ROWS;
  const int nrows = min(ROWS, p.G - hg * ROWS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;

  int kv_end = p.Skv;
  if (p.kvlen) kv_end = min(kv_end, max(p.kvlen[b], 0));
  const int k_begin = split * p.split;
  const int k_stop = min(kv_end, k_begin + p.split);
  const float* kg = p.k + b * p.ksb + hk * p.ksh;
  const float* vg = p.v + b * p.vsb + hk * p.vsh;

  load_tile(qs, QS, p.q + b * p.qsb + h0 * p.qsh, p.qsh, ROWS, nrows, D, p.vec, tid);
  auto issue = [&](int k0, int st) {
    float* ks = ring + st * stage;
    load_tile(ks, QS, kg + static_cast<int64_t>(k0) * p.kss, p.kss, BK, k_stop - k0, D, p.vec, tid);
    load_tile(ks + BK * QS, VS, vg + static_cast<int64_t>(k0) * p.vss, p.vss, BK, k_stop - k0, D,
              p.vec, tid);
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[DMAX / 8][4];
#pragma unroll
  for (int dn = 0; dn < DMAX / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;
  const float* qrow0 = qs + g * QS + 2 * c;
  const float* qrow1 = qrow0 + 8 * QS;

  if (k_begin < k_stop) issue(k_begin, 0);
  hopper::cp_async_commit();
  int it = 0;
  for (int k0 = k_begin; k0 < k_stop; k0 += BK, ++it) {
    const int st = it & 1;
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (k0 + BK < k_stop) issue(k0 + BK, st ^ 1);
    hopper::cp_async_commit();
    const int kw0 = k0 + WK * warp;              // this warp's keys
    const float* ks = ring + st * stage + WK * warp * QS;
    const float* vs = ring + st * stage + BK * QS + WK * warp * VS;
    float s[NT][4];
    constexpr int PAR = NT <= 2 ? 2 : 1;
    qk_tile<NT, PAR>(s, qrow0, qrow1, ks + g * QS + 2 * c, QS, D / 8);
    // keys past this split's end are masked; every row sees the same keys
    const bool full = kw0 + WK <= k_stop;
    unsigned good = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.cs;
        if (!full && kw0 + j * 8 + 2 * c + (e & 1) >= k_stop) {
          good &= ~(1u << (j * 4 + e));
          x = NEG;
        }
        s[j][e] = x;
      }
    float alpha[2];
    softmax_tile<NT>(s, good, m, l, alpha);
#pragma unroll
    for (int dn = 0; dn < DMAX / 8; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }
    const float* vr = vs + 2 * c * VS + g;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ahi[4], alo[4];
      p_frag(s[kk], ahi, alo);
      pv_keys<DMAX / 8, VS>(o, ahi, alo, vr + kk * 8 * VS);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // the warps' states: m and l by row, o by (row, column), in float32
  float* pm = ring;                              // [NW][ROWS]
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
  for (int dn = 0; dn < DMAX / 8; ++dn)
    if (dn * 8 < D) {
      *reinterpret_cast<float2*>(pw + g * D + dn * 8 + 2 * c) = make_float2(o[dn][0], o[dn][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * D + dn * 8 + 2 * c) =
          make_float2(o[dn][2], o[dn][3]);
    }
  __syncthreads();
  // the block's state: per row each warp's weight, then the warps 0..3 in
  // order, each element by one thread
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

  // the slot's splits 0..C-1, every remote read issued before any is used
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
    *reinterpret_cast<float2*>(p.o + (static_cast<int64_t>(b) * p.Hq + h0 + r) * D + col) =
        make_float2(acc.x / den, acc.y / den);
  }
  cluster.sync();                                // no block leaves while others read it
}

template <typename Kernel>
int allow_smem(Kernel kern, bool& done) {
  if (!done) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return hopper::status(err, 2);
    done = true;
  }
  return 0;
}

template <int DVMAX, int BK, int ROWS>
int launch(Params p, int bytes, int panels, cudaStream_t stream) {
  static bool attr = false;
  if (const int err = allow_smem(flash_f32_kernel<DVMAX, BK, ROWS>, attr)) return err;
  constexpr int THREADS = ROWS / 16 * (DVMAX > 256 ? 2 : 1) * 32;
  p.nqt = (p.Sq + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(p.nqt) * p.Hq * p.B;
  if (blocks >= (1ll << 31) || panels > 65535) return hopper::status(cudaErrorInvalidValue, 3);
  flash_f32_kernel<DVMAX, BK, ROWS>
      <<<dim3(static_cast<unsigned>(blocks), panels), dim3(THREADS), bytes, stream>>>(p);
  return hopper::status(cudaGetLastError(), 4);
}

template <int DMAX, int BK>
int launch_dec(const Params& p, int nsplit, cudaStream_t stream) {
  static bool attr = false;
  if (const int err = allow_smem(flash_f32_dec_kernel<DMAX, BK>, attr)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nsplit), static_cast<unsigned>(p.Hkv * p.HG),
                     static_cast<unsigned>(p.B));
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = dec_smem_bytes(p.D, DMAX, BK);
  cfg.stream = stream;
  cudaLaunchAttribute attr_cluster[1];
  attr_cluster[0].id = cudaLaunchAttributeClusterDimension;
  attr_cluster[0].val.clusterDim.x = static_cast<unsigned>(nsplit);
  attr_cluster[0].val.clusterDim.y = 1;
  attr_cluster[0].val.clusterDim.z = 1;
  cfg.attrs = attr_cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_f32_dec_kernel<DMAX, BK>, p);
  if (err != cudaSuccess) return hopper::status(err, 4);
  return hopper::status(cudaGetLastError(), 4);
}

bool aligned16(const void* ptr, const int64_t* strides, int n) {
  uint64_t bits = reinterpret_cast<uintptr_t>(ptr);
  for (int i = 0; i < n; ++i) bits |= static_cast<uint64_t>(strides[i]) * 4;
  return bits % 16 == 0;
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* kvlen, void* o, int bias_kind, int B, int Sq, int Skv, int Hq,
                   int Hkv, int D, int Bb, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t bsb,
                   int64_t bsh, int64_t bsq, int64_t bsk, int causal, int window, float scale) {
  const int64_t qst[3] = {qsb, qss, qsh}, kst[3] = {ksb, kss, ksh}, vst[3] = {vsb, vss, vsh};
  const int vec = aligned16(q, qst, 3) && aligned16(k, kst, 3) && aligned16(v, vst, 3);
  return Params{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), bias, static_cast<const int32_t*>(kvlen),
                static_cast<float*>(o), bias ? bias_kind : 0, B, Sq, Skv, Hq, Hkv,
                Bb > 0 ? Bb : 1, D, D, 0, qsb, qss, qsh, ksb, kss, ksh, vsb,
                vss, vsh, bsb, bsh, bsq, bsk, causal, window, scale * LOG2E, vec, 1, 0, 1, 1};
}

}  // namespace f32a
}  // namespace

// Strides are in elements; the head dim of q, k, v has unit stride and o is
// a contiguous (B, Sq, Hq, D) float32 tensor.  kvlen is null or (B,) int32.
// Returns the launch status (hopper::status).
//
// flash_mha_f32_launch: float32 q, k, v at any head dim D a multiple of 8,
// any bias, mask and strides, as the wrapper's f32_plan cuts the launch:
// output columns in panels of `dv` (a multiple of 8; D itself in one
// panel), on the instance of `cols` columns (at least dv), `bk` keys a tile
// and `rows` query rows a block, Q staged in shared memory where `q_smem`.
// A plan that names no instance, or whose tiles outgrow a block's shared
// memory, is refused.
extern "C" int flash_mha_f32_launch(const void* q, const void* k, const void* v,
                                    const void* bias, const void* kvlen, void* o,
                                    int qkv_is_bf16, int bias_kind, int B, int Sq, int Skv,
                                    int Hq, int Hkv, int D, int Bb, int64_t qsb, int64_t qss,
                                    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                                    int64_t vsb, int64_t vss, int64_t vsh, int64_t bsb,
                                    int64_t bsh, int64_t bsq, int64_t bsk, int causal,
                                    int window, float scale, int dv, int cols, int rows, int bk,
                                    int q_smem, void* stream) {
  using namespace f32a;
  if (B == 0 || Sq == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  const int panels = dv > 0 ? (D + dv - 1) / dv : 0;
  const int bytes = smem_bytes(D, cols, bk, rows, q_smem);
  if (qkv_is_bf16 || D <= 0 || D % 8 || dv <= 0 || dv % 8 || dv > cols ||
      (panels == 1) != (dv == D) || bytes > SMEM_LIMIT || Hkv <= 0 || Hq % Hkv ||
      (bias && (bias_kind < 1 || bias_kind > 2 || Bb <= 0 || B % Bb)))
    return hopper::status(cudaErrorInvalidValue, 1);
  Params p = make_params(q, k, v, bias, kvlen, o, bias_kind, B, Sq, Skv, Hq, Hkv, D, Bb, qsb,
                         qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsq, bsk, causal,
                         window, scale);
  p.dv = dv;
  p.q_smem = q_smem != 0;
  auto s = static_cast<cudaStream_t>(stream);
  // the instances (columns, keys a tile, query rows a block): 4 warps up to
  // 64 columns; 8 at 96 and 128 (at 4 ptxas spilled at 128); 4 or 8 at 192
  // and 256; 8 in pairs at 320
#define F32_INSTANCE(C, K, R) \
  if (cols == C && bk == K && rows == R) return launch<C, K, R>(p, bytes, panels, s);
  F32_INSTANCE(16, 64, 64)
  F32_INSTANCE(32, 64, 64)
  F32_INSTANCE(64, 64, 64)
  F32_INSTANCE(96, 32, 128)
  F32_INSTANCE(128, 32, 128)
  F32_INSTANCE(192, 32, 128)
  F32_INSTANCE(192, 32, 64)
  F32_INSTANCE(192, 16, 64)
  F32_INSTANCE(256, 16, 128)
  F32_INSTANCE(256, 32, 64)
  F32_INSTANCE(256, 16, 64)
  F32_INSTANCE(320, 16, 64)
#undef F32_INSTANCE
  return hopper::status(cudaErrorInvalidValue, 1);
}

// flash_mha_f32_dec_launch: float32 q (B, 1, Hq, D), k, v (B, Skv, Hkv, D),
// D a multiple of 8 up to 320, no bias, no causal or window mask, any
// strides.  `split` keys a block (a multiple of 64) and `nsplit` =
// ceil(Skv / split) blocks a slot, 1..8, from the wrapper's dec_plan.
extern "C" int flash_mha_f32_dec_launch(const void* q, const void* k, const void* v,
                                        const void* bias, const void* kvlen, void* o,
                                        int qkv_is_bf16, int bias_kind, int B, int Sq, int Skv,
                                        int Hq, int Hkv, int D, int Bb, int64_t qsb, int64_t qss,
                                        int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                                        int64_t vsb, int64_t vss, int64_t vsh, int64_t bsb,
                                        int64_t bsh, int64_t bsq, int64_t bsk, int causal,
                                        int window, float scale, int split, int nsplit,
                                        void* stream) {
  using namespace f32a;
  if (B == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (qkv_is_bf16 || bias || bias_kind || Sq != 1 || causal || window >= 0 || Hkv <= 0 ||
      Hq % Hkv || D <= 0 || D % 8 || D > DEC_MAX_D || split <= 0 || split % 64 ||
      nsplit > MAX_CLUSTER || nsplit != (Skv > 0 ? (Skv + split - 1) / split : 1) || B > 65535)
    return hopper::status(cudaErrorInvalidValue, 1);
  Params p = make_params(q, k, v, nullptr, kvlen, o, 0, B, 1, Skv, Hq, Hkv, D, 1, qsb, qss, qsh,
                         ksb, kss, ksh, vsb, vss, vsh, 0, 0, 0, 0, 0, -1, scale);
  p.split = split;
  p.G = Hq / Hkv;
  p.HG = (p.G + DEC_ROWS - 1) / DEC_ROWS;
  if (static_cast<int64_t>(Hkv) * p.HG > 65535) return hopper::status(cudaErrorInvalidValue, 3);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dec_cols(D)) {
    case 64: return launch_dec<64, 64>(p, nsplit, s);
    case 96: return launch_dec<96, 64>(p, nsplit, s);
    case 128: return launch_dec<128, 64>(p, nsplit, s);
    case 192: return launch_dec<192, 32>(p, nsplit, s);
    case 256: return launch_dec<256, 32>(p, nsplit, s);
    default: return launch_dec<320, 32>(p, nsplit, s);
  }
}
