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
// block owns its query rows and loops over the key tiles itself, with the
// state in registers.  Two bf16 variants here, chosen by a fixed rule on
// the operands (the wrapper's variant_for):
//
// The fold's attention (bf16 q/k/v, D in {32, 64}, Hq == Hkv a multiple of
//   4, a bias, Sq > 1, no causal or window mask): flash_wg_kernel, designed
//   for Hopper.  Its shapes: triangular attention's rows as batch (D = 32,
//   4 heads, one (B, 4, N, N) bias shared by each protein's N rows, or by
//   the 64 rows of the chunked slab), the sequence attention and the
//   structure module (D = 64, 16 heads, an f32 bias a protein).  Bounds on
//   the H100 at 700 W: at D = 32 the slab (64, 2048, 4, 32) is 0.14 ms of
//   tensor work (bf16) and 0.05 ms of bytes, but its 1.07e9 logits take
//   0.29 ms of the SMs' ex2 units (16 a clock) and ~0.3 ms of issue at
//   ~9 instructions a logit: the softmax, not the tensor cores, bounds it.
//   At D = 64 the f32 bias is most of the bytes (268 MB at N = 2,048,
//   0.08 ms), far above the tensor work.  The design:
//   - A block is 4 consumer warpgroups, one head each (heads 4g..4g+3),
//     and a producer warpgroup; it owns one 64-query tile and, at D = 32,
//     two batch rows of one bias block (units: a query tile of one row and
//     head), so one bias tile serves both rows and all 4 heads.
//   - TMA with mbarriers: the producer's one thread loads Q once and, for
//     each 32-key stage, K and V boxes per (row, head), 64- or 128-byte
//     swizzled as the wgmma descriptors read them, into a K/V ring of 3
//     stages (2 with an f32 bias), and the raw bias box into a ring of 2.
//     The tensor maps are kernel parameters (__grid_constant__), so a CUDA
//     graph keeps them; the host encodes them through the driver entry
//     point that cudaGetDriverEntryPoint returns, without -lcuda.  A bias
//     with its 4 heads dense inside each key (triangular attention's
//     permuted (B, N, N, 4)) is one box of (keys x heads, queries), one
//     with them dense inside each query (the same gathered on a mesh rank
//     with the keys outermost) one of (queries x heads, keys); an f32 one
//     with heads innermost, or any with keys innermost, a 4-d box.
//   - The producer's other three warps convert each raw bias box once into
//     4 per-head float32 tiles, divided by the softmax scale and swizzled
//     so the accumulator fragment reads them without bank conflicts; two
//     sets, so a stage's conversion overlaps the previous stage's math.
//   - S = bias / scale + Q K^T: the consumers load the bias tile into the
//     accumulator and wgmma (m64n32k16, Q and K from shared memory)
//     accumulates onto it, so a logit costs no add or unpack; the softmax
//     is one FFMA and one ex2 a logit, in the log2 domain, with float32
//     state.  Masks run only on a stage that crosses a key end; a masked
//     S is NEG and its probability underflows to exactly 0 (the scale is
//     positive).  O is rescaled only when a row's max moved (a warp vote).
//   - P V with P from registers (wgmma m64nDk16, V N-major from shared
//     memory): P is split into hi and lo, both bf16, as the tensor-core
//     kernel splits it, two wgmmas into one float32 accumulator, so P keeps
//     ~16 bits.
//   - setmaxnreg: the producer warpgroup drops to 56 registers, the
//     consumers rise to 104.  No atomics, and every unit's arithmetic is
//     the same whichever rows share its block: a row launched alone is
//     bitwise its row of a batch.
//
// Any other bf16 call, D in {16, 32, 64, 96, 128, 192, 256} (the LM decode,
//   the zoo, causal, window, GQA): flash_tc_kernel, FlashAttention-2 with
//   Ampere's mma.sync and cp.async.  Bound on the H100: bytes.  At
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
// float32 q/k/v, and head dims above 256, take flash_f32.cu's kernels; a
//   bf16 head dim no variant here takes (8, 24, ...) is padded by the
//   wrapper to the next one that does.
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

using hopper::split_bf16;

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
      alpha[i] = hopper::ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
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

// ---------------------------------------------------------------------------
// Hopper variant of the fold's attention: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------
namespace wg {

constexpr int NWG = 4;                      // consumer warpgroups: one head each
constexpr int NCONS = NWG * 128;            // consumer threads
constexpr int NTHREADS = NCONS + 128;       // + the producer warpgroup
constexpr int NCVT = 96;                    // the producer warpgroup's converter threads
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (launched at 96 a thread: 640 x 96 of the SM's 65,536)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 104;
constexpr int BQ = 64, BKV = 32;            // query rows of a unit, keys of a stage
constexpr int SMEM_LIMIT = 232448;          // opt-in shared memory of one H100 block
constexpr float LOG2E = 1.4426950408889634f;

// Units (query tiles of one row and head) a warpgroup carries through the key
// loop at once: at D = 32 the block's rows sharing one bias tile.
template <int D> __host__ __device__ constexpr int units() { return D == 32 ? 2 : 1; }
template <int BK> __host__ __device__ constexpr int esize() { return BK == 1 ? 4 : 2; }
template <int D> __host__ __device__ constexpr int q_bytes() { return BQ * D * 2; }
template <int D> __host__ __device__ constexpr int kv_bytes() { return BKV * D * 2; }
// one stage's raw bias box: 64 queries x 32 keys x the block's 4 heads
template <int BK> __host__ __device__ constexpr int raw_bytes() { return BQ * BKV * NWG * esize<BK>(); }
// the four per-head float32 bias tiles of one stage
constexpr int PLANE = BQ * BKV * 4, CANON = NWG * PLANE;
// one stage of the K/V ring: K and V tiles of every unit
template <int D> __host__ __device__ constexpr int kv_stage() { return 2 * units<D>() * NWG * kv_bytes<D>(); }
constexpr int NRAW = 2;                     // stages of the raw bias ring
// Q tiles, two sets of per-head bias tiles, the K/V ring, the raw bias
// ring, the barriers
template <int D, int BK> __host__ __device__ constexpr int smem_bytes(int nkv) {
  return 1024 + units<D>() * NWG * q_bytes<D>() + 2 * CANON + nkv * kv_stage<D>() +
         NRAW * raw_bytes<BK>() + 256;
}
// the deepest K/V ring that fits (3 at D = 32 with a bf16 bias, else 2)
template <int D, int BK> __host__ __device__ constexpr int stages() {
  return smem_bytes<D, BK>(3) <= SMEM_LIMIT ? 3 : 2;
}

struct Params {
  void* o;
  const int32_t* kvlen;
  int B, Sq, Skv, Hq, rows_per_bias;        // rows_per_bias = B / Bb
  int rr;                                   // batch rows a block (<= units<D>())
  int bmap;                                 // bias box: 0 heads x keys fused, 1 heads
                                            // innermost, 2 keys innermost, 3 heads x
                                            // queries fused
  int nqt, nhg;                             // query tiles, head groups of 4
  float scale, inv_scale;
};


// A per-head bias tile, [64 queries][32 keys] float32: rows of 128 bytes
// whose key-pair granules (8 bytes) are XOR-swizzled by bits 0-1 of the
// query, so that the accumulator fragment's reads (rows g and g + 8 of a
// warp, pairs 4i + c, 8 bytes a thread) hit 32 distinct banks in each half
// warp.
__device__ __forceinline__ int canon_off(int q, int pr) {
  return q * 128 + ((pr ^ ((q & 3) << 2)) << 3);
}

// The converter threads (ct of NCVT) rewrite a stage's raw bias box (TMA's
// layout: [q][k][4 heads] for maps 0 and 1, [4 heads][q][k] for map 2,
// [k][q][4 heads] for map 3) into
// the four per-head tiles, in float32 and divided by the softmax scale: the
// QK^T product then accumulates onto it, so that S * scale = QK^T * scale +
// bias.  Once a stage for all the block's rows.
template <int BK>
__device__ __forceinline__ void convert_bias(const unsigned char* raw, unsigned char* canon, int ct,
                                             int bmap, float inv) {
  constexpr int HE = NWG * esize<BK>();                  // bytes of 4 heads' values
  if (bmap != 2) {
    // item (q, pr): keys 2pr, 2pr + 1 of all 4 heads; consecutive items
    // read consecutive raw bytes (q fastest for map 3)
    for (int it = ct; it < BQ * (BKV / 2); it += NCVT) {
      const int q = bmap == 3 ? it % BQ : it >> 4, pr = bmap == 3 ? it / BQ : it & 15;
      const int off = canon_off(q, pr);
      const int r0 = bmap == 3 ? (2 * pr * BQ + q) * HE : it * 2 * HE;
      const int r1 = bmap == 3 ? r0 + BQ * HE : r0 + HE;
      float4 k0, k1;                                     // heads 0..3 of the two keys
      if constexpr (BK == 2) {
        const uint2 v0 = *reinterpret_cast<const uint2*>(raw + r0);
        const uint2 v1 = *reinterpret_cast<const uint2*>(raw + r1);
        k0 = make_float4(__uint_as_float(v0.x << 16), __uint_as_float(v0.x & 0xffff0000u),
                         __uint_as_float(v0.y << 16), __uint_as_float(v0.y & 0xffff0000u));
        k1 = make_float4(__uint_as_float(v1.x << 16), __uint_as_float(v1.x & 0xffff0000u),
                         __uint_as_float(v1.y << 16), __uint_as_float(v1.y & 0xffff0000u));
      } else {
        k0 = *reinterpret_cast<const float4*>(raw + r0);
        k1 = *reinterpret_cast<const float4*>(raw + r1);
      }
      *reinterpret_cast<float2*>(canon + off) = make_float2(k0.x * inv, k1.x * inv);
      *reinterpret_cast<float2*>(canon + PLANE + off) = make_float2(k0.y * inv, k1.y * inv);
      *reinterpret_cast<float2*>(canon + 2 * PLANE + off) = make_float2(k0.z * inv, k1.z * inv);
      *reinterpret_cast<float2*>(canon + 3 * PLANE + off) = make_float2(k0.w * inv, k1.w * inv);
    }
  } else {
    // each head's plane is already [q][k]: item (h, q, pr)
    for (int it = ct; it < NWG * BQ * (BKV / 2); it += NCVT) {
      const int h = it / (BQ * BKV / 2), q = (it >> 4) % BQ, pr = it & 15;
      float2 v;
      if constexpr (BK == 2) {
        const unsigned x = *reinterpret_cast<const unsigned*>(raw + it * 4);
        v = make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
      } else {
        v = *reinterpret_cast<const float2*>(raw + it * 8);
      }
      *reinterpret_cast<float2*>(canon + h * PLANE + canon_off(q, pr)) =
          make_float2(v.x * inv, v.y * inv);
    }
  }
}

// P (one k16 step: accumulator chunks 2j, 2j + 1) as bf16 A fragments,
// split as the tensor-core kernel splits it (P = hi + lo within 2^-17).
__device__ __forceinline__ void split_p(const float (&p)[16], int j, unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = 8 * j + 4 * (r >> 1) + 2 * (r & 1);   // (chunk 2j + r/2, row half r%2)
    tc::split_bf16(p[e], p[e + 1], hi[r], lo[r]);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                const Params p) {
  constexpr int U = units<D>(), NST = stages<D, BK>();
  constexpr int QB = q_bytes<D>(), KB = kv_bytes<D>(), RB = raw_bytes<BK>();
  constexpr int STAGE = kv_stage<D>();
  constexpr int SW = D == 32 ? hopper::SWIZZLE_64B : hopper::SWIZZLE_128B;
  constexpr unsigned GROUP8 = 8 * D * 2;               // bytes of 8 rows of a Q/K/V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;                            // [NWG][U] Q tiles
  unsigned char* canon = qs + U * NWG * QB;            // [2][NWG] per-head bias tiles
  unsigned char* stg = canon + 2 * CANON;              // [NST] {K [U][NWG], V [U][NWG]}
  unsigned char* raws = stg + NST * STAGE;             // [NRAW] raw bias boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(raws + NRAW * RB);
  uint64_t* empty = full + NST;                        // the consumers are done with a stage
  uint64_t* bfull = empty + NST;                       // [NRAW] a raw bias box has landed
  uint64_t* bempty = bfull + NRAW;                     // [NRAW] the converters are done with it
  uint64_t* cfull = bempty + NRAW;                     // [2] a set of bias tiles is ready
  uint64_t* qbar = cfull + 2;

  int bx = blockIdx.x;
  const int qt = bx % p.nqt;
  bx /= p.nqt;
  const int h0 = (bx % p.nhg) * NWG, r0 = (bx / p.nhg) * p.rr;
  const int q0 = qt * BQ, bb = r0 / p.rows_per_bias;

  // each unit's key end, and the block's: every thread reads the same
  int kv_end[U], kv_max = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    kv_end[u] = 0;
    if (u < p.rr) kv_end[u] = p.kvlen ? min(p.Skv, max(p.kvlen[r0 + u], 0)) : p.Skv;
    kv_max = max(kv_max, kv_end[u]);
  }
  const int ntiles = (kv_max + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NCONS / 32);
    }
#pragma unroll
    for (int s = 0; s < NRAW; ++s) {
      hopper::mbar_init(&bfull[s], 1);
      hopper::mbar_init(&bempty[s], NCVT / 32);
    }
    hopper::mbar_init(&cfull[0], NCVT / 32);
    hopper::mbar_init(&cfull[1], NCVT / 32);
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // producer warpgroup: one thread keeps the stages' TMA loads in flight,
    // three warps turn each stage's bias box into the per-head tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) {
      hopper::mbar_expect_tx(qbar, p.rr * NWG * QB);
      for (int u = 0; u < p.rr; ++u)
        for (int w = 0; w < NWG; ++w)
          hopper::tma_load_4d(qs + (w * U + u) * QB, &tq, qbar, 0, h0 + w, q0, r0 + u);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NST, sb = t % NRAW, k0 = t * BKV;
        unsigned char* raw = raws + sb * RB;
        hopper::mbar_wait(&bempty[sb], ((t / NRAW) & 1) ^ 1);
        hopper::mbar_expect_tx(&bfull[sb], RB);
        if (p.bmap == 0) hopper::tma_load_3d(raw, &tb, &bfull[sb], k0 * NWG, q0, bb);
        else if (p.bmap == 1) hopper::tma_load_4d(raw, &tb, &bfull[sb], h0, k0, q0, bb);
        else if (p.bmap == 2) hopper::tma_load_4d(raw, &tb, &bfull[sb], k0, q0, h0, bb);
        else hopper::tma_load_3d(raw, &tb, &bfull[sb], q0 * NWG, k0, bb);
        hopper::mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        unsigned char* ks = stg + st * STAGE;
        unsigned char* vs = ks + U * NWG * KB;
        int active = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) active += k0 < kv_end[u];
        hopper::mbar_expect_tx(&full[st], active * 2 * NWG * KB);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 >= kv_end[u]) continue;
          for (int w = 0; w < NWG; ++w) {
            hopper::tma_load_4d(ks + (u * NWG + w) * KB, &tk, &full[st], 0, h0 + w, k0, r0 + u);
            hopper::tma_load_4d(vs + (u * NWG + w) * KB, &tv, &full[st], 0, h0 + w, k0, r0 + u);
          }
        }
      }
    } else if (threadIdx.x >= NCONS + 32) {
      const int ct = threadIdx.x - (NCONS + 32);
      for (int t = 0; t < ntiles; ++t) {
        const int sb = t % NRAW;
        hopper::mbar_wait(&bfull[sb], (t / NRAW) & 1);
        // tile t - 2's consumers are done with this set of bias tiles
        if (t >= 2) hopper::mbar_wait(&empty[(t - 2) % NST], ((t - 2) / NST) & 1);
        convert_bias<BK>(raws + sb * RB, canon + (t & 1) * CANON, ct, p.bmap, p.inv_scale);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) {
          hopper::mbar_arrive(&bempty[sb]);
          hopper::mbar_arrive(&cfull[t & 1]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w computes head h0 + w of the block's rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int w = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, c = lane & 3;
  // the softmax in the log2 domain of S = QK^T + bias / scale: p = 2^(S cs - m cs)
  const float cs = p.scale * LOG2E;
  float o[U][D / 2], m[U][2], l[U][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[u][j] = 0.f;
    m[u][0] = m[u][1] = NEG;
    l[u][0] = l[u][1] = 0.f;
  }
  uint64_t dq[U];
#pragma unroll
  for (int u = 0; u < U; ++u) dq[u] = hopper::wgmma_desc(qs + (w * U + u) * QB, SW, GROUP8);
  // this thread's bias granules in its head's tile: rows g and g + 8 of its
  // warp, pairs 4i + c (canon_off with the row's swizzle taken out)
  const int row0 = 16 * wi + g, cofs = w * PLANE + row0 * 128 + (c << 3);
  const int sw0 = (row0 & 3) << 5, sw1 = ((row0 + 8) & 3) << 5;
  hopper::mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NST, k0 = t * BKV;
    hopper::mbar_wait(&full[st], (t / NST) & 1);
    hopper::mbar_wait(&cfull[t & 1], (t >> 1) & 1);
    const unsigned char* ks = stg + st * STAGE;
    const unsigned char* vs = ks + U * NWG * KB;
    const unsigned char* cv = canon + (t & 1) * CANON + cofs;

    unsigned hi[U][BKV / 16][4], lo[U][BKV / 16][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 >= kv_end[u]) continue;                   // warpgroup-uniform
      // S = bias / scale + Q K^T; the wait also retires the previous unit's
      // P V, whose A registers this unit's may take
      float s[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b0 = *reinterpret_cast<const float2*>(cv + ((i << 5) ^ sw0));
        const float2 b1 = *reinterpret_cast<const float2*>(cv + 8 * 128 + ((i << 5) ^ sw1));
        s[4 * i] = b0.x;
        s[4 * i + 1] = b0.y;
        s[4 * i + 2] = b1.x;
        s[4 * i + 3] = b1.y;
      }
      const uint64_t dk = hopper::wgmma_desc(ks + (u * NWG + w) * KB, SW, GROUP8);
      hopper::reg_fence(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n32k16_ss(s, dq[u] + 2 * kk, dk + 2 * kk, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(s);
      if (u > 0) {
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          hopper::reg_fence(hi[u - 1][j]);
          hopper::reg_fence(lo[u - 1][j]);
        }
      }
      if (k0 + BKV > kv_end[u]) {                      // keys past the end: NEG
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (k0 + 8 * (e >> 2) + 2 * c + (e & 1) >= kv_end[u]) s[e] = NEG;
      }
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < 16; ++e) mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], s[e]);
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
        mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
        const float m_new = fmaxf(m[u][hf], mt[hf]);
        alpha[hf] = hopper::ex2((m[u][hf] - m_new) * cs);
        mc[hf] = m_new * cs;
        m[u][hf] = m_new;
      }
      // a masked key's S is NEG and the row's max is finite (key k0 is
      // valid), so 2^(NEG cs - m cs) is exactly 0 (cs > 0)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int hf = (e >> 1) & 1;
        s[e] = hopper::ex2(fmaf(s[e], cs, -mc[hf]));
        rs[hf] += s[e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[u][hf] = alpha[hf] * l[u][hf] + rs[hf];
      // a row whose max did not move keeps its O as it is (alpha == 1)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[u][j] *= alpha[(j >> 1) & 1];
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) split_p(s, j, hi[u][j], lo[u][j]);
      hopper::reg_fence(o[u]);
      hopper::wgmma_fence();
      const uint64_t dv = hopper::wgmma_desc(vs + (u * NWG + w) * KB, SW, GROUP8);
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        const uint64_t dvj = dv + ((16 * D * 2 * j) >> 4);   // keys 16j..16j + 15
        if constexpr (D == 32) {
          hopper::wgmma_m64n32k16_rs(o[u], hi[u][j], dvj);
          hopper::wgmma_m64n32k16_rs(o[u], lo[u][j], dvj);
        } else {
          hopper::wgmma_m64n64k16_rs(o[u], hi[u][j], dvj);
          hopper::wgmma_m64n64k16_rs(o[u], lo[u][j], dvj);
        }
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < U; ++u) hopper::reg_fence(o[u]);
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      hopper::reg_fence(hi[U - 1][j]);
      hopper::reg_fence(lo[U - 1][j]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // o / max(l, 1e-30), 4 bytes a store (two columns of one row)
  bf16* og = static_cast<bf16*>(p.o);
  const int h = h0 + w;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= p.rr) continue;
    float d[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lsum = l[u][hf];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      d[hf] = fmaxf(lsum, 1e-30f);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = q0 + 16 * wi + g + 8 * hf;
      if (q >= p.Sq) continue;
      bf16* orow = og + ((static_cast<int64_t>(r0 + u) * p.Sq + q) * p.Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<unsigned*>(orow + 8 * j + 2 * c) =
            hopper::pack_bf16(o[u][4 * j + 2 * hf] / d[hf], o[u][4 * j + 2 * hf + 1] / d[hf]);
    }
  }
}

using hopper::encode;

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, const void* bias, const int32_t* kvlen,
           void* o, int B, int Sq, int Skv, int Hq, int Bb, const int64_t* qst,
           const int64_t* kst, const int64_t* vst, const int64_t* bst, float scale, int rr,
           int bmap, cudaStream_t stream) {
  constexpr int NST = stages<D, BK>();
  constexpr int SMEM = smem_bytes<D, BK>(NST);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wg_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return hopper::status(err, 2);
    attr = true;
  }
  constexpr CUtensorMapSwizzle SWZ = D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv, tb;
  // q, k, v: (D, H, S, B) boxes of (D, 1, rows, 1)
  const uint64_t qd[4] = {D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
  const uint64_t kd[4] = {D, (uint64_t)Hq, (uint64_t)Skv, (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)qst[2] * 2, (uint64_t)qst[1] * 2, (uint64_t)qst[0] * 2};
  const uint64_t ks[3] = {(uint64_t)kst[2] * 2, (uint64_t)kst[1] * 2, (uint64_t)kst[0] * 2};
  const uint64_t vs[3] = {(uint64_t)vst[2] * 2, (uint64_t)vst[1] * 2, (uint64_t)vst[0] * 2};
  const uint32_t qbox[4] = {D, 1, BQ, 1}, kbox[4] = {D, 1, BKV, 1};
  bool ok = encode(&tq, BF, 4, q, qd, qs, qbox, SWZ) && encode(&tk, BF, 4, k, kd, ks, kbox, SWZ) &&
            encode(&tv, BF, 4, v, kd, vs, kbox, SWZ);
  // bias strides (b, h, q, k) in elements
  const uint64_t es = esize<BK>();
  const auto BT = BK == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : BF;
  const uint64_t sb = bst[0] * es, sh = bst[1] * es, sq = bst[2] * es;
  if (bmap == 0) {            // (heads x keys, q, b): heads dense inside each key
    const uint64_t d3[3] = {(uint64_t)NWG * Skv, (uint64_t)Sq, (uint64_t)Bb}, s3[2] = {sq, sb};
    const uint32_t b3[3] = {NWG * BKV, BQ, 1};
    ok = ok && encode(&tb, BT, 3, bias, d3, s3, b3, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else if (bmap == 1) {     // (h, k, q, b)
    const uint64_t d4[4] = {(uint64_t)Hq, (uint64_t)Skv, (uint64_t)Sq, (uint64_t)Bb};
    const uint64_t s4[3] = {(uint64_t)bst[3] * es, sq, sb};
    const uint32_t b4[4] = {NWG, BKV, BQ, 1};
    ok = ok && encode(&tb, BT, 4, bias, d4, s4, b4, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else if (bmap == 2) {     // (k, q, h, b)
    const uint64_t d4[4] = {(uint64_t)Skv, (uint64_t)Sq, (uint64_t)Hq, (uint64_t)Bb};
    const uint64_t s4[3] = {sq, sh, sb};
    const uint32_t b4[4] = {BKV, BQ, NWG, 1};
    ok = ok && encode(&tb, BT, 4, bias, d4, s4, b4, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {                    // (heads x queries, k, b): heads dense inside each query
    const uint64_t d3[3] = {(uint64_t)NWG * Sq, (uint64_t)Skv, (uint64_t)Bb};
    const uint64_t s3[2] = {(uint64_t)bst[3] * es, sb};
    const uint32_t b3[3] = {NWG * BQ, BKV, 1};
    ok = ok && encode(&tb, BT, 3, bias, d3, s3, b3, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return hopper::status(cudaErrorInvalidValue, 5);
  Params p{o, kvlen, B, Sq, Skv, Hq, B / Bb, rr, bmap, (Sq + BQ - 1) / BQ, Hq / NWG, scale,
           1.f / scale};
  const long long blocks = static_cast<long long>(p.nqt) * p.nhg * (B / rr);
  if (blocks >= (1ll << 31)) return hopper::status(cudaErrorInvalidValue, 3);
  flash_wg_kernel<D, BK><<<dim3(static_cast<unsigned>(blocks)), dim3(NTHREADS), SMEM, stream>>>(
      tq, tk, tv, tb, p);
  return hopper::status(cudaGetLastError(), 4);
}

}  // namespace wg

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

// flash_mha_wg_launch: the Hopper variant.  bf16 q, k, v at D in {32, 64},
// Hq == Hkv, a multiple of 4; an f32 (bias_kind 1) or bf16 (2) bias read by
// TMA in box `bmap` (0: heads dense inside each key, Hq == 4; 1: heads
// innermost, f32; 2: keys innermost; 3: heads dense inside each query,
// Hq == 4); no causal or window mask.  `rr` batch
// rows a block, dividing B / Bb.  Every base pointer and stride the maps
// use is a multiple of 16 bytes.
extern "C" int flash_mha_wg_launch(const void* q, const void* k, const void* v, const void* bias,
                                   const void* kvlen, void* o, int qkv_is_bf16, int bias_kind,
                                   int B, int Sq, int Skv, int Hq, int Hkv, int D, int Bb,
                                   int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                                   int64_t vsh, int64_t bsb, int64_t bsh, int64_t bsq,
                                   int64_t bsk, int causal, int window, float scale, int rr,
                                   int bmap, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!qkv_is_bf16 || !bias || Hq != Hkv || Hq % wg::NWG || causal || window >= 0 ||
      !(scale > 0.f) || rr < 1 ||
      rr > (D == 32 ? wg::units<32>() : wg::units<64>()) || (B / Bb) % rr || bmap < 0 || bmap > 3)
    return hopper::status(cudaErrorInvalidValue, 1);
  const int64_t qst[3] = {qsb, qss, qsh}, kst[3] = {ksb, kss, ksh}, vst[3] = {vsb, vss, vsh};
  const int64_t bst[4] = {bsb, bsh, bsq, bsk};
  const auto kv = static_cast<const int32_t*>(kvlen);
  auto s = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(D_, BK_) \
  wg::launch<D_, BK_>(q, k, v, bias, kv, o, B, Sq, Skv, Hq, Bb, qst, kst, vst, bst, scale, rr, bmap, s)
  if (D == 32 && bias_kind == 1) return WG_LAUNCH(32, 1);
  if (D == 32 && bias_kind == 2) return WG_LAUNCH(32, 2);
  if (D == 64 && bias_kind == 1) return WG_LAUNCH(64, 1);
  if (D == 64 && bias_kind == 2) return WG_LAUNCH(64, 2);
#undef WG_LAUNCH
  return hopper::status(cudaErrorInvalidValue, 1);
}
