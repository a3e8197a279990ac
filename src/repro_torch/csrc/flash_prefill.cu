// Prefill attention for Hopper: many query rows, no bias, causal, sliding
// window, GQA/MQA and kv_valid_len.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py: flash_mha_pallas (body
// _flash_kernel) at its prefill calls: q (B, Sq > 1, Hq, D) bf16, k, v (B,
// Skv, Hkv, D) bf16, D in {64, 96, 128, 192, 256} (the model zoo: whisper
// 64, phi-3 96, mixtral and qwen 128, DeepSeek's MLA 192, RecurrentGemma
// 256), no bias, a positive softmax scale (the wrapper's variant_for sends
// only those here).  The same function as the other variants: masked keys
// get probability exactly 0, the (m, l, o) state is float32, a row with no
// valid key returns 0, the output is o / max(l, 1e-30) in bf16.
//
// Bound on the H100: operations at these lengths (mixtral's 4,608 causal
// rows in a 4,096 window: 0.26 ms of bf16 tensor work against 0.05 ms of
// bytes), bytes at the short ones.  The tensor-core kernel this replaces
// gave a block 64 query rows and one head at D >= 96, streamed K/V through
// a two-stage cp.async ring into mma.sync, predicated every tile that was
// not whole, and at D > 128 halved its key tile and reloaded Q every tile.
// The design, the fold kernel's (flash_attention.cu, namespace wg) without the bias:
//   - A block owns 128 query rows of one head (192 at D = 64): two consumer
//     warpgroups of 64 rows (three at D = 64), which share every K/V tile,
//     and a producer warpgroup whose one thread keeps TMA loads in flight:
//     Q once, then K and V tiles of 64 keys into an mbarrier ring (2 stages
//     at D = 256, 3 at 192, 4 below).  Where the block's rows fit one
//     warpgroup (a short query, whisper's 64 decoder rows against 1,500
//     frames), every warpgroup takes those rows and every NC-th key tile,
//     and warpgroup 0 merges the others' (m, l, o) in order.  Tiles
//     are D/64 boxes of 64 columns, 128-byte swizzled (D/32 boxes of 32,
//     64-byte swizzled, at D = 96), as the wgmma descriptors read them.
//   - setmaxnreg: the producer warpgroup drops to 24 registers, the
//     consumers rise to 240 (160 with three), so the O accumulator (D/2
//     floats a thread: 128 at D = 256) stays in registers beside S and P.
//   - S = Q K^T by wgmma (m64n64k16, both from shared memory); the softmax
//     in the log2 domain, one FFMA and one ex2 a logit (the scale is
//     positive, so the row max of S is the max of the scaled logits); O is
//     rescaled only where a row's max moved.
//   - P V by wgmma with P from registers, split into bf16 hi + lo as every
//     flash variant splits it (P keeps ~16 bits), into one float32
//     accumulator a 64-column (32 at D = 96) panel of V.
//   - Masks: a warpgroup skips the key tiles its rows cannot see (past the
//     causal edge, before the window, past kv_valid_len) and predicates only
//     the tiles a mask crosses; the blocks of the last (longest) causal
//     query tiles are launched first.
//   - No atomics: every row's sums run in one order, whatever else the block
//     holds, so a batch row launched alone is bitwise its row of a batch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

namespace pf {

constexpr int BQ = 64, BK = 64;             // query rows a consumer warpgroup, keys a stage
constexpr int PRODUCER_REGS = 24;           // the producer warpgroup's registers a thread
constexpr int SMEM_LIMIT = 232448;          // opt-in shared memory of one H100 block
constexpr int MAX_STAGES = 4;

// consumer warpgroups a block, sharing every K/V tile: three at D = 64 (the
// O accumulator is 32 floats a thread, so 160 registers do), which puts
// whisper's 1,500 encoder rows a head in 8 blocks of 192 rows (one wave on
// 132 SMs) where blocks of 128 rows made 1.5 waves
template <int D> __host__ __device__ constexpr int consumers() { return D == 64 ? 3 : 2; }
template <int D> __host__ __device__ constexpr int threads() { return (consumers<D>() + 1) * 128; }
// registers a consumer thread after setmaxnreg: what the producer warpgroup
// gives up (the block launches at 65,536 / threads a thread, rounded down
// to 8: 168 with two consumer warpgroups, 128 with three)
template <int D> __host__ __device__ constexpr int consumer_regs() {
  return (((65536 / threads<D>()) / 8 * 8 * (consumers<D>() + 1) - PRODUCER_REGS) /
          consumers<D>()) / 8 * 8;
}
// columns of a TMA box and a wgmma panel: one 128-byte swizzle row, or
// 64 bytes where D is not a multiple of 64
template <int D> __host__ __device__ constexpr int panel() { return D % 64 == 0 ? 64 : 32; }
template <int D> __host__ __device__ constexpr int q_bytes() { return BQ * D * 2; }
template <int D> __host__ __device__ constexpr int kv_bytes() { return BK * D * 2; }
// alignment slack, the Q tiles, the K/V ring, the barriers
template <int D> __host__ __device__ constexpr int smem_bytes(int nst) {
  return 1024 + consumers<D>() * q_bytes<D>() + nst * 2 * kv_bytes<D>() + 256;
}
template <int D> __host__ __device__ constexpr int stages() {
  int n = MAX_STAGES;
  while (n > 2 && smem_bytes<D>(n) > SMEM_LIMIT) --n;
  return n;
}

struct Params {
  bf16* o;
  const int32_t* kvlen;
  int B, Sq, Skv, Hq, G;                    // G = Hq / Hkv
  int nqt;                                  // query tiles of consumers<D>() * BQ rows
  int causal, window;                       // window < 0: none
  float cs;                                 // softmax scale * log2(e), > 0
};

// P (accumulator chunks 2j, 2j + 1 of S: keys 16j..16j + 15) as bf16 A
// fragments, hi + lo
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], int j, unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = 8 * j + 4 * (r >> 1) + 2 * (r & 1);   // (chunk 2j + r/2, row half r%2)
    hopper::split_bf16(s[e], s[e + 1], hi[r], lo[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(threads<D>(), 1)
flash_pf_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int NC = consumers<D>(), NCONS = NC * 128;
  constexpr int CONSUMER_REGS = consumer_regs<D>();
  constexpr int PW = panel<D>(), NP = D / PW, NST = stages<D>();
  constexpr int QP = BQ * PW * 2, KP = BK * PW * 2;    // bytes of a Q / K or V panel
  constexpr int QB = q_bytes<D>(), KB = kv_bytes<D>();
  constexpr int SW = PW == 64 ? hopper::SWIZZLE_128B : hopper::SWIZZLE_64B;
  constexpr unsigned GROUP8 = 8 * PW * 2;              // bytes of 8 rows of a panel
  constexpr int KSTEPS = PW / 16;                      // k16 steps a panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;                            // [NC] Q tiles of [NP] panels
  unsigned char* stg = qs + NC * QB;                   // [NST] {K [NP], V [NP]}
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + NST * 2 * KB);
  uint64_t* empty = full + NST;                        // the consumers are done with a stage
  uint64_t* qbar = empty + NST;

  // the block's query tile, head and batch row: the last tiles first
  const int bx = blockIdx.x, hb = bx % (p.Hq * p.B);
  const int qt = p.nqt - 1 - bx / (p.Hq * p.B);
  const int h = hb / p.B, b = hb % p.B, hk = h / p.G;
  const int q0 = qt * NC * BQ;
  int kv_end = p.Skv;
  if (p.kvlen) kv_end = min(kv_end, max(p.kvlen[b], 0));
  // the keys some row of the block sees: [lo, hi)
  const int hi = p.causal ? min(kv_end, min(p.Sq, q0 + NC * BQ)) : kv_end;
  const int lo = p.window >= 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_first = lo / BK * BK;
  const int ntiles = hi > k_first ? (hi - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NCONS / 32);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // producer warpgroup: one thread keeps the ring's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) {
      hopper::mbar_expect_tx(qbar, NC * QB);
      for (int w = 0; w < NC; ++w)
        for (int pp = 0; pp < NP; ++pp)
          hopper::tma_load_4d(qs + w * QB + pp * QP, &tq, qbar, pp * PW, h, q0 + w * BQ, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NST, k0 = k_first + t * BK;
        hopper::mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * KB);
        unsigned char* ks = stg + st * 2 * KB;
        unsigned char* vs = ks + KB;
        for (int pp = 0; pp < NP; ++pp) {
          hopper::tma_load_4d(ks + pp * KP, &tk, &full[st], pp * PW, hk, k0, b);
          hopper::tma_load_4d(vs + pp * KP, &tv, &full[st], pp * PW, hk, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w computes query rows q0 + 64w .. + 63, or, where
  // the block's rows fit the first warpgroup's tile (a short query:
  // whisper's 64-token decoder), those rows over every NC-th key tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int w = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, c = lane & 3;
  const bool kv_split = NC > 1 && p.Sq - q0 <= BQ;
  const int rw = kv_split ? 0 : w;                      // the warpgroup's row tile
  const int r0 = q0 + rw * BQ, row_a = r0 + 16 * wi + g;  // this thread's rows: row_a, + 8
  const bool rows_in = r0 < p.Sq;
  const int w_hi = p.causal ? min(hi, r0 + BQ) : hi;
  const int w_lo = p.window >= 0 ? max(0, r0 - p.window + 1) : 0;
  const float cs = p.cs;
  float o[NP][PW / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int j = 0; j < PW / 2; ++j) o[pp][j] = 0.f;
  const unsigned char* qw = qs + rw * QB;
  hopper::mbar_wait(qbar, 0);

  // tile by tile: issuing the next tile's Q K^T under this tile's softmax
  // ran 5-10% slower (the other consumer warpgroup already fills the tensor
  // cores' idle time) and spilled at D = 256
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NST, k0 = k_first + t * BK;
    hopper::mbar_wait(&full[st], (t / NST) & 1);
    if (rows_in && k0 < w_hi && k0 + BK > w_lo && (!kv_split || t % NC == w)) {  // uniform
      const unsigned char* ks = stg + st * 2 * KB;
      const unsigned char* vs = ks + KB;
      float s[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
      hopper::reg_fence(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pp = kk / KSTEPS, sub = kk % KSTEPS;
        hopper::wgmma_m64n64k16_ss(s, hopper::wgmma_desc(qw + pp * QP, SW, GROUP8) + 2 * sub,
                                   hopper::wgmma_desc(ks + pp * KP, SW, GROUP8) + 2 * sub,
                                   kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(s);
      // a tile that a mask crosses: each logit's predicate
      unsigned good = 0xffffffffu;
      if (k0 + BK > kv_end || (p.causal && k0 + BK - 1 > r0) ||
          (p.window >= 0 && k0 <= r0 + BQ - 1 - p.window)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1), row = row_a + 8 * ((e >> 1) & 1);
          bool ok = key < kv_end;
          if (p.causal) ok = ok && key <= row;
          if (p.window >= 0) ok = ok && key > row - p.window;
          if (!ok) {
            good &= ~(1u << e);
            s[e] = NEG;
          }
        }
      }
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], s[e]);
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
        mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
        const float m_new = fmaxf(m[hf], mt[hf]);
        alpha[hf] = hopper::ex2((m[hf] - m_new) * cs);
        mc[hf] = m_new * cs;
        m[hf] = m_new;
      }
      // a masked logit's probability is exactly 0, also on a row that has
      // seen no valid key yet (its max is still NEG)
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int hf = (e >> 1) & 1;
        s[e] = (good >> e) & 1u ? hopper::ex2(fmaf(s[e], cs, -mc[hf])) : 0.f;
        rs[hf] += s[e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = alpha[hf] * l[hf] + rs[hf];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
#pragma unroll
          for (int j = 0; j < PW / 2; ++j) o[pp][j] *= alpha[(j >> 1) & 1];
      }
      unsigned phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) split_p(s, j, phi[j], plo[j]);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) hopper::reg_fence(o[pp]);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          // keys 16j..16j + 15 of V's panel pp
          const uint64_t dv = hopper::wgmma_desc(vs + pp * KP, SW, GROUP8) +
                              ((16 * PW * 2 * j) >> 4);
          if constexpr (PW == 64) {
            hopper::wgmma_m64n64k16_rs(o[pp], phi[j], dv);
            hopper::wgmma_m64n64k16_rs(o[pp], plo[j], dv);
          } else {
            hopper::wgmma_m64n32k16_rs(o[pp], phi[j], dv);
            hopper::wgmma_m64n32k16_rs(o[pp], plo[j], dv);
          }
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) hopper::reg_fence(o[pp]);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        hopper::reg_fence(phi[j]);
        hopper::reg_fence(plo[j]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  if (kv_split) {
    // warpgroups 1.. hand their (m, l, o) to warpgroup 0 through the ring
    // (every tile consumed), which merges them in order, thread by thread:
    // each thread's fragment positions are the same in every warpgroup
    constexpr int PART = D / 2 + 4;                     // floats a thread: o, m, l
    float* part = reinterpret_cast<float*>(stg);
    hopper::named_sync(1, NCONS);
    if (w > 0) {
      float* mine = part + ((w - 1) * 128 + tw) * PART;
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
#pragma unroll
        for (int j = 0; j < PW / 2; ++j) mine[pp * (PW / 2) + j] = o[pp][j];
      mine[D / 2] = m[0];
      mine[D / 2 + 1] = m[1];
      mine[D / 2 + 2] = l[0];
      mine[D / 2 + 3] = l[1];
    }
    hopper::named_sync(1, NCONS);
    if (w > 0) return;
    for (int u = 1; u < NC; ++u) {
      const float* theirs = part + ((u - 1) * 128 + tw) * PART;
      float a[2], b2[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mu = theirs[D / 2 + hf], mx = fmaxf(m[hf], mu);
        a[hf] = hopper::ex2((m[hf] - mx) * cs);
        b2[hf] = hopper::ex2((mu - mx) * cs);
        m[hf] = mx;
        l[hf] = l[hf] * a[hf] + theirs[D / 2 + 2 + hf] * b2[hf];
      }
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
#pragma unroll
        for (int j = 0; j < PW / 2; ++j) {
          const int hf = (j >> 1) & 1;
          o[pp][j] = o[pp][j] * a[hf] + theirs[pp * (PW / 2) + j] * b2[hf];
        }
    }
  }

  // o / max(l, 1e-30), 4 bytes a store (two columns of one row)
  bf16* og = p.o;
  float d[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lsum = l[hf];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    d[hf] = fmaxf(lsum, 1e-30f);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    if (row >= p.Sq) continue;
    bf16* orow = og + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int j = 0; j < PW / 8; ++j)
        *reinterpret_cast<unsigned*>(orow + pp * PW + 8 * j + 2 * c) =
            hopper::pack_bf16(o[pp][4 * j + 2 * hf] / d[hf], o[pp][4 * j + 2 * hf + 1] / d[hf]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int32_t* kvlen, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, const int64_t* qst, const int64_t* kst,
           const int64_t* vst, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int NST = stages<D>(), NC = consumers<D>();
  constexpr int SMEM = smem_bytes<D>(NST);
  constexpr int PW = panel<D>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_pf_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return hopper::status(err, 2);
    attr = true;
  }
  constexpr CUtensorMapSwizzle SWZ =
      PW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  // q, k, v: (D, H, S, B) boxes of (PW, 1, 64 rows, 1)
  const uint64_t qd[4] = {D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
  const uint64_t kd[4] = {D, (uint64_t)Hkv, (uint64_t)Skv, (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)qst[2] * 2, (uint64_t)qst[1] * 2, (uint64_t)qst[0] * 2};
  const uint64_t ks[3] = {(uint64_t)kst[2] * 2, (uint64_t)kst[1] * 2, (uint64_t)kst[0] * 2};
  const uint64_t vs[3] = {(uint64_t)vst[2] * 2, (uint64_t)vst[1] * 2, (uint64_t)vst[0] * 2};
  const uint32_t qbox[4] = {PW, 1, BQ, 1}, kbox[4] = {PW, 1, BK, 1};
  if (!(hopper::encode(&tq, BF, 4, q, qd, qs, qbox, SWZ) &&
        hopper::encode(&tk, BF, 4, k, kd, ks, kbox, SWZ) &&
        hopper::encode(&tv, BF, 4, v, kd, vs, kbox, SWZ)))
    return hopper::status(cudaErrorInvalidValue, 5);
  const int nqt = (Sq + NC * BQ - 1) / (NC * BQ);
  const Params p{static_cast<bf16*>(o), kvlen, B, Sq, Skv, Hq, Hq / Hkv, nqt, causal, window,
                 scale * LOG2E};
  const long long blocks = static_cast<long long>(nqt) * Hq * B;
  if (blocks >= (1ll << 31)) return hopper::status(cudaErrorInvalidValue, 3);
  flash_pf_kernel<D><<<dim3(static_cast<unsigned>(blocks)), dim3(threads<D>()), SMEM, stream>>>(
      tq, tk, tv, p);
  return hopper::status(cudaGetLastError(), 4);
}

}  // namespace pf
}  // namespace

// flash_mha_pf_launch: bf16 q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), D in
// {64, 96, 128, 192, 256}, no bias (bias_kind 0), a positive softmax scale,
// causal and window (< 0: none) as the other variants take them; strides in
// elements, the head dim of q, k, v with unit stride, every base pointer and
// (b, s, h) stride a multiple of 16 bytes (TMA); o a contiguous (B, Sq, Hq,
// D) bf16 tensor; kvlen null or (B,) int32.  Returns the launch status
// (hopper::status).
extern "C" int flash_mha_pf_launch(const void* q, const void* k, const void* v,
                                   const void* bias, const void* kvlen, void* o, int qkv_is_bf16,
                                   int bias_kind, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                   int Bb, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                                   int64_t vsh, int64_t bsb, int64_t bsh, int64_t bsq,
                                   int64_t bsk, int causal, int window, float scale,
                                   void* stream) {
  (void)Bb; (void)bsb; (void)bsh; (void)bsq; (void)bsk;
  if (B == 0 || Sq == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!qkv_is_bf16 || bias || bias_kind || Hkv <= 0 || Hq % Hkv || !(scale > 0.f))
    return hopper::status(cudaErrorInvalidValue, 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (Skv == 0)          // no key: every row returns 0, as the plain version does
    return hopper::status(
        cudaMemsetAsync(o, 0, static_cast<size_t>(B) * Sq * Hq * D * sizeof(bf16), s), 4);
  const int64_t qst[3] = {qsb, qss, qsh}, kst[3] = {ksb, kss, ksh}, vst[3] = {vsb, vss, vsh};
  const auto kv = static_cast<const int32_t*>(kvlen);
#define PF_LAUNCH(D_) \
  pf::launch<D_>(q, k, v, kv, o, B, Sq, Skv, Hq, Hkv, qst, kst, vst, causal, window, scale, s)
  switch (D) {
    case 64: return PF_LAUNCH(64);
    case 96: return PF_LAUNCH(96);
    case 128: return PF_LAUNCH(128);
    case 192: return PF_LAUNCH(192);
    case 256: return PF_LAUNCH(256);
    default: return hopper::status(cudaErrorInvalidValue, 1);
  }
#undef PF_LAUNCH
}
