// AAQ runtime quantization, token-wise: a group of lanes per token.
//
// Replaces the Pallas TPU kernel repro/kernels/aaq_quant/aaq_quant.py:
// aaq_quantize_pallas (body _quant_kernel), in two output forms that share
// one body:
//   aaq_quantize_launch   -> q (int4 nibble-packed or int8), scale, ovals,
//                            oidx: the input of aaq_matmul;
//   aaq_fake_quant_launch -> x_hat = dequantize(quantize(x)) in x's dtype
//                            and nothing else: the fold's fake-quant act.
// Semantics, bitwise with the plain versions (repro_torch/kernels/aaq_quant/
// ref.py): top-k of |x| (k <= 4), ties to the lower index, in descending
// order; outlier slots zeroed before the max; sigma = max(max|inlier| /
// qmax, 1e-12) with IEEE division; q = clip(rint(inl / sigma), +-qmax)
// (rint is round-half-even, as jnp.round); low nibble = even column; ovals
// rounded to bf16 (nearest even).  x_hat = q * sigma in float32, each
// outlier slot float(bf16(x)), rounded once to x's dtype.  No fast-math.
//
// Bound on the H100: bytes.  At the main path's (T, 128) bf16 input, 4 bits,
// k = 4, a call reads 2 B and writes ~0.7 B per value (x_hat: 2 B), 0.0068 ms
// at T = 65536.  A one-warp-per-token form is bound by instruction issue
// instead: k rounds of a 5-level shuffle argmax over three registers, ~65
// warp shuffles a token, scalar 2-byte loads and byte stores.  The design
// cuts the instructions a value takes (what still holds it above the bound:
// keys, sort, merge, rounding and packing for every value):
//   - A token gets G = pow2ceil(H / 16) lanes (8 at H = 128, so a warp
//     serves 4 tokens; 32 at H = 512), and each lane owns 16 consecutive
//     columns, read with 16-byte loads (two for bf16, four for f32).
//   - Each value becomes one integer key ordered as (|x| desc, column asc):
//     |x|'s bits, then 8192 - column, then the sign in bit 0 (so the key
//     also carries the value back).  bf16 input fits a 32-bit key (15 bits
//     of |x|), f32 a 64-bit one.  Absent columns are key 0, below all.
//   - A lane sorts its 16 keys in four quads (5 max/min pairs each) and
//     merges the sorted 4-lists in a tree; log2(G) butterfly levels then
//     merge the partners' lists the same way (elementwise max against the
//     reversed partner list, which is bitonic and holds the top 4 of the
//     union, then a 4-wide bitonic clean-up).  Keys are distinct, so the
//     order is total and ties resolve exactly as the reference's stable
//     sort; every lane of the group ends with the same list.  At H = 128
//     that is 3 levels of 4 shuffles for 4 tokens at once.
//   - Each lane marks the top-k columns it owns in a 16-bit mask; the
//     inlier max is one more butterfly of log2(G) shuffles.
//   - The inliers are divided by sigma through one IEEE reciprocal and a
//     product, with the IEEE division kept for the values whose product
//     lies near a rounding tie (see below): a per-value IEEE division costs
//     ~11 instructions, and on the fold's fake-quantized inputs (exact
//     zeros, values on a grid) it often takes its slow path.
//   - q leaves in one 8-byte (int4) or 16-byte (int8) store per lane, the
//     group's first lane writes scale, ovals (8 B) and oidx (16 B) with one
//     store each; x_hat leaves in 16-byte stores.
// Rows wider than 512 (the LM zoo's residual stream, up to 8,192 columns)
// take a second design, one warp per token (aaq_*_rows): each lane walks
// ceil(H / 512) chunks of 16 columns, strided by 512 so that a warp's
// 16-byte loads stay contiguous, folds each chunk's sorted 4-list into its
// running top 4, and the same 5-level butterfly merges the lanes.  The
// inlier max then needs no second walk over the row: the merges also
// carry the fifth largest key of what they have seen (the largest of the
// minima a merge drops), and the inlier max is the (k+1)-th key's |x| (the
// fifth for k = 4).  A second walk re-reads the row (from L2) to quantize
// and store; the row is never held whole in registers (at H = 6,144 in
// f32 that would be 192 values a lane).
// H <= 8,192; the rows must be 16-byte aligned (the wrapper checks), so H
// is a multiple of 8 (bf16) or 4 (f32); a ragged last lane is masked per
// 16-byte chunk, and q rows that are not a multiple of the vector width
// are stored byte by byte.  Token offsets are 64-bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int kCols = 16;                 // columns a lane owns (a chunk)
constexpr int kNarrowH = 32 * kCols;      // widest row of the lane-group design
constexpr int kMaxH = 8192;               // widest row (the key's column field)
constexpr unsigned kFull = 0xffffffffu;

// The key type of an input type: 15 bits of a bf16 |x| fit above the
// column field of a 32-bit key, an f32 |x| needs 64 bits.
template <typename T> struct Io;
template <> struct Io<bf16> { using Key = unsigned; };
template <> struct Io<float> { using Key = unsigned long long; };

// u: the value's float32 bits; col < kMaxH, so kMaxH - col fits bits 1-14,
// below a bf16 |x|'s 15 bits (16-30).
__device__ __forceinline__ unsigned make_key(unsigned u, int col, unsigned) {
  return (u & 0x7fff0000u) | (static_cast<unsigned>(kMaxH - col) << 1) | (u >> 31);
}
__device__ __forceinline__ unsigned long long make_key(unsigned u, int col,
                                                       unsigned long long) {
  return (static_cast<unsigned long long>(u & 0x7fffffffu) << 32) |
         (static_cast<unsigned>(kMaxH - col) << 1) | (u >> 31);
}
// The float32 bits and the column a key was made from.
__device__ __forceinline__ unsigned key_value(unsigned k) {
  return (k & 0x7fff0000u) | (k << 31);
}
__device__ __forceinline__ unsigned key_value(unsigned long long k) {
  return static_cast<unsigned>(k >> 32) | (static_cast<unsigned>(k) << 31);
}
template <typename Key> __device__ __forceinline__ int key_col(Key k) {
  return kMaxH - static_cast<int>((static_cast<unsigned>(k) >> 1) & 0x3fffu);
}

// hi >= lo afterwards.
template <typename Key> __device__ __forceinline__ void order(Key& hi, Key& lo) {
  const Key a = hi, b = lo;
  hi = a > b ? a : b;
  lo = a > b ? b : a;
}
// Sort four keys, descending (a 5-comparator network).
template <typename Key> __device__ __forceinline__ void sort4(Key (&a)[4]) {
  order(a[0], a[1]);
  order(a[2], a[3]);
  order(a[0], a[2]);
  order(a[1], a[3]);
  order(a[1], a[2]);
}
// a <- the top 4 of two descending 4-lists, descending: the elementwise max
// of a and reversed b is bitonic and holds the top 4; a half-cleaner and one
// more level sort it.
template <typename Key> __device__ __forceinline__ void merge4(Key (&a)[4], const Key (&b)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = a[j] > b[3 - j] ? a[j] : b[3 - j];
  order(a[0], a[2]);
  order(a[1], a[3]);
  order(a[0], a[1]);
  order(a[2], a[3]);
}

// merge4, and f <- the largest key of the union of a, b and f's set that
// the top 4 leave out: the minima of the half-cleaner's pairs are the
// union's bottom 4, so the fifth key is the largest of them or f.
template <typename Key>
__device__ __forceinline__ void merge4_fifth(Key (&a)[4], const Key (&b)[4], Key& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Key lo = a[j] > b[3 - j] ? b[3 - j] : a[j];
    f = f > lo ? f : lo;
  }
  merge4(a, b);
}

template <typename T> __device__ __forceinline__ void load_lane(const T* row, int c0, int h,
                                                                unsigned (&u)[kCols]);
template <> __device__ __forceinline__ void load_lane<bf16>(const bf16* row, int c0, int h,
                                                            unsigned (&u)[kCols]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (c0 + 8 * c < h) w = __ldg(reinterpret_cast<const uint4*>(row + c0 + 8 * c));
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[8 * c + 2 * j] = ws[j] << 16;
      u[8 * c + 2 * j + 1] = ws[j] & 0xffff0000u;
    }
  }
}
template <> __device__ __forceinline__ void load_lane<float>(const float* row, int c0, int h,
                                                             unsigned (&u)[kCols]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (c0 + 4 * c < h) w = __ldg(reinterpret_cast<const uint4*>(row + c0 + 4 * c));
    u[4 * c] = w.x; u[4 * c + 1] = w.y; u[4 * c + 2] = w.z; u[4 * c + 3] = w.w;
  }
}

// x_hat of one lane, from float32 values in[]: one rounding to T.
template <typename T> __device__ __forceinline__ void store_lane(T* row, int c0, int h,
                                                                 const float (&in)[kCols]);
template <> __device__ __forceinline__ void store_lane<bf16>(bf16* row, int c0, int h,
                                                             const float (&in)[kCols]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c0 + 8 * c >= h) continue;
    const float* v = in + 8 * c;
    *reinterpret_cast<uint4*>(row + c0 + 8 * c) =
        make_uint4(hopper::pack_bf16(v[0], v[1]), hopper::pack_bf16(v[2], v[3]),
                   hopper::pack_bf16(v[4], v[5]), hopper::pack_bf16(v[6], v[7]));
  }
}
template <> __device__ __forceinline__ void store_lane<float>(float* row, int c0, int h,
                                                              const float (&in)[kCols]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c0 + 4 * c >= h) continue;
    *reinterpret_cast<float4*>(row + c0 + 4 * c) =
        make_float4(in[4 * c], in[4 * c + 1], in[4 * c + 2], in[4 * c + 3]);
  }
}

// q = rint(v / sigma) of a lane's 16 values, 0 at the outlier columns
// (bit i of outs), with the IEEE quotient but without dividing each value:
// |v / sigma| <= qmax < 128 for an inlier, and v * RN(1 / sigma) lies
// within 1.5 * 2^-23 * 128 < 2^-15 of the rounded quotient, so both round
// to the same integer unless the product lies within 2^-13 of a
// half-integer.  Those values (rare), and every value of a token whose
// 1 / sigma would be subnormal, take the IEEE division.  Outliers' q is 0
// whatever their product.
__device__ __forceinline__ void quant_lane(const unsigned (&u)[kCols], unsigned outs,
                                           float sigma, float rcp, bool tiny_rcp, float qm,
                                           int (&qi)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const float v = __uint_as_float(u[i]);
    float p = __fmul_rn(v, rcp);
    if (tiny_rcp || fabsf(p - (floorf(p) + 0.5f)) < 0x1p-13f) p = v / sigma;
    qi[i] = outs >> i & 1u ? 0 : static_cast<int>(fminf(fmaxf(rintf(p), -qm), qm));
  }
}

// x_hat of a lane: q * sigma in float32, each outlier float(bf16(x)),
// rounded once to T.
template <typename T>
__device__ __forceinline__ void store_fake_lane(T* row, int c0, int h, const unsigned (&u)[kCols],
                                                unsigned outs, const int (&qi)[kCols],
                                                float sigma) {
  float r[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    r[i] = outs >> i & 1u ? __bfloat162float(__float2bfloat16_rn(__uint_as_float(u[i])))
                          : static_cast<float>(qi[i]) * sigma;
  store_lane<T>(row, c0, h, r);
}

// q of a lane's 16 columns: 8 bytes (int4, low nibble = even column) or
// 16 bytes (int8).
__device__ __forceinline__ void store_q_lane(int8_t* __restrict__ q, int64_t token, int c0,
                                             int h, int bits, const int (&qi)[kCols]) {
  if (bits == 4) {
    unsigned w[2] = {0, 0};
#pragma unroll
    for (int b = 0; b < 8; ++b)
      w[b >> 2] |= static_cast<unsigned>((qi[2 * b] & 0x0F) | ((qi[2 * b + 1] & 0x0F) << 4))
                   << (8 * (b & 3));
    int8_t* dst = q + token * (h / 2) + c0 / 2;
    if (h % 16 == 0) {                    // 8-byte aligned rows; lanes are whole or absent
      if (c0 < h) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (c0 + 2 * b < h) dst[b] = static_cast<int8_t>(w[b >> 2] >> (8 * (b & 3)));
    }
  } else {
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      w[i >> 2] |= static_cast<unsigned>(qi[i] & 0xFF) << (8 * (i & 3));
    int8_t* dst = q + token * h + c0;
    if (h % 16 == 0) {
      if (c0 < h) *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (c0 + i < h) dst[i] = static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3)));
    }
  }
}

// A token's scale and outliers (ovals, oidx: (T, max(k,1)); k = 0 writes
// zero dummies), from its top-4 keys t, by one lane.
template <typename Key>
__device__ __forceinline__ void store_meta(float* __restrict__ scale, bf16* __restrict__ ovals,
                                           int32_t* __restrict__ oidx, int64_t token,
                                           float sigma, const Key (&t)[4], int k) {
  scale[token] = sigma;
  if (k == 4) {
    unsigned short ob[4];
    int oc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ob[j] = __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(key_value(t[j]))));
      oc[j] = key_col(t[j]);
    }
    *reinterpret_cast<uint2*>(ovals + token * 4) =
        make_uint2(ob[0] | (static_cast<unsigned>(ob[1]) << 16),
                   ob[2] | (static_cast<unsigned>(ob[3]) << 16));
    *reinterpret_cast<int4*>(oidx + token * 4) = make_int4(oc[0], oc[1], oc[2], oc[3]);
  } else if (k == 0) {                    // (T, 1) zero dummies
    ovals[token] = __float2bfloat16_rn(0.f);
    oidx[token] = 0;
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= k) break;
      ovals[token * k + j] = __float2bfloat16_rn(__uint_as_float(key_value(t[j])));
      oidx[token * k + j] = key_col(t[j]);
    }
  }
}

// The top-k columns among a lane's 16 from column c0: bit i for c0 + i.
template <typename Key>
__device__ __forceinline__ unsigned outlier_mask(const Key (&t)[4], int k, int c0) {
  unsigned outs = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned d = static_cast<unsigned>(key_col(t[j]) - c0);
    if (j < k && d < kCols) outs |= 1u << d;
  }
  return outs;
}

// A lane's 16 keys from column c0 (absent columns: key 0), sorted into the
// lane's top 4, descending; f takes the largest key left out.
template <typename Key>
__device__ __forceinline__ void lane_top4(const unsigned (&u)[kCols], int c0, int h,
                                          Key (&top)[4], Key& f) {
  Key quad[4][4];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    quad[i / 4][i % 4] = c0 + i < h ? make_key(u[i], c0 + i, Key{}) : Key{0};
#pragma unroll
  for (int j = 0; j < 4; ++j) sort4(quad[j]);
  merge4_fifth(quad[0], quad[1], f);
  merge4_fifth(quad[2], quad[3], f);
  merge4_fifth(quad[0], quad[2], f);
#pragma unroll
  for (int j = 0; j < 4; ++j) top[j] = quad[0][j];
}

// G lanes per token (a power of two, G * 16 >= H, H <= 512).  kFake: write
// x_hat only; otherwise q, scale, ovals (T, max(k,1)) and oidx (T, max(k,1)).
template <typename T, int G, bool kFake>
__device__ __forceinline__ void quant_body(const T* __restrict__ x, int8_t* __restrict__ q,
                                           float* __restrict__ scale,
                                           bf16* __restrict__ ovals,
                                           int32_t* __restrict__ oidx, T* __restrict__ xhat,
                                           int n_tokens, int h, int bits, int k) {
  using Key = typename Io<T>::Key;
  const int gl = threadIdx.x & (G - 1);
  const int64_t token = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = token < n_tokens;     // dead groups still join the shuffles
  const int c0 = gl * kCols;

  unsigned u[kCols];                      // float32 bits of the lane's values
  if (live) {
    load_lane<T>(x + token * h, c0, h, u);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) u[i] = 0;
  }

  // top 4 keys of the token, descending, on every lane of the group: four
  // sorted quads of the lane's keys merged in a tree, then log2(G) butterfly
  // levels across the group
  Key t[4] = {0, 0, 0, 0};
  unsigned outs = 0;                      // bit i: column c0 + i is an outlier
  if (k > 0) {
    Key unused = 0;
    lane_top4(u, c0, h, t, unused);
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      Key p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = __shfl_xor_sync(kFull, t[j], off);
      merge4(t, p);
    }
    outs = outlier_mask(t, k, c0);
  }

  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    if (!(outs >> i & 1u)) m = fmaxf(m, fabsf(__uint_as_float(u[i])));
#pragma unroll
  for (int off = 1; off < G; off <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (!live) return;

  const float qm = static_cast<float>((1 << (bits - 1)) - 1);
  const float sigma = fmaxf(m / qm, kEps);          // IEEE division (no fast-math)
  int qi[kCols];
  quant_lane(u, outs, sigma, 1.f / sigma, !(sigma < 0x1p+120f), qm, qi);
  if constexpr (kFake) {
    store_fake_lane<T>(xhat + token * h, c0, h, u, outs, qi, sigma);
    return;
  }
  store_q_lane(q, token, c0, h, bits, qi);
  if (gl == 0) store_meta(scale, ovals, oidx, token, sigma, t, k);
}

// One warp per token, H in (512, 8192]: a lane owns columns c0 + 16 of
// every 512-column chunk (c0 = 16 * lane).  The first walk gives the top 4
// keys and the fifth (k > 0), or the row's max |x| (k = 0); the second
// re-reads the row to quantize and store.  Outputs as quant_body's.
template <typename T, bool kFake>
__device__ __forceinline__ void quant_rows_body(const T* __restrict__ x,
                                                int8_t* __restrict__ q,
                                                float* __restrict__ scale,
                                                bf16* __restrict__ ovals,
                                                int32_t* __restrict__ oidx,
                                                T* __restrict__ xhat, int n_tokens, int h,
                                                int bits, int k) {
  using Key = typename Io<T>::Key;
  const int lane = threadIdx.x & 31;
  const int64_t token = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  if (token >= n_tokens) return;          // the whole warp: no shuffle is left waiting
  const T* row = x + token * h;
  const int n_chunks = (h + kNarrowH - 1) / kNarrowH;

  Key t[4] = {0, 0, 0, 0};
  Key fifth = 0;                          // largest key outside t
  float mx = 0.f;                         // k = 0: max |x| of the row
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kNarrowH + lane * kCols;
    unsigned u[kCols];
    load_lane<T>(row, c0, h, u);
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) mx = fmaxf(mx, fabsf(__uint_as_float(u[i])));
      continue;
    }
    Key c[4];
    lane_top4(u, c0, h, c, fifth);
    merge4_fifth(t, c, fifth);
  }
  float m;
  if (k > 0) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Key p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = __shfl_xor_sync(kFull, t[j], off);
      const Key pf = __shfl_xor_sync(kFull, fifth, off);
      fifth = fifth > pf ? fifth : pf;
      merge4_fifth(t, p, fifth);
    }
    // the inlier max: the |x| of the (k+1)-th key (key 0, no such column: 0)
    const Key next = k == 1 ? t[1] : k == 2 ? t[2] : k == 3 ? t[3] : fifth;
    m = fabsf(__uint_as_float(key_value(next)));
  } else {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    m = mx;
  }

  const float qm = static_cast<float>((1 << (bits - 1)) - 1);
  const float sigma = fmaxf(m / qm, kEps);          // IEEE division (no fast-math)
  const float rcp = 1.f / sigma;
  const bool tiny_rcp = !(sigma < 0x1p+120f);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kNarrowH + lane * kCols;
    if (c0 >= h) break;
    unsigned u[kCols];
    load_lane<T>(row, c0, h, u);
    const unsigned outs = outlier_mask(t, k, c0);
    int qi[kCols];
    quant_lane(u, outs, sigma, rcp, tiny_rcp, qm, qi);
    if constexpr (kFake) {
      store_fake_lane<T>(xhat + token * h, c0, h, u, outs, qi, sigma);
    } else {
      store_q_lane(q, token, c0, h, bits, qi);
    }
  }
  if (!kFake && lane == 0) store_meta(scale, ovals, oidx, token, sigma, t, k);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
aaq_quantize_lanes(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                   bf16* __restrict__ ovals, int32_t* __restrict__ oidx, int n_tokens, int h,
                   int bits, int k) {
  quant_body<T, G, false>(x, q, scale, ovals, oidx, nullptr, n_tokens, h, bits, k);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
aaq_fake_quant_lanes(const T* __restrict__ x, T* __restrict__ xhat, int n_tokens, int h,
                     int bits, int k) {
  quant_body<T, G, true>(x, nullptr, nullptr, nullptr, nullptr, xhat, n_tokens, h, bits, k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aaq_quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                  bf16* __restrict__ ovals, int32_t* __restrict__ oidx, int n_tokens, int h,
                  int bits, int k) {
  quant_rows_body<T, false>(x, q, scale, ovals, oidx, nullptr, n_tokens, h, bits, k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aaq_fake_quant_rows(const T* __restrict__ x, T* __restrict__ xhat, int n_tokens, int h,
                    int bits, int k) {
  quant_rows_body<T, true>(x, nullptr, nullptr, nullptr, nullptr, xhat, n_tokens, h, bits, k);
}

// Lanes a token takes: the least power of two with 16 columns each >= h
// (32, a warp, for every H above 512).
int lanes_for(int h) {
  int g = 1;
  while (g < 32 && g * kCols < h) g <<= 1;
  return g;
}

dim3 grid_for(int n_tokens, int g) {
  return dim3(static_cast<unsigned>((static_cast<int64_t>(n_tokens) * g + kThreads - 1) /
                                    kThreads));
}

template <typename T>
void launch_quantize(const void* x, void* q, void* scale, void* ovals, void* oidx,
                     int n_tokens, int h, int bits, int k, cudaStream_t s) {
  const int g = lanes_for(h);
  auto* xp = static_cast<const T*>(x);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  auto* op = static_cast<bf16*>(ovals);
  auto* ip = static_cast<int32_t*>(oidx);
  if (h > kNarrowH) {
    aaq_quantize_rows<T><<<grid_for(n_tokens, 32), kThreads, 0, s>>>(
        xp, qp, sp, op, ip, n_tokens, h, bits, k);
    return;
  }
#define AAQ_Q(G) aaq_quantize_lanes<T, G><<<grid_for(n_tokens, G), kThreads, 0, s>>>( \
      xp, qp, sp, op, ip, n_tokens, h, bits, k)
  switch (g) {
    case 1: AAQ_Q(1); break;
    case 2: AAQ_Q(2); break;
    case 4: AAQ_Q(4); break;
    case 8: AAQ_Q(8); break;
    case 16: AAQ_Q(16); break;
    default: AAQ_Q(32); break;
  }
#undef AAQ_Q
}

template <typename T>
void launch_fake_quant(const void* x, void* xhat, int n_tokens, int h, int bits, int k,
                       cudaStream_t s) {
  const int g = lanes_for(h);
  auto* xp = static_cast<const T*>(x);
  auto* op = static_cast<T*>(xhat);
  if (h > kNarrowH) {
    aaq_fake_quant_rows<T><<<grid_for(n_tokens, 32), kThreads, 0, s>>>(
        xp, op, n_tokens, h, bits, k);
    return;
  }
#define AAQ_F(G) aaq_fake_quant_lanes<T, G><<<grid_for(n_tokens, G), kThreads, 0, s>>>( \
      xp, op, n_tokens, h, bits, k)
  switch (g) {
    case 1: AAQ_F(1); break;
    case 2: AAQ_F(2); break;
    case 4: AAQ_F(4); break;
    case 8: AAQ_F(8); break;
    case 16: AAQ_F(16); break;
    default: AAQ_F(32); break;
  }
#undef AAQ_F
}

bool args_ok(int h, int bits, int k) {
  return h > 0 && h <= kMaxH && (bits == 4 || bits == 8) && !(bits == 4 && h % 2) &&
         k >= 0 && k <= 4 && k <= h;
}

}  // namespace

// x (T, H) bf16 or f32, contiguous, 16-byte aligned rows; H <= 8192, even
// when bits == 4; k <= 4.  q (T, H/2 or H) int8; scale (T) f32; ovals
// (T, max(k,1)) bf16; oidx (T, max(k,1)) int32.  Returns a launch status
// (hopper::status).
extern "C" int aaq_quantize_launch(const void* x, int x_is_bf16, void* q, void* scale,
                                   void* ovals, void* oidx, int n_tokens, int h,
                                   int bits, int k, void* stream) {
  if (n_tokens == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!args_ok(h, bits, k)) return hopper::status(cudaErrorInvalidValue, 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch_quantize<bf16>(x, q, scale, ovals, oidx, n_tokens, h, bits, k, s);
  else
    launch_quantize<float>(x, q, scale, ovals, oidx, n_tokens, h, bits, k, s);
  return hopper::status(cudaGetLastError(), 4);
}

// The fake-quant form: xhat (T, H) in x's dtype, as aaq_quantize_launch's
// arguments otherwise.
extern "C" int aaq_fake_quant_launch(const void* x, int x_is_bf16, void* xhat, int n_tokens,
                                     int h, int bits, int k, void* stream) {
  if (n_tokens == 0) return 0;
  HOPPER_RETURN_IF_PENDING();
  if (!args_ok(h, bits, k)) return hopper::status(cudaErrorInvalidValue, 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch_fake_quant<bf16>(x, xhat, n_tokens, h, bits, k, s);
  else
    launch_fake_quant<float>(x, xhat, n_tokens, h, bits, k, s);
  return hopper::status(cudaGetLastError(), 4);
}
