// The complex tile product on Hopper's tensor cores, shared by K3 and K4:
// a warp multiplies a complex64 tile of A (16 MT rows x 8 k) by one of B
// (8 k x 8 NT columns), with a 3xTF32 split of every real operand:
// x = hi + lo, hi the nearest TF32 value (10 mantissa bits) and lo the
// nearest TF32 value to x - hi, so x is kept to about 2^-22 |x|.  Each real
// product is lo*hi + hi*lo + hi*hi (lo*lo, of order 2^-22, is dropped):
// three `mma.sync.m16n8k8` TF32 products accumulated in fp32.  Plain TF32
// keeps three decimal digits, too few for the reference's bars (1e-5 for
// K4, 2e-5 for K3); the split keeps fp32-class accuracy.
//
// Two forms of the complex product, a template flag GAUSS:
//   * Gauss (true): three real products on the planes,
//       P1 = Ar Br,  P2 = Ai Bi,  P3 = (Ar + Ai)(Br + Bi),
//       C = (P1 - P2) + i (P3 - P1 - P2),
//     9 tensor-core products per 16x8x8 step; each operand is split into
//     three planes (re, im, re + im): 10 ALU instructions per element.
//   * four-product (false): Cr = Ar Br - Ai Bi, Ci = Ar Bi + Ai Br,
//     12 tensor-core products per step; A is split into re and im plus one
//     negated plane (two sign flips of the split), B into re and im: 8 and
//     6 ALU instructions per element.
// The split runs in registers after every fragment load, once per warp
// that reads an element, and at the warp tiles K3 uses it costs more issue
// slots than the tensor-core products it feeds; the four-product form
// trades 33% more products for fewer split instructions.  K4 keeps the
// Gauss form of the TPU kernel it replaces.
//
// Long sums are promoted to ordinary fp32 registers every few steps
// (promote below).  Conjugating B (CONJ_B, four-product form only) costs
// nothing: it picks which plane of A is negated.
//
// Fragment layout of m16n8k8 TF32 (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), with g = lane / 4 and c = lane % 4:
//   A (16 x 8, row): a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B (8 x 8, col):  b0 (c, g), b1 (c + 4, g)
//   C (16 x 8):      c0 (g, 2c), c1 (g, 2c + 1), c2 (g + 8, 2c), c3 (g + 8, 2c + 1)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tnqs {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  // not volatile: independent products may be interleaved by the compiler
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Planes of a split complex fragment, hi and lo parts.
// A: Gauss re, im, re + im; four-product re, im and -im (-re if CONJ_B).
// B: Gauss re, im, re + im; four-product re, im.
template <bool GAUSS>
struct FragA {
  uint32_t hi[3][4], lo[3][4];
};
template <bool GAUSS>
struct FragB {
  static constexpr int kPlanes = GAUSS ? 3 : 2;
  uint32_t hi[kPlanes][2], lo[kPlanes][2];
};
// The accumulators of one 16 x 8 output tile: Gauss P1, P2, P3; four-product
// Cr, Ci.
template <bool GAUSS>
struct Acc {
  float v[GAUSS ? 3 : 2][4];
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t negated(uint32_t x) {
  return x ^ 0x80000000u;
}

// A[row, k] = s[row * rs + k * ks] for the 16 x 8 tile at s
template <bool GAUSS, bool CONJ_B>
__device__ __forceinline__ void load_split_a(FragA<GAUSS>& f, const float2* s,
                                             int rs, int ks) {
  const int g = lane_id() >> 2, c = lane_id() & 3;
  float2 v[4];
  v[0] = s[g * rs + c * ks];
  v[1] = s[(g + 8) * rs + c * ks];
  v[2] = s[g * rs + (c + 4) * ks];
  v[3] = s[(g + 8) * rs + (c + 4) * ks];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(v[i].x, f.hi[0][i], f.lo[0][i]);
    split_tf32(v[i].y, f.hi[1][i], f.lo[1][i]);
    if constexpr (GAUSS) {
      split_tf32(v[i].x + v[i].y, f.hi[2][i], f.lo[2][i]);
    } else {
      const int p = CONJ_B ? 0 : 1;
      f.hi[2][i] = negated(f.hi[p][i]);
      f.lo[2][i] = negated(f.lo[p][i]);
    }
  }
}

// B[k, n] = s[k * ks + n * ns] for the 8 x 8 tile at s
template <bool GAUSS>
__device__ __forceinline__ void load_split_b(FragB<GAUSS>& f, const float2* s,
                                             int ks, int ns) {
  const int g = lane_id() >> 2, c = lane_id() & 3;
  float2 v[2];
  v[0] = s[c * ks + g * ns];
  v[1] = s[(c + 4) * ks + g * ns];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    split_tf32(v[i].x, f.hi[0][i], f.lo[0][i]);
    split_tf32(v[i].y, f.hi[1][i], f.lo[1][i]);
    if constexpr (GAUSS)
      split_tf32(v[i].x + v[i].y, f.hi[2][i], f.lo[2][i]);
  }
}

// The real products of one form, q = 0 .. kN - 1: the accumulator, the
// plane of A and the plane of B of each.  Products on the same accumulator
// are not adjacent.  The Gauss form takes no conjugated B.
template <bool GAUSS, bool CONJ>
struct Products;
template <>
struct Products<true, false> {
  static constexpr int kN = 3;  // Gauss: P_q = A_q B_q
  __host__ __device__ static constexpr int acc(int q) { return q; }
  __host__ __device__ static constexpr int a(int q) { return q; }
  __host__ __device__ static constexpr int b(int q) { return q; }
};
template <>
struct Products<false, false> {  // Cr = Ar Br + (-Ai) Bi, Ci = Ar Bi + Ai Br
  static constexpr int kN = 4;
  __host__ __device__ static constexpr int acc(int q) { return q & 1; }
  __host__ __device__ static constexpr int a(int q) {
    return q == 2 ? 2 : q == 3 ? 1 : 0;
  }
  __host__ __device__ static constexpr int b(int q) {
    return q == 1 || q == 2 ? 1 : 0;
  }
};
template <>
struct Products<false, true> {  // Cr = Ar Br + Ai Bi, Ci = Ai Br + (-Ar) Bi
  static constexpr int kN = 4;
  __host__ __device__ static constexpr int acc(int q) { return q & 1; }
  __host__ __device__ static constexpr int a(int q) {
    return q == 0 ? 0 : q == 3 ? 2 : 1;
  }
  __host__ __device__ static constexpr int b(int q) { return q >= 2 ? 1 : 0; }
};

template <bool GAUSS, int MT, int NT>
__device__ __forceinline__ void zero_acc(Acc<GAUSS> (&acc)[MT][NT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int p = 0; p < (GAUSS ? 3 : 2); ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j].v[p][e] = 0.f;
}

// The warp's tile product over one k-step of 8:
// acc[i][j] += A[16 i .., k] B[k, 8 j ..] (B conjugated if CONJ_B), with
// A and B read as in load_split_a / load_split_b from the tiles at a and b.
// The products are issued term by term (lo.hi, then hi.lo, then hi.hi), so
// that two products on one accumulator are far apart and the tensor cores
// need not wait on each other: with one A fragment every B fragment is
// loaded first and each term runs over all of them; with more, the B
// fragments are loaded one at a time (fewer registers) and each term runs
// over the A fragments.  The products are plain (not volatile) asm, so the
// compiler may interleave further.
template <bool GAUSS, int MT, int NT, bool CONJ_B>
__device__ __forceinline__ void warp_k8(Acc<GAUSS> (&acc)[MT][NT],
                                        const float2* a, int a_rs, int a_ks,
                                        const float2* b, int b_ks, int b_ns) {
  using P = Products<GAUSS, CONJ_B>;
  FragA<GAUSS> fa[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    load_split_a<GAUSS, CONJ_B>(fa[i], a + 16 * i * a_rs, a_rs, a_ks);
  constexpr int kLive = MT == 1 ? NT : 1;  // B fragments held at once
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += kLive) {
    FragB<GAUSS> fb[kLive];
#pragma unroll
    for (int j = 0; j < kLive; ++j)
      load_split_b<GAUSS>(fb[j], b + 8 * (j0 + j) * b_ns, b_ks, b_ns);
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int q = 0; q < P::kN; ++q)
#pragma unroll
        for (int j = 0; j < kLive; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float(&d)[4] = acc[i][j0 + j].v[P::acc(q)];
            const int pa = P::a(q), pb = P::b(q);
            if (term == 0) mma_tf32(d, fa[i].lo[pa], fb[j].hi[pb]);
            if (term == 1) mma_tf32(d, fa[i].hi[pa], fb[j].lo[pb]);
            if (term == 2) mma_tf32(d, fa[i].hi[pa], fb[j].hi[pb]);
          }
  }
}

// Output element e (0..3) of a 16 x 8 tile: its row and column in the tile
// and its complex value.
__device__ __forceinline__ int acc_row(int e) {
  return (lane_id() >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 2 * (lane_id() & 3) + (e & 1);
}
template <bool GAUSS>
__device__ __forceinline__ float2 acc_value(const Acc<GAUSS>& acc, int e) {
  if constexpr (GAUSS)
    return make_float2(acc.v[0][e] - acc.v[1][e],
                       acc.v[2][e] - acc.v[0][e] - acc.v[1][e]);
  else
    return make_float2(acc.v[0][e], acc.v[1][e]);
}

// Move the tensor cores' sums into fp32 accumulators of the result and
// restart them from zero.  Sums kept in the tensor cores' accumulators lose
// accuracy with their length (on the card K3 missed its 2e-5 bar with
// 4096-term sums and met it with 256-term ones), so callers promote every
// few k-steps and keep the long sums in ordinary FADDs.
template <bool GAUSS, int MT, int NT>
__device__ __forceinline__ void promote(float2 (&sum)[MT][NT][4],
                                        Acc<GAUSS> (&acc)[MT][NT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = acc_value<GAUSS>(acc[i][j], e);
        sum[i][j][e].x += v.x;
        sum[i][j][e].y += v.y;
#pragma unroll
        for (int p = 0; p < (GAUSS ? 3 : 2); ++p) acc[i][j].v[p][e] = 0.f;
      }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_sum(float2 (&sum)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = make_float2(0.f, 0.f);
}

// cp.async of BYTES (8 or 16) from global to shared memory; src_bytes = 0
// fills the destination with zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tnqs
