// Batched hermitian Jacobi eigensolver for Hopper (sm_90a): kernels K1, K2.
//
// Replaces the Pallas TPU kernels in
//   tensornetworkquantumsimulator_tpu/parallel/pallas_linalg.py
//   K1  jacobi_pseudo_roots (:428, body _roots_kernel :363)
//   K2  jacobi_eigh         (:220, body _eigh_kernel  :207)
// Both share _jacobi_rounds (:64): a parallel-ordered cyclic two-sided
// Jacobi.  The TPU kernel runs a fixed sweep count; this one stops each
// matrix after the first sweep in which every pivot |b| was at most
// 4 eps ||A||_F, capped at the caller's max_sweeps, and reports the sweeps
// it ran.  Each caller passes its noise floor (see the note on pairs at
// noise level): K1 4 eps ||A||_F, K2 none.
//
// What bounds it on the H100.  Not device memory (one read of the batch, one
// write of the results) and not flops: a sweep is n - 1 rounds in sequence,
// a call runs several hundred to a few thousand of them, and a round is
// either too short to fill an SM (n = 10, 40: the time is the latency of the
// longest warp's instruction chain, pivots -> rotation parameters) or, from
// n = 64 on, bound by what one SM can dispatch and move through its shared
// memory: per 2x2 block, 48 fp32 operations stand beside 14 shared-memory
// accesses and their address arithmetic, which runs at half the fp32 rate.
// The matrices are small (n = 10, 40, 64 on the main paths, 256 for the
// chi = 64 Gram split) in batches of 1 to 200.
//
// What the design does about it.
//   * One barrier a round.  A lives in shared memory twice (ping-pong): a
//     round reads one copy and writes the other, so no thread overwrites
//     what a slower one still reads, and the only barrier ends the round.
//   * The rotation parameters leave the critical path.  Warp 0 of a CTA does
//     nothing but pivots: beside round r's update it computes, from the copy
//     round r reads, the three elements of every pivot block of round r + 1
//     (one rotated element each, not the whole 2x2 block), runs `rotation`
//     on them and writes the parameters for round r + 1 into the other half
//     of a double buffer.  The other warps never wait for parameters, and no
//     warp idles while 32 threads divide and take roots.
//   * A short chain in `rotation`: four special-function results in sequence
//     (refined reciprocal square roots on values scaled by exact powers of
//     two) where IEEE divisions and square roots made seven.
//   * Slot layout.  The pairs of a round are always the slots (2k, 2k+1) and
//     the circle method's move `sigma` is applied while writing.  A is kept
//     as four planes by the parity of the row and column slots, so the 2x2
//     block (a, b) is element [a][b] of the four planes, `sigma` is a shift
//     by one inside a plane, a warp reads and writes consecutive words, and
//     the odd row pitch keeps the transposed writes off each other's banks.
//   * Index arithmetic once, not every round.  A thread rotates the same
//     blocks every round, so their offsets (source, the four destinations,
//     the four transposed destinations) are worked out before the first
//     sweep and held in registers.
//   * Hermitian symmetry.  On one CTA only the blocks b = a .. a + n/4
//     (cyclically) are rotated and each is written together with its
//     conjugate transpose: half the loads and flops.
//   * V in registers up to n = 64.  A warp owns whole rows of V, lane l the
//     columns of slots 2l and 2l + 1 of four rows; a round is one rotation
//     and two warp shuffles a row (sigma moves even slots up a lane, odd
//     slots down), and V touches shared memory once, at the end.  Above
//     n = 64 V stays in shared memory, a row as its even-slot columns then
//     its odd-slot ones, read, rotated and written back shifted by the warp
//     that owns the row with only __syncwarp between.
//   * n is a template parameter at the main paths' sizes (K2 40, 64, 256;
//     K1 10), with a generic fallback.
//   * Pairs at noise level, a floor each caller passes.  On a rank-
//     deficient matrix the null space's 2x2 blocks hold only rounding
//     noise; rotating them (at angles of order one) mixes the null columns
//     and refills the couplings between range and null space that earlier
//     rotations had cleared, so those pivots shrink by a constant factor a
//     sweep instead of quadratically (up to 3 sweeps more on rank n/4
//     batches at n = 40 and 64).  A pair whose |d|, |c| and |b| are all at
//     most noise_floor eps ||A||_F is skipped.  K1 passes 4 (the stopping
//     bound): its clip zeroes every eigenvalue below 10 eps lambda_max, so
//     what the skip leaves mixed it discards.  K2 passes 0 and skips
//     nothing: a Gram split keeps eigenvalues far below 4 eps ||A||_F (down
//     to 1e-10 of the trace), and a skipped block of a kept and a dropped
//     eigenpair leaves the kept subspace off by an angle of order one
//     (ising_2d_dynamics at chi = 6 keeps eigenvalues near 5e-7 lambda_max;
//     with the skip, K2 moved its <Z> by 1.7e-4 to 1.9e-4 on an H100).
//   * One launch.  K2's polish (one Newton-Schulz pass, the Rayleigh
//     quotient against the original matrix, the ascending sort) and K1's
//     epilogue (two Newton-Schulz passes, Rayleigh, the 10 eps lambda_max
//     clip, both reconstructions) run in the same CTA.
//   * Above one CTA's shared memory (88 < n <= 256, n a multiple of 16) a
//     thread block cluster of 8 CTAs holds one matrix: each CTA owns n/16
//     rows of every plane of both copies of A and n/8 rows of V (about
//     3 n^2 bytes, 193 KB at n = 256).  `sigma` moves a row by one plane
//     row, so all reads of the update are local and only the rows at a
//     CTA's edges are written to a neighbour's shared memory; the pivot
//     warp reads its elements from the owners' copies (the pivot from both
//     off-diagonal elements: the two sides of A are rotated separately and
//     drift apart by rounding) and writes the parameters to all 8 CTAs; a
//     round costs one cluster barrier.  Every
//     CTA takes the stopping decision from the same values, so a cluster
//     leaves the loop together.  At these sizes the kernel returns the raw
//     decomposition and the wrapper polishes.
//
// Numerical guards kept from the reference: the scaled hypot for |b| (no
// f32 denormals in b.re^2 + b.im^2) and the skip of pairs whose
// off-diagonal is at rounding level relative to the pair, eps/32 (|d| +
// |c|), the reference's only skip.  ||A||_F is summed in a fixed order, so
// the stopping sweep is deterministic.
//
// Non-finite input.  A matrix whose ||A||_F^2 is not finite (a NaN or Inf
// entry) runs no sweep and comes back as NaN, eigenvalues and vectors (K2)
// or both roots (K1); the batch's other matrices are computed as ever.
// The TPU kernel computes NaN through such a matrix.  Here the sort of
// K2's polish used to meet NaN eigenvalues, leave slots of its order
// unwritten and gather from outside shared memory, which ended the CUDA
// context; its order is now total (NaN last) whatever the values.
//
// Interface: plain extern "C" functions taking device pointers and a
// stream; each returns cudaGetLastError() after its launch.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The kernels' dynamic shared memory (see Layout).
extern __shared__ __align__(16) char tnqs_smem[];

namespace {

constexpr int kCluster = 8;  // CTAs holding one matrix above kOneCtaMaxN
constexpr int kOneCtaMaxN = 88;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}

// The circle method as a move of slots: after a round, what sat in slot s
// sits in slot sigma(s).  Slot 0 stays; the other even slots (the pairs'
// first members) move up one pair, the last one turning into the last odd
// slot; the odd slots move down one pair, slot 1 turning into slot 2.  Over
// n - 1 rounds every two indices share a pair (2k, 2k+1) exactly once.
__device__ __forceinline__ int sigma(int s, int h) {
  const int k = s >> 1;
  if (s & 1) return k == 0 ? 2 : s - 2;
  return k == 0 ? 0 : (k == h - 1 ? s + 1 : s + 2);
}

// 1/sqrt(x) to about one ulp: the hardware's approximation and one Newton
// step.  The rotations must be unitary to rounding (cs^2 + sn^2 = |u| = 1):
// their product is V.
__device__ __forceinline__ float rsqrt_refined(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}

// The power of two 2^floor(log2 x) of a normal x > 0, and its reciprocal:
// scaling by them is exact and costs two integer instructions.
__device__ __forceinline__ float pow2_floor(float x) {
  return __int_as_float(__float_as_int(x) & 0x7f800000);
}
__device__ __forceinline__ float pow2_recip(float x) {
  return __int_as_float(0x7f000000 - (__float_as_int(x) & 0x7f800000));
}

// Rotation J = [[u cs, u sn], [-sn, cs]] annihilating the pivot b of
// [[d, b], [conj b, c]], as (cs, sn, u.re, u.im); m = max(|b.re|, |b.im|).
// Identity for a pivot at rounding level (the induced eigenvalue change is
// O(b^2/(c-d)) < eps^2), for a pivot below the normal range (the scaling
// below needs a normal m: a denormal m would scale |b| to 0, and at d = c,
// a zero block of a padded bond, make 0 * inf), and for a block whose
// |d|, |c| and m are all at most `noise` (the caller's floor, see the note;
// 0 skips no other block).
// The chain every round waits on is kept short: with g = (c - d)/2,
//   t = sign(g) |b| / (|g| + sqrt(g^2 + |b|^2)),  cs = 1/sqrt(1 + t^2),
// the same tangent as sign(tau)/(|tau| + sqrt(1 + tau^2)) at tau = g/|b|
// without forming tau; both square roots are taken on values scaled by an
// exact power of two into [1, 8) (no overflow, and no f32 denormals in
// b.re^2 + b.im^2), as refined reciprocal square roots: four special-
// function results in sequence where IEEE divisions and square roots made
// seven, each several times as long.
__device__ __forceinline__ float4 rotation(float d, float c, float2 b,
                                           float noise, float& m) {
  m = fmaxf(fabsf(b.x), fabsf(b.y));
  float4 rot = make_float4(1.f, 0.f, 1.f, 0.f);
  if (m > FLT_EPSILON * 0.03125f * (fabsf(d) + fabsf(c)) && m >= FLT_MIN &&
      fmaxf(m, fmaxf(fabsf(d), fabsf(c))) > noise) {
    const float rm = pow2_recip(m);
    const float x = b.x * rm, y = b.y * rm;  // the larger in [1, 2)
    const float q = x * x + y * y;
    const float ih = rsqrt_refined(q);
    const float absb = q * ih * pow2_floor(m);
    const float g = 0.5f * (c - d);
    const float rs = pow2_recip(fmaxf(fabsf(g), absb));
    const float gs = fabsf(g) * rs, bs = absb * rs;  // the larger in [1, 2)
    const float r2 = gs * gs + bs * bs;
    const float t = copysignf(bs * __frcp_rn(gs + r2 * rsqrt_refined(r2)), g);
    const float cs = rsqrt_refined(1.f + t * t);
    rot = make_float4(cs, t * cs, x * ih, y * ih);
  }
  return rot;
}

// x (at index i) sorts before y (at index j): ascending, NaN last, ties by
// index.  A total order, unlike `<` on values that may hold a NaN.
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool nx = isnan(x), ny = isnan(y);
  if (nx != ny) return ny;
  return (!nx && x < y) || ((nx || x == y) && i < j);
}

// Inverse of sigma: the slot whose content moves into slot t.
__device__ __forceinline__ int sigma_inv(int t, int h) {
  if (t == 0) return 0;
  if (t == 2) return 1;
  if (t == 2 * h - 1) return t - 1;
  return (t & 1) ? t + 2 : t - 2;
}

// Layout of A in shared memory: four planes by the parity of the row and
// column slots, plane (pr, pc) holding A[2i + pr][2j + pc] at [i][j] with an
// odd row pitch.  The 2x2 block of row pair a and column pair b is element
// [a][b] of the four planes, so a warp whose lanes take consecutive column
// pairs reads and writes consecutive words (sigma moves an even slot up one
// pair and an odd slot down one pair: a shift inside a plane), and the
// transposed writes of the symmetric update walk down a plane at the odd
// pitch, every lane on its own banks.
__host__ __device__ constexpr int pitch(int h) { return h | 1; }

// Offset parts of element (slot row r, slot column c) in a copy of A whose
// planes hold `prow` rows each: row_part(r) + col_part(c).  `k` is the
// plane row (r / 2, less the CTA's first in a cluster).
__device__ __forceinline__ int row_part(int r, int k, int prow, int P) {
  return ((r & 1) * 2 * prow + k) * P;
}
__device__ __forceinline__ int col_part(int c, int prow, int P) {
  return (c & 1) * prow * P + (c >> 1);
}

// Shared memory of one CTA: A twice (four planes of `prow` rows each), V
// (`rows` rows), the rotations of two rounds, 4n floats (the pivots' sizes
// of two rounds; K1's eigenvalues and their roots), n ints (the sort), the
// warps' partial sums, and a few words (stopping flag, the CTAs' norms).
// The epilogues reuse the three matrices as n x n scratch.  Offsets in
// bytes from tnqs_smem: every access names that array, so the compiler
// addresses shared memory directly (32-bit, no generic pointers).
struct Layout {
  int a0, a1, v, par, fl, order, red, misc, total;
};

__host__ __device__ inline Layout layout(int n, int C) {
  Layout L;
  const int h = n / 2, prow = h / C, rows = n / C;
  int copy = 4 * prow * pitch(h) * int(sizeof(float2));
  copy = (copy + 15) / 16 * 16;
  int o = 0;
  L.a0 = o, o += copy;
  L.a1 = o, o += copy;
  L.v = o, o += rows * n * int(sizeof(float2));
  L.par = o, o += n * int(sizeof(float4));  // n/2 rotations, twice
  L.fl = o, o += 4 * n * int(sizeof(float));
  L.order = o, o += n * int(sizeof(int));
  L.red = o, o += 32 * int(sizeof(float));
  L.misc = o, o += 16 * int(sizeof(int));
  L.total = o;
  return L;
}

template <typename T>
__device__ __forceinline__ T* shared_at(int bytes) {
  return reinterpret_cast<T*>(tnqs_smem + bytes);
}

template <int C>
__device__ __forceinline__ void matrix_sync() {
  if constexpr (C == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// Z = J_a^H X J_b for one 2x2 block X (row pair a, column pair b).
struct Block {
  float2 pp, pq, qp, qq;
};

__device__ __forceinline__ Block rotate_block(float2 x_pp, float2 x_pq,
                                              float2 x_qp, float2 x_qq,
                                              float4 ra, float4 rb) {
  const float2 ua = make_float2(ra.z, ra.w), ub = make_float2(rb.z, rb.w);
  // columns: Y[:,p] = u cs X[:,p] - sn X[:,q]; Y[:,q] = u sn X[:,p] + cs X[:,q]
  const float2 ux0 = cmul(ub, x_pp), ux1 = cmul(ub, x_qp);
  const float2 y_pp = cadd(cscale(rb.x, ux0), cscale(-rb.y, x_pq));
  const float2 y_pq = cadd(cscale(rb.y, ux0), cscale(rb.x, x_pq));
  const float2 y_qp = cadd(cscale(rb.x, ux1), cscale(-rb.y, x_qq));
  const float2 y_qq = cadd(cscale(rb.y, ux1), cscale(rb.x, x_qq));
  // rows: Z[p] = conj(u) cs Y[p] - sn Y[q]; Z[q] = conj(u) sn Y[p] + cs Y[q]
  const float2 uy_p = cmulc(ua, y_pp), uy_q = cmulc(ua, y_pq);
  Block z;
  z.pp = cadd(cscale(ra.x, uy_p), cscale(-ra.y, y_qp));
  z.pq = cadd(cscale(ra.x, uy_q), cscale(-ra.y, y_qq));
  z.qp = cadd(cscale(ra.y, uy_p), cscale(ra.x, y_qp));
  z.qq = cadd(cscale(ra.y, uy_q), cscale(ra.x, y_qq));
  return z;
}

// One column pair of V rotated: (e, o) <- (e, o) J.
__device__ __forceinline__ void rotate_pair(float2& e, float2& o, float4 rb) {
  const float2 ux = cmul(make_float2(rb.z, rb.w), e);
  const float2 xq = o;
  e = cadd(cscale(rb.x, ux), cscale(-rb.y, xq));
  o = cadd(cscale(rb.y, ux), cscale(rb.x, xq));
}

// One element of Z = J_a^H X J_b, the 2x2 block X at x (its four planes S
// apart): row q of the block if odd_row, else row p; column likewise.
__device__ __forceinline__ float2 rotated_element(const float2* x, int S,
                                                  float4 ra, float4 rb,
                                                  bool odd_row, bool odd_col) {
  const float2 ua = make_float2(ra.z, ra.w), ub = make_float2(rb.z, rb.w);
  const float g = odd_col ? rb.y : rb.x, d = odd_col ? rb.x : -rb.y;
  const float al = odd_row ? ra.y : ra.x, be = odd_row ? ra.x : -ra.y;
  const float2 y_p = cadd(cscale(g, cmul(ub, x[0])), cscale(d, x[S]));
  const float2 y_q = cadd(cscale(g, cmul(ub, x[2 * S])), cscale(d, x[3 * S]));
  return cadd(cscale(al, cmulc(ua, y_p)), cscale(be, y_q));
}

// The pivot of the hermitian part, (b + conj(bt)) / 2, from the pair's two
// off-diagonal elements.  A cluster rotates both sides of A separately, so
// they drift apart by rounding; a pivot taken from one side leaves the
// other's drift to be chased in the null space of a rank-deficient matrix
// (with no noise floor, one matrix of a rank-64 n = 256 batch ran 26 sweeps
// on an H100 where the batch's median was 9).
__device__ __forceinline__ float2 hermitian_part(float2 b, float2 bt) {
  return make_float2(0.5f * (b.x + bt.x), 0.5f * (b.y - bt.y));
}

// Publish a pair's rotation and its pivot's size to every CTA of the cluster.
template <int C>
__device__ __forceinline__ void publish(float4* par_out, float* mval_out,
                                        int p, float4 rot, float m) {
  if constexpr (C == 1) {
    par_out[p] = rot, mval_out[p] = m;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    for (int t = 0; t < C; ++t) {
      cluster.map_shared_rank(par_out, t)[p] = rot;
      cluster.map_shared_rank(mval_out, t)[p] = m;
    }
  }
}

// What the pivot warp needs of one pair it owns, the same every round: the
// pair's two slots come from slots i0 and i1 of the round before, so its
// pivot block is three elements of that round's rotated 2x2 blocks
// (a0, a0), (a1, a1) and (a0, a1), a = i / 2.
struct PivotSource {
  int off_d, off_c, off_b;  // the three blocks in their owners' copies of A
  int off_bt;  // block (a1, a0), whose element is conj(b) up to rounding
  int meta;  // a0 | a1 << 8 | parity of i0 << 16, of i1 << 17 | owners << 18
};

__device__ __forceinline__ PivotSource pivot_source(int p, int h, int prow,
                                                    int P) {
  const int i0 = sigma_inv(2 * p, h), i1 = sigma_inv(2 * p + 1, h);
  const int a0 = i0 >> 1, a1 = i1 >> 1;
  const int t0 = a0 / prow, t1 = a1 / prow;
  PivotSource src;
  src.off_d = (a0 - t0 * prow) * P + a0;
  src.off_c = (a1 - t1 * prow) * P + a1;
  src.off_b = (a0 - t0 * prow) * P + a1;
  src.off_bt = (a1 - t1 * prow) * P + a0;
  src.meta = a0 | (a1 << 8) | ((i0 & 1) << 16) | ((i1 & 1) << 17) |
             (t0 << 18) | (t1 << 21);
  return src;
}

// Where V lives during the sweeps.  Up to n = 64 on one CTA (a template
// size), in registers: a warp owns whole rows, lane l the columns of slots
// 2l and 2l+1 of kRegRows rows, and sigma is two warp shuffles a row.
// Otherwise in shared memory, a row as its even-slot columns then its
// odd-slot ones, a lane taking the same kPairs pairs of every row: a row is
// read, rotated and written back shifted with only __syncwarp between.
template <int N, int C>
struct Plan {
  static constexpr bool kSym = C == 1;
  static constexpr bool kRegV = N > 0 && N <= 64 && C == 1;
  // 2x2 blocks of A a thread may hold: h (h/2 + 1) <= 1012 over 736
  // threads on one CTA (one each at the template sizes), (h/8) h <= 2048
  // in a CTA of a cluster (736 threads update)
  static constexpr int kItems = kSym ? (kRegV ? 1 : 2) : 3;
  static constexpr int kRegRows = 4;
  // pairs of a row a lane takes: n <= 256 is 128 pairs over 32 lanes
  static constexpr int kPairs = N ? (N / 2 + 31) / 32 : (C == 1 ? 2 : 4);
  static constexpr int kRowsInFlight = kPairs == 1 ? 4 : (kPairs == 2 ? 2 : 1);
  // pairs of the CTA's own a lane of the pivot warp takes
  static constexpr int kPivotPairs = (N > 0 && N <= 64) || C > 1 ? 1 : 2;
  // registers a thread: 65536 / 640 = 102 where V lives in them, 65536 / 768
  // = 85 elsewhere (1024 threads would leave 64, and the blocks' offsets
  // would spill)
  static constexpr int kMaxThreads = kRegV ? 640 : 768;
};

// Lanes of a warp that share a row of V: the power of two >= h, at most 32.
__host__ __device__ inline int row_lanes(int h) {
  int kw = 32;
  while (kw / 2 >= h) kw /= 2;
  return kw;
}

// Diagonalize the hermitian matrix whose plane rows [rank * h/C, ...) sit in
// the copy of A at L.a0; V accumulates the rotations (A_in = V diag V^H).
// On return `a_final` is the offset of the copy holding the rotated A, and
// rows [rank * n/C, ...) of V sit at L.v row-major, column s (slot order)
// belonging to diagonal element s.  All threads of the CTA (all CTAs of the
// cluster) take part.  Pairs whose block is all at most noise_floor eps
// ||A||_F are not rotated.  Returns the sweeps run.  `finite` is false when
// ||A||_F^2 is not finite (a NaN or Inf entry, or a norm beyond float's
// range): then no sweep runs, A and V are left as they were, and the
// caller writes NaN for the matrix.  Every CTA of a cluster sums the same
// parts in the same order, so all take that branch together.
template <int N, int C>
__device__ int jacobi_sweeps(const Layout& L, int n_rt, int max_sweeps,
                             float noise_floor, int& a_final, bool& finite) {
  using PL = Plan<N, C>;
  const int n = N ? N : n_rt, h = n / 2, P = pitch(h);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  int rank = 0;
  if constexpr (C > 1) rank = int(cg::this_cluster().block_rank());
  const int rows = n / C, prow = h / C;  // rows of V and of a plane here
  const int row0 = rank * rows;
  const int S = prow * P;  // plane stride
  float2* const V = shared_at<float2>(L.v);
  float4* const par2 = shared_at<float4>(L.par);
  float* const mval2 = shared_at<float>(L.fl);
  float* const red = shared_at<float>(L.red);
  int* const misc = shared_at<int>(L.misc);

  float part = 0.f;
  for (int e = tid; e < 4 * prow * h; e += nt) {
    const int q = e / h;  // plane * prow + row
    const float2 x = shared_at<float2>(L.a0)[q * P + (e - q * h)];
    part += x.x * x.x + x.y * x.y;
  }
  // ||A||_F in a fixed order: a shuffle tree, then the warps' sums in turn
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFullWarp, part, o);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float fro2 = 0.f;
  for (int i = 0; i < nwarps; ++i) fro2 += red[i];
  if constexpr (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float* parts = reinterpret_cast<float*>(misc + 4);
    cluster.sync();  // every CTA runs before its shared memory is written
    if (tid < C) cluster.map_shared_rank(parts, tid)[rank] = fro2;
    cluster.sync();
    fro2 = 0.f;
    for (int t = 0; t < C; ++t) fro2 += parts[t];
  }
  finite = isfinite(fro2);
  const int cap = finite ? max_sweeps : 0;
  const float done_below = 4.f * FLT_EPSILON * sqrtf(fro2);
  const float noise = noise_floor * FLT_EPSILON * sqrtf(fro2);

  // Warp 0 of each CTA takes the rotations of the pairs the CTA owns (lane
  // l the pairs l, l + 32, ...).  For the first round from A as it is; then,
  // beside each round's update, for the round after it: the warp rotates
  // the three elements of each pivot block itself, so the chain of
  // `rotation` never waits for the update nor the update for it.
  constexpr int kPiv = PL::kPivotPairs;
  PivotSource piv[kPiv];
#pragma unroll
  for (int q = 0; q < kPiv; ++q) {
    const int pl = lane + 32 * q;
    piv[q] = pivot_source(rank * prow + (pl < prow ? pl : 0), h, prow, P);
    if (warp == 0 && pl < prow) {
      const int p = rank * prow + pl;
      const float2* x = shared_at<float2>(L.a0) + pl * P + p;
      float m;
      const float4 rot = rotation(x[0].x, x[3 * S].x,
                                  C > 1 ? hermitian_part(x[S], x[2 * S])
                                        : x[S],
                                  noise, m);
      publish<C>(par2, mval2, p, rot, m);
    }
  }
  const bool updates = warp > 0;  // the other warps update A and V
  const int wt = tid - 32, wn = nt - 32;

  // A's items: one 2x2 block (row pair a, column pair b) each, rotated on
  // both sides and written where sigma seats it for the next round.  On one
  // CTA only the blocks b = a .. a + h/2 (cyclically) are computed and each
  // is also written as its conjugate transpose: A is hermitian.  A thread
  // keeps the same items every round, so where it reads and writes is
  // worked out once, here: the integer unit runs at half the rate of the
  // fp32 one, and this arithmetic would cost more than the rotation.
  constexpr int kItems = PL::kItems;
  const int hw = h / 2 + 1;  // column pairs a row pair handles when kSym
  const int total = PL::kSym ? h * hw : prow * h;
  int it_src[kItems], it_ab[kItems], it_own[kItems];
  int it_dst[kItems][4], it_mir[kItems][4];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int e = wt + q * wn;
    it_src[q] = -1;
    it_ab[q] = it_own[q] = 0;
#pragma unroll
    for (int z = 0; z < 4; ++z) it_dst[q][z] = it_mir[q][z] = -1;
    if (!updates || e >= total) continue;
    int al, a, b, j = 1;
    if constexpr (PL::kSym) {
      a = al = e / hw, j = e - a * hw;
      b = a + j < h ? a + j : a + j - h;
      // at even h the blocks half-way round would be computed twice
      if (2 * j == h && 2 * a >= h) continue;
    } else {
      al = e / h, b = e - al * h, a = rank * prow + al;
    }
    it_src[q] = al * P + b;
    it_ab[q] = a | (b << 16);
    const int r0 = sigma(2 * a, h), r1 = sigma(2 * a + 1, h);
    const int c0 = sigma(2 * b, h), c1 = sigma(2 * b + 1, h);
    const int t0 = (r0 >> 1) / prow, t1 = (r1 >> 1) / prow;  // owning CTAs
    it_own[q] = t0 | (t1 << 8);
    const int p0 = row_part(r0, (r0 >> 1) - t0 * prow, prow, P);
    const int p1 = row_part(r1, (r1 >> 1) - t1 * prow, prow, P);
    const int o0 = col_part(c0, prow, P), o1 = col_part(c1, prow, P);
    it_dst[q][0] = p0 + o0, it_dst[q][1] = p0 + o1;
    it_dst[q][2] = p1 + o0, it_dst[q][3] = p1 + o1;
    if (PL::kSym && j != 0) {
      const int m0 = row_part(c0, c0 >> 1, prow, P);
      const int m1 = row_part(c1, c1 >> 1, prow, P);
      const int q0 = col_part(r0, prow, P), q1 = col_part(r1, prow, P);
      it_mir[q][0] = m0 + q0, it_mir[q][1] = m0 + q1;
      it_mir[q][2] = m1 + q0, it_mir[q][3] = m1 + q1;
    }
  }

  // V = I.  A warp's rows: `v_group` of them from (its number) * v_group
  const int kw = row_lanes(h);
  const int v_sub = lane / kw, v_k0 = lane - v_sub * kw;
  constexpr int kInFlight = PL::kRegV ? PL::kRegRows : PL::kRowsInFlight;
  const int v_group = kInFlight * (32 / kw);
  const int v_warp0 = (wt / 32) * v_group;
  float2 ve[PL::kRegRows], vo[PL::kRegRows];  // kRegV: this lane's V
  int v_dst[2 * PL::kPairs];                  // else: where its pairs move
  if constexpr (PL::kRegV) {
#pragma unroll
    for (int u = 0; u < PL::kRegRows; ++u) {
      const int i = v_warp0 + u * (32 / kw) + v_sub;
      ve[u] = make_float2(i == 2 * v_k0 ? 1.f : 0.f, 0.f);
      vo[u] = make_float2(i == 2 * v_k0 + 1 ? 1.f : 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < rows * n; e += nt) {
      const int i = e / n, j = e - i * n;  // j < h: slot 2j; else 2(j-h)+1
      const int s = j < h ? 2 * j : 2 * (j - h) + 1;
      V[e] = make_float2(row0 + i == s ? 1.f : 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < PL::kPairs; ++q) {
      const int p = v_k0 + q * kw;
      const int s0 = sigma(2 * p, h), s1 = sigma(2 * p + 1, h);
      v_dst[2 * q] = (s0 & 1) * h + (s0 >> 1);
      v_dst[2 * q + 1] = (s1 & 1) * h + (s1 >> 1);
    }
  }
  matrix_sync<C>();

  int cur_at = L.a0, nxt_at = L.a1;
  int pb = 0;  // which half of par / mval this round reads
  int sweep = 0;
  while (sweep < cap) {
    bool big = false;  // warp 0: some pivot of this sweep was above the bound
    for (int r = 0; r < n - 1; ++r) {
      const float2* cur = shared_at<float2>(cur_at);
      float2* nxt = shared_at<float2>(nxt_at);
      const float4* par = par2 + pb * h;
      if (warp == 0) {
        for (int p = lane; p < h; p += 32)
          big |= mval2[pb * h + p] > done_below;
        if (r == n - 2) {
          const bool any = __any_sync(kFullWarp, big);
          if (lane == 0) misc[0] = any;
        }
#pragma unroll
        for (int q = 0; q < kPiv; ++q) {
          const int pl = lane + 32 * q;
          if (pl >= prow) continue;
          const int meta = piv[q].meta;
          const float4 r0 = par[meta & 0xff], r1 = par[(meta >> 8) & 0xff];
          const bool odd0 = (meta >> 16) & 1, odd1 = (meta >> 17) & 1;
          const float2 *c0 = cur, *c1 = cur;
          if constexpr (C > 1) {
            cg::cluster_group cluster = cg::this_cluster();
            c0 = cluster.map_shared_rank(cur, (meta >> 18) & 7);
            c1 = cluster.map_shared_rank(cur, (meta >> 21) & 7);
          }
          const float d =
              rotated_element(c0 + piv[q].off_d, S, r0, r0, odd0, odd0).x;
          const float c =
              rotated_element(c1 + piv[q].off_c, S, r1, r1, odd1, odd1).x;
          float2 b =
              rotated_element(c0 + piv[q].off_b, S, r0, r1, odd0, odd1);
          if constexpr (C > 1)
            b = hermitian_part(b, rotated_element(c1 + piv[q].off_bt, S, r1,
                                                  r0, odd1, odd0));
          float m;
          const float4 rot = rotation(d, c, b, noise, m);
          publish<C>(par2 + (pb ^ 1) * h, mval2 + (pb ^ 1) * h,
                     rank * prow + pl, rot, m);
        }
      }
      if (updates) {
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          if (it_src[q] < 0) continue;
          const float2* x = cur + it_src[q];
          const Block z = rotate_block(x[0], x[S], x[2 * S], x[3 * S],
                                       par[it_ab[q] & 0xffff],
                                       par[it_ab[q] >> 16]);
          float2 *d0 = nxt, *d1 = nxt;
          if constexpr (C > 1) {
            cg::cluster_group cluster = cg::this_cluster();
            d0 = cluster.map_shared_rank(nxt, it_own[q] & 0xff);
            d1 = cluster.map_shared_rank(nxt, it_own[q] >> 8);
          }
          d0[it_dst[q][0]] = z.pp, d0[it_dst[q][1]] = z.pq;
          d1[it_dst[q][2]] = z.qp, d1[it_dst[q][3]] = z.qq;
          if (PL::kSym && it_mir[q][0] >= 0) {
            nxt[it_mir[q][0]] = make_float2(z.pp.x, -z.pp.y);
            nxt[it_mir[q][1]] = make_float2(z.qp.x, -z.qp.y);
            nxt[it_mir[q][2]] = make_float2(z.pq.x, -z.pq.y);
            nxt[it_mir[q][3]] = make_float2(z.qq.x, -z.qq.y);
          }
        }
        // V <- V J, its columns moved with the slots
        if constexpr (PL::kRegV) {
          // sigma on a row: the even slots go up a lane (slot 0 stays and
          // lane 1 takes lane 0's odd slot), the odd ones down a lane (the
          // last lane's comes from its own even slot)
          const float4 rb = par[v_k0 < h ? v_k0 : 0];
#pragma unroll
          for (int u = 0; u < PL::kRegRows; ++u) {
            float2 e = ve[u], o = vo[u];
            rotate_pair(e, o, rb);
            const float2 send = v_k0 == 0 ? o : e;
            const float2 up =
                make_float2(__shfl_up_sync(kFullWarp, send.x, 1, kw),
                            __shfl_up_sync(kFullWarp, send.y, 1, kw));
            const float2 down =
                make_float2(__shfl_down_sync(kFullWarp, o.x, 1, kw),
                            __shfl_down_sync(kFullWarp, o.y, 1, kw));
            ve[u] = v_k0 == 0 ? e : up;
            vo[u] = v_k0 == h - 1 ? e : down;
          }
        } else {
          for (int i0 = v_warp0; i0 < rows; i0 += (wn / 32) * v_group) {
            float2 moved[kInFlight][2 * PL::kPairs];
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
              const int i = i0 + u * (32 / kw) + v_sub;
              const int hi = i < rows ? h : 0;  // pairs of a row that exists
              const float2* v = V + i * n;
#pragma unroll
              for (int q = 0; q < PL::kPairs; ++q) {
                const int p = v_k0 + q * kw;
                if (p < hi) {
                  float2 e = v[p], o = v[h + p];
                  rotate_pair(e, o, par[p]);
                  moved[u][2 * q] = e, moved[u][2 * q + 1] = o;
                }
              }
            }
            __syncwarp();
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
              const int i = i0 + u * (32 / kw) + v_sub;
              const int hi = i < rows ? h : 0;
              float2* v = V + i * n;
#pragma unroll
              for (int q = 0; q < PL::kPairs; ++q)
                if (v_k0 + q * kw < hi) {
                  v[v_dst[2 * q]] = moved[u][2 * q];
                  v[v_dst[2 * q + 1]] = moved[u][2 * q + 1];
                }
            }
          }
        }
      }
      matrix_sync<C>();
      const int a_done = cur_at;
      cur_at = nxt_at, nxt_at = a_done;
      pb ^= 1;
    }
    // the same value in every CTA of a cluster: all read the same pivots
    const bool go = misc[0] != 0;
    ++sweep;
    if (!go) break;
  }
  a_final = cur_at;

  // V's rows in slot order, row-major
  if (updates) {
    if constexpr (PL::kRegV) {
#pragma unroll
      for (int u = 0; u < PL::kRegRows; ++u) {
        const int i = v_warp0 + u * (32 / kw) + v_sub;
        if (i < n && v_k0 < h) {
          V[i * n + 2 * v_k0] = ve[u];
          V[i * n + 2 * v_k0 + 1] = vo[u];
        }
      }
    } else {
      for (int i0 = v_warp0; i0 < rows; i0 += (wn / 32) * v_group) {
        float2 held[kInFlight][2 * PL::kPairs];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * (32 / kw) + v_sub;
          const int hi = i < rows ? h : 0;
#pragma unroll
          for (int q = 0; q < PL::kPairs; ++q)
            if (v_k0 + q * kw < hi) {
              held[u][2 * q] = V[i * n + v_k0 + q * kw];
              held[u][2 * q + 1] = V[i * n + h + v_k0 + q * kw];
            }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * (32 / kw) + v_sub;
          const int hi = i < rows ? h : 0;
#pragma unroll
          for (int q = 0; q < PL::kPairs; ++q)
            if (v_k0 + q * kw < hi) {
              V[i * n + 2 * (v_k0 + q * kw)] = held[u][2 * q];
              V[i * n + 2 * (v_k0 + q * kw) + 1] = held[u][2 * q + 1];
            }
        }
      }
    }
  }
  __syncthreads();
  return sweep;
}

// Copy the n x n row-major matrix at `a` (device memory; this CTA's rows
// from `row0`) into the planes at `cur`.
__device__ void load_planes(float2* cur, const float2* a, int n, int prow,
                            int row0) {
  const int h = n / 2, P = pitch(h);
  for (int e = threadIdx.x; e < 2 * prow * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;  // i: row here, slot row0 + i
    cur[row_part(i, i >> 1, prow, P) + col_part(j, prow, P)] =
        a[(row0 + i) * n + j];
  }
}

// Cm = op(X) * Y on n x n shared-memory matrices; op = conj-transpose if
// herm.  All threads; caller synchronizes.
template <int N>
__device__ void small_matmul(float2* Cm, const float2* X, const float2* Y,
                             int n_rt, bool herm) {
  const int n = N ? N : n_rt;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    float2 acc = make_float2(0.f, 0.f);
    for (int p = 0; p < n; ++p)
      acc = cadd(acc, herm ? cmulc(X[p * n + i], Y[p * n + j])
                           : cmul(X[i * n + p], Y[p * n + j]));
    Cm[e] = acc;
  }
}

// One Newton-Schulz pass W (1.5 I - 0.5 W^H W) -> T, which squares the
// unitarity error of the accumulated rotations; G is scratch.  Ends
// synchronized.
template <int N>
__device__ void newton_schulz(float2* T, float2* G, const float2* W,
                              int n_rt) {
  const int n = N ? N : n_rt;
  small_matmul<N>(G, W, W, n, true);
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const float diag = (e / n) == (e % n) ? 1.5f : 0.f;
    G[e] = make_float2(diag - 0.5f * G[e].x, -0.5f * G[e].y);
  }
  __syncthreads();
  small_matmul<N>(T, W, G, n, false);
  __syncthreads();
}

// Rayleigh quotients of W's columns against the matrix at `a` (device
// memory): w[j] = Re sum_i conj(W[i,j]) (a W)[i,j].  A0 and T are scratch.
// Ends synchronized.
template <int N>
__device__ void rayleigh(float* w, float2* A0, float2* T, const float2* W,
                         const float2* a, int n_rt) {
  const int n = N ? N : n_rt;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) A0[e] = a[e];
  __syncthreads();
  small_matmul<N>(T, A0, W, n, false);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += cmulc(W[i * n + j], T[i * n + j]).x;
    w[j] = acc;
  }
  __syncthreads();
}

// K2.  polish = 0 (and every cluster launch): the diagonal of the rotated A
// and the accumulated rotations, column j belonging to eigenvalue j, in no
// particular order.  polish = 1: one Newton-Schulz pass, Rayleigh quotients
// against the original matrix, ascending order.
template <int N, int C>
__global__ void __launch_bounds__(Plan<N, C>::kMaxThreads)
    jacobi_eigh_kernel(const float2* __restrict__ a, float* __restrict__ w,
                       float2* __restrict__ v, int* __restrict__ sweeps_out,
                       int n_rt, int max_sweeps, float noise_floor,
                       int polish) {
  const int n = N ? N : n_rt, h = n / 2, rows = n / C, prow = h / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  int rank = 0;
  if constexpr (C > 1) rank = int(cg::this_cluster().block_rank());
  const int mat = blockIdx.x / C, row0 = rank * rows;
  const Layout L = layout(n, C);
  const float2* a_mat = a + size_t(mat) * n * n;
  load_planes(shared_at<float2>(L.a0), a_mat, n, prow, row0);
  __syncthreads();
  int a_final;
  bool finite;
  const int sweeps =
      jacobi_sweeps<N, C>(L, n, max_sweeps, noise_floor, a_final, finite);
  if (sweeps_out != nullptr && tid == 0 && rank == 0) sweeps_out[mat] = sweeps;
  float* w_mat = w + size_t(mat) * n;
  float2* v_mat = v + size_t(mat) * n * n;
  if (!finite) {  // NaN out for this matrix; the others are not touched
    const float nan = __int_as_float(0x7fffffff);
    for (int i = tid; i < rows; i += nt) w_mat[row0 + i] = nan;
    for (int e = tid; e < rows * n; e += nt)
      v_mat[row0 * n + e] = make_float2(nan, nan);
    return;
  }
  float2* V = shared_at<float2>(L.v);
  if (C > 1 || !polish) {
    const int P = pitch(h);
    const float2* A = shared_at<float2>(a_final);
    for (int i = tid; i < rows; i += nt)  // diagonal element of slot row0 + i
      w_mat[row0 + i] =
          A[row_part(i, i >> 1, prow, P) + col_part(row0 + i, prow, P)].x;
    for (int e = tid; e < rows * n; e += nt) v_mat[row0 * n + e] = V[e];
    return;
  }
  if constexpr (C == 1) {
    // both copies of A as scratch: Q = NS(V), then a Q in V's place
    float2 *Q = shared_at<float2>(L.a0), *G = shared_at<float2>(L.a1);
    newton_schulz<N>(Q, G, V, n);
    float* wv = shared_at<float>(L.fl);
    rayleigh<N>(wv, G, V, Q, a_mat, n);
    // ascending order by counting: order[rank of j] = j.  The order is
    // total (NaN last, ties by index), so `order` is a permutation whatever
    // the values: a value that compares false both ways would leave slots
    // of `order` unwritten and the gather below would read outside Q.
    int* order = shared_at<int>(L.order);
    for (int j = tid; j < n; j += nt) {
      int below = 0;
      for (int i = 0; i < n; ++i) below += before(wv[i], i, wv[j], j);
      order[below] = j;
      w_mat[below] = wv[j];
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e - i * n;
      v_mat[e] = Q[i * n + order[j]];
    }
  }
}

// K1: eigh -> 2x Newton-Schulz -> Rayleigh -> clip -> sqrt(M), 1/sqrt(M).
template <int N>
__global__ void __launch_bounds__(Plan<N, 1>::kMaxThreads)
    jacobi_roots_kernel(const float2* __restrict__ a, float2* __restrict__ root,
                        float2* __restrict__ inv_root,
                        int* __restrict__ sweeps_out, int n_rt,
                        int max_sweeps, float noise_floor) {
  const int n = N ? N : n_rt, h = n / 2, nn = n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = layout(n, 1);
  const size_t off = size_t(blockIdx.x) * nn;
  load_planes(shared_at<float2>(L.a0), a + off, n, h, 0);
  __syncthreads();
  int a_final;
  bool finite;
  const int sweeps =
      jacobi_sweeps<N, 1>(L, n, max_sweeps, noise_floor, a_final, finite);
  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweeps;
  if (!finite) {  // NaN out for this matrix; the others are not touched
    const float nan = __int_as_float(0x7fffffff);
    for (int e = tid; e < nn; e += nt)
      root[off + e] = inv_root[off + e] = make_float2(nan, nan);
    return;
  }

  // both copies of A as scratch; two Newton-Schulz passes, W back in V's place
  float2 *B0 = shared_at<float2>(L.a0), *B1 = shared_at<float2>(L.a1);
  float2* W = shared_at<float2>(L.v);
  newton_schulz<N>(B0, B1, W, n);
  newton_schulz<N>(W, B1, B0, n);
  float* wv = shared_at<float>(L.fl);
  float* sqw = wv + n;
  float* isqw = sqw + n;
  rayleigh<N>(wv, B1, B0, W, a + off, n);
  // clip (utils.jl:18-26): keep w > 10 eps max(|w|max, eps)
  for (int j = tid; j < n; j += nt) {
    float wmax = 0.f;
    for (int i = 0; i < n; ++i) wmax = fmaxf(wmax, fabsf(wv[i]));
    const bool good = wv[j] > 10.f * FLT_EPSILON * fmaxf(wmax, FLT_EPSILON);
    const float s = good ? sqrtf(wv[j]) : 0.f;
    sqw[j] = s;
    isqw[j] = good ? 1.f / s : 0.f;
  }
  __syncthreads();
  // root[i,j] = sum_p f(w_p) W[i,p] conj(W[j,p]), both roots in one pass
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e - i * n;
    float2 r = make_float2(0.f, 0.f), s = make_float2(0.f, 0.f);
    for (int p = 0; p < n; ++p) {
      const float2 pk = cmulc(W[j * n + p], W[i * n + p]);
      r = cadd(r, cscale(sqw[p], pk));
      s = cadd(s, cscale(isqw[p], pk));
    }
    root[off + e] = r;
    inv_root[off + e] = s;
  }
}

// Threads of a CTA: a thread for each 2x2 block of a round and a warp for
// the pivots, as far as the kernel is built for; never fewer than the plan
// needs to hold all the blocks and all of V's rows.
template <int N, int C>
int threads_for(int n) {
  using PL = Plan<N, C>;
  const int h = n / 2;
  const int items = C == 1 ? h * (h / 2 + 1) : h / C * h;
  int workers = ((items + PL::kItems - 1) / PL::kItems + 31) / 32;
  if (PL::kRegV) {
    const int rows_per_warp = PL::kRegRows * (32 / row_lanes(h));
    const int for_v = (n + rows_per_warp - 1) / rows_per_warp;
    workers = workers > for_v ? workers : for_v;
  }
  const int least = (workers + 1) * 32;
  int threads = (items + 31) / 32 * 32 + 32;
  if (threads > PL::kMaxThreads) threads = PL::kMaxThreads;
  return threads < least ? least : threads;
}

template <int N, int C>
cudaError_t launch_eigh(const float2* a, float* w, float2* v, int* sweeps,
                        int batch, int n, int max_sweeps, float noise_floor,
                        int polish, cudaStream_t stream) {
  const int threads = threads_for<N, C>(n);
  const size_t smem = layout(n, C).total;
  auto kernel = jacobi_eigh_kernel<N, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch) * C);
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a, w, v, sweeps, n, max_sweeps,
                           noise_floor, polish);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int N>
cudaError_t launch_roots(const float2* a, float2* root, float2* inv_root,
                         int* sweeps, int batch, int n, int max_sweeps,
                         float noise_floor, cudaStream_t stream) {
  const int threads = threads_for<N, 1>(n);
  const size_t smem = layout(n, 1).total;
  auto kernel = jacobi_roots_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, threads, smem, stream>>>(a, root, inv_root, sweeps, n,
                                           max_sweeps, noise_floor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tnqs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2 on `batch` hermitian n x n matrices.  n even, 4 <= n <= 88 (one CTA a
// matrix) or a multiple of 16 up to 256 (a cluster of 8, polish ignored).
// sweeps: null or `batch` ints.  noise_floor: pairs all at most
// noise_floor eps ||A||_F are skipped (0: none).
int tnqs_jacobi_eigh(const void* a, void* w, void* v, void* sweeps, int batch,
                     int n, int max_sweeps, float noise_floor, int polish,
                     void* stream) {
  const auto* a_ = static_cast<const float2*>(a);
  auto* w_ = static_cast<float*>(w);
  auto* v_ = static_cast<float2*>(v);
  auto* s_ = static_cast<int*>(sweeps);
  auto st = static_cast<cudaStream_t>(stream);
#define TNQS_EIGH(N, C) \
  launch_eigh<N, C>(a_, w_, v_, s_, batch, n, max_sweeps, noise_floor, \
                    polish, st)
  if (n % 2 != 0 || n < 4 || batch <= 0) return cudaErrorInvalidValue;
  if (n <= kOneCtaMaxN) {
    if (n == 40) return TNQS_EIGH(40, 1);
    if (n == 64) return TNQS_EIGH(64, 1);
    return TNQS_EIGH(0, 1);
  }
  if (n % (2 * kCluster) != 0 || n > 256) return cudaErrorInvalidValue;
  if (n == 256) return TNQS_EIGH(256, kCluster);
  return TNQS_EIGH(0, kCluster);
#undef TNQS_EIGH
}

// K1 on `batch` hermitian PSD n x n matrices, n even, 4 <= n <= 40;
// noise_floor as for K2.
int tnqs_jacobi_pseudo_roots(const void* a, void* root, void* inv_root,
                             void* sweeps, int batch, int n, int max_sweeps,
                             float noise_floor, void* stream) {
  const auto* a_ = static_cast<const float2*>(a);
  auto* r_ = static_cast<float2*>(root);
  auto* i_ = static_cast<float2*>(inv_root);
  auto* s_ = static_cast<int*>(sweeps);
  auto st = static_cast<cudaStream_t>(stream);
  if (n % 2 != 0 || n < 4 || n > kOneCtaMaxN || batch <= 0)
    return cudaErrorInvalidValue;
  if (n == 10)
    return launch_roots<10>(a_, r_, i_, s_, batch, n, max_sweeps,
                            noise_floor, st);
  return launch_roots<0>(a_, r_, i_, s_, batch, n, max_sweeps, noise_floor,
                         st);
}

}  // extern "C"
