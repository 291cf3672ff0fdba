// Outgoing BP messages of a degree-3 batched state for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel
//   tensornetworkquantumsimulator_tpu/parallel/pallas_bp.py
//   bp_outgoing_d3 (:166, body _kernel :59)
// m_out[v, j, p, q] = sum over every leg but j and the physical index of
//   (t[v] with the incoming messages of the other two legs absorbed)[..p..]
//   * conj(t[v])[..q..]
// before normalization, for t [V, chi, chi, chi, d] and messages
// [V, 3, chi, chi], all complex64.  The chain is engine._all_except_one's:
//   slot 0: Y = t x1 m1, then (Y x2 m2) . conj(t)
//   slot 1: P = t x0 m0, then (P x2 m2) . conj(t)
//   slot 2:              then (P x1 m1) . conj(t)
// five leg absorbs and three contractions, each chi^4 d complex MACs per
// vertex: 8 chi^4 d complex MACs = 32 chi^4 d real flops (4-product form).
//
// What bounds it on the H100.  Eagle at chi = 64, d = 2: 127 vertices of
// chi^3 d 8 B = 4.2 MB (533 MB in all) and 8 x 3.36e7 x 127 complex MACs =
// 2.73e11 real flops: 4.1 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, 0.56 GB of compulsory traffic (0.17 ms at 3.35 TB/s), so the call
// is bound by arithmetic.  The first version ran the chain as 11 SIMT
// kernels, each a full pass over a 533 MB intermediate (about 8.5 GB of
// device-memory traffic), and loaded the slot-2 leg (stride d) at half
// sector efficiency.
//
// What the design does about it.
//   * Tensor cores: every product is the 3xTF32 tile product of
//     complex_tf32x3.cuh in its four-product form (four real products, each
//     three TF32 mma.sync: 24 tensor-core flops per complex MAC, 8.2e11 in
//     all, 1.65 ms at the 495 TFLOP/s of TF32).  The Gauss form needs 18 per
//     complex MAC (1.24 ms), the least tensor-core work, but splits three
//     planes of each operand; at these warp tiles the split's ALU work sets
//     the pace, and on an H100 the Gauss chain ran slower.  The tensor
//     cores' sums are promoted to fp32 registers after every chunk, so the
//     accuracy does not fall with chi.
//   * The second absorb of each slot is fused into its contraction: a CTA
//     computes X = I x_l m for one value r of the outer leg, a 32-row block
//     of the outgoing leg p and a 32-wide block of the fused leg l in
//     shared memory, then multiplies it straight into its 32 x 64 block of
//     m_out (a back-to-back product).  Only Y and P ever reach device
//     memory, and only one of them at a time.
//   * Vertices run in chunks (the wrapper picks the size), so the scratch
//     holds one chunk (16 x 4.2 MB at chi = 64) instead of two 533 MB
//     intermediates.
//   * Every tile is staged by cp.async copies whose order follows memory,
//     16 bytes (an (s, s + 1) pair) for even d: for the slot-2 leg (stride
//     d) the copies walk (q, s), which is contiguous, and land
//     de-interleaved in shared memory, so every load is coalesced.  The
//     contraction is software-pipelined: the next (r, l) pair's operands
//     are in flight while the tensor cores work on this one.
//   * The split over the outer leg writes partial sums, reduced by a small
//     kernel in a fixed order, so the result is deterministic.
//
// Interface: one extern "C" function launching the whole chain on the
// given stream; it returns the first non-zero cudaGetLastError().

#include <cuda_runtime.h>

#include "complex_tf32x3.cuh"

namespace {

using namespace tnqs;

// Every product below is the four-product form of the tile product
// (GAUSS = false in complex_tf32x3.cuh).

// ---------------------------------------------------------------------------
// absorb: out[v, i, l', j] = sum_l x[v, i, l, j] m[v, l, l'], the leg seen as
// [pre, chi, post].  CTA: 64 l' x 64 columns of post, 4 warps of 32 x 32,
// the tensor cores' sums promoted to fp32 after every chunk of 16 l.
// grid (pre * ceil(post / 64), ceil(chi / 64), vertices)
// ---------------------------------------------------------------------------

constexpr int kAbsM = 64, kAbsN = 64, kAbsK = 16;
constexpr int kAbsLda = kAbsK + 4, kAbsLdb = kAbsN + 4;  // 4 mod 16

__global__ void __launch_bounds__(128)
    absorb_kernel(const float2* __restrict__ x, const float2* __restrict__ msg,
                  float2* __restrict__ out, int chi, int post, int ctiles,
                  size_t vstride, size_t mstride) {
  __shared__ __align__(16) float2 As[2][kAbsM * kAbsLda];  // m^T: [l'][l]
  __shared__ __align__(16) float2 Bs[2][kAbsK * kAbsLdb];  // x: [l][col]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int pre = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x % ctiles) * kAbsN;
  const int lp0 = blockIdx.y * kAbsM;
  const size_t v = blockIdx.z;
  const float2* xv = x + v * vstride + size_t(pre) * chi * post;
  const float2* mv = msg + v * mstride;
  float2* ov = out + v * vstride + size_t(pre) * chi * post;

  auto stage = [&](int l0, int s) {
    for (int i = tid; i < kAbsK * kAbsM; i += 128) {
      const int lp = i % kAbsM, kk = i / kAbsM;  // l' fastest: m's rows
      const bool ok = lp0 + lp < chi && l0 + kk < chi;
      cp_async<8>(&As[s][lp * kAbsLda + kk],
                  ok ? mv + size_t(l0 + kk) * chi + lp0 + lp : mv, ok ? 8 : 0);
    }
    for (int i = tid; i < kAbsK * kAbsN; i += 128) {
      const int col = i % kAbsN, kk = i / kAbsN;
      const bool ok = c0 + col < post && l0 + kk < chi;
      cp_async<8>(&Bs[s][kk * kAbsLdb + col],
                  ok ? xv + size_t(l0 + kk) * post + c0 + col : xv,
                  ok ? 8 : 0);
    }
  };

  Acc<false> acc[2][4];
  zero_acc<false, 2, 4>(acc);
  float2 sum[2][4][4];
  zero_sum<2, 4>(sum);
  const int chunks = (chi + kAbsK - 1) / kAbsK;
  stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) stage((kc + 1) * kAbsK, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float2* as = &As[kc & 1][(wm * 32) * kAbsLda];
    const float2* bs = &Bs[kc & 1][wn * 32];
    const int steps = min(kAbsK, chi - kc * kAbsK + 7) / 8;
    for (int st = 0; st < steps; ++st)
      warp_k8<false, 2, 4, false>(acc, as + 8 * st, kAbsLda, 1,
                                  bs + 8 * st * kAbsLdb, kAbsLdb, 1);
    promote<false, 2, 4>(sum, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lp = lp0 + wm * 32 + 16 * i + acc_row(e);
        const int col = c0 + wn * 32 + 8 * j + acc_col(e);
        if (lp < chi && col < post) ov[size_t(lp) * post + col] = sum[i][j][e];
      }
}

// ---------------------------------------------------------------------------
// contract: partial[split, v, p, q] = sum over r in the split's range, l, s of
//   X[r, p, l, s] conj(t[r, q, l, s]),  X[r, p, l, s] = sum_l' I[r, p, l', s] m[l', l]
// where (r, p, l) are the tensor's three bond legs in the slot's order, with
// strides (sr, sp, sl) and s (stride 1) the physical index.  CTA: a 32-row
// block of p and a 64-wide block of q, 4 warps; per r and 32-wide block of
// l, phase 1 forms X [32 p x d s, 32 l] in shared memory (K = l' in chunks
// of 32), phase 2 adds X . conj(t) into the 32 x 64 accumulators.
// grid (splits, ceil(chi / 32) * ceil(chi / 64), vertices)
// ---------------------------------------------------------------------------

constexpr int kPB = 32, kQB = 64, kLB = 32, kKC = 32;
constexpr int kLdm = kLB + 4;  // 4 mod 16

template <int D>
struct ContractSmem {
  static constexpr int kRows1 = kPB * D;      // phase-1 rows (p, s)
  static constexpr int kLdr = kRows1 + 4;     // I [l'][(p, s)], 4 mod 16
  static constexpr int kLdx = kLB * D + 4;    // X [p][(l, s)], 4 mod 16
  static constexpr int kIs = kKC * kLdr;      // one buffer of I
  static constexpr int kMs = kKC * kLdm;      // one buffer of m
  static constexpr int kXs = kPB * kLdx;
  static constexpr int kTs = kQB * kLdx;      // conj(t) [q][(l, s)]
  static constexpr size_t kBytes = sizeof(float2) * (2 * kIs + 2 * kMs + kXs + kTs);
};

// P_INNER: the slot-2 layout, where the outgoing leg p (stride d) sits next
// to s in memory and the fused leg l does not; the copies then walk (p, s).
template <int D, bool P_INNER>
__global__ void __launch_bounds__(128)
    contract_kernel(const float2* __restrict__ inter,
                    const float2* __restrict__ t,
                    const float2* __restrict__ msg, float2* __restrict__ partial,
                    int chi, int sr, int sp, int sl, int rlen, int qblocks,
                    int nv, size_t vstride, size_t mstride) {
  using S = ContractSmem<D>;
  constexpr int kMT1 = (S::kRows1 / 16 + 3) / 4;  // phase-1 m-tiles per warp
  // complex values per copy: (s, s + 1) pairs are 16-byte aligned for even d
  constexpr int kVec = D % 2 == 0 ? 2 : 1;
  constexpr int kSv = D / kVec;  // copies per (leg, leg) pair
  extern __shared__ __align__(16) float2 smem[];
  float2* Is = smem;                 // [2][kKC][kLdr]
  float2* Ms = Is + 2 * S::kIs;      // [2][kKC][kLdm]
  float2* Xs = Ms + 2 * S::kMs;      // [kPB][kLdx]
  float2* Ts = Xs + S::kXs;          // [kQB][kLdx]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int split = blockIdx.x;
  const int p0 = (blockIdx.y / qblocks) * kPB;
  const int q0 = (blockIdx.y % qblocks) * kQB;
  const int v = blockIdx.z;
  const float2* iv = inter + size_t(v) * vstride;
  const float2* tv = t + size_t(v) * vstride;
  const float2* mv = msg + size_t(v) * mstride;
  const int r_beg = split * rlen, r_end = min(chi, r_beg + rlen);

  // phase-1 operands: I [l', (p, s)] and m [l', l] for the l' chunk at lp0
  auto stage1 = [&](const float2* ir, int l0, int lp0, int buf) {
    float2* is = Is + buf * S::kIs;
    for (int i = tid; i < kPB * kKC * kSv; i += 128) {
      const int s = (i % kSv) * kVec, rest = i / kSv;
      const int pp = P_INNER ? rest % kPB : rest / kKC;
      const int kk = P_INNER ? rest / kPB : rest % kKC;
      const bool ok = p0 + pp < chi && lp0 + kk < chi;
      cp_async<8 * kVec>(
          &is[kk * S::kLdr + pp * D + s],
          ok ? ir + size_t(p0 + pp) * sp + size_t(lp0 + kk) * sl + s : ir,
          ok ? 8 * kVec : 0);
    }
    float2* ms = Ms + buf * S::kMs;
    for (int i = tid; i < kKC * kLB; i += 128) {
      const int ll = i % kLB, kk = i / kLB;
      const bool ok = l0 + ll < chi && lp0 + kk < chi;
      cp_async<8>(&ms[kk * kLdm + ll],
                  ok ? mv + size_t(lp0 + kk) * chi + l0 + ll : mv, ok ? 8 : 0);
    }
  };
  // phase-2 operand: t [q, (l, s)] for the l block at l0
  auto stage2 = [&](const float2* tr, int l0) {
    for (int i = tid; i < kQB * kLB * kSv; i += 128) {
      const int s = (i % kSv) * kVec, rest = i / kSv;
      const int qq = P_INNER ? rest % kQB : rest / kLB;
      const int ll = P_INNER ? rest / kQB : rest % kLB;
      const bool ok = q0 + qq < chi && l0 + ll < chi;
      cp_async<8 * kVec>(
          &Ts[qq * S::kLdx + ll * D + s],
          ok ? tr + size_t(q0 + qq) * sp + size_t(l0 + ll) * sl + s : tr,
          ok ? 8 * kVec : 0);
    }
  };

  Acc<false> acc2[1][4];
  zero_acc<false, 1, 4>(acc2);
  float2 sum2[1][4][4];  // promoted after every phase 2 (64 d terms)
  zero_sum<1, 4>(sum2);
  const int wm2 = warp >> 1, wn2 = warp & 1;  // phase 2: 2 x 2 warps of 16 x 32
  const int kchunks = (chi + kKC - 1) / kKC;
  const int lblocks = (chi + kLB - 1) / kLB;
  const int iters = (r_end - r_beg) * lblocks;  // (r, l block) pairs

  // Software pipeline over the (r, l block) pairs: the next pair's first I
  // and m chunk are copied while phase 2 runs, its t slab while phase 1
  // runs, so no phase starts by waiting for memory.
  auto first_of = [&](int it, bool slab) {
    const int r = r_beg + it / lblocks, l0 = (it % lblocks) * kLB;
    if (slab)
      stage2(tv + size_t(r) * sr, l0);
    else
      stage1(iv + size_t(r) * sr, l0, 0, 0);
    cp_async_commit();
  };
  if (iters > 0) {
    first_of(0, false);
    first_of(0, true);
  }
  for (int it = 0; it < iters; ++it) {
    const int r = r_beg + it / lblocks, l0 = (it % lblocks) * kLB;
    const float2* ir = iv + size_t(r) * sr;
    Acc<false> acc1[kMT1][1][4];
#pragma unroll
    for (int i = 0; i < kMT1; ++i) zero_acc<false, 1, 4>(acc1[i]);
    for (int kc = 0; kc < kchunks; ++kc) {
      if (kc + 1 < kchunks) stage1(ir, l0, (kc + 1) * kKC, (kc + 1) & 1);
      cp_async_commit();
      // in flight, oldest first: [chunk kc, (t slab if kc = 0), chunk kc + 1]
      if (kc == 0)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
      __syncthreads();
      const float2* is = Is + (kc & 1) * S::kIs;
      const float2* ms = Ms + (kc & 1) * S::kMs;
      const int steps = min(kKC, chi - kc * kKC + 7) / 8;
#pragma unroll
      for (int i = 0; i < kMT1; ++i) {
        const int mt = warp + 4 * i;
        if (mt * 16 >= S::kRows1) continue;
        for (int st = 0; st < steps; ++st)
          warp_k8<false, 1, 4, false>(acc1[i],
                                      is + 8 * st * S::kLdr + mt * 16, 1,
                                      S::kLdr, ms + 8 * st * kLdm, kLdm, 1);
      }
      __syncthreads();
    }
    // X [(p, s), l] -> Xs[p][(l, s)]
#pragma unroll
    for (int i = 0; i < kMT1; ++i) {
      const int mt = warp + 4 * i;
      if (mt * 16 >= S::kRows1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + acc_row(e), ll = 8 * j + acc_col(e);
          Xs[(row / D) * S::kLdx + ll * D + row % D] =
              acc_value<false>(acc1[i][0][j], e);
        }
    }
    cp_async_wait<0>();  // the t slab
    __syncthreads();
    if (it + 1 < iters) first_of(it + 1, false);  // buffers 0 are free
    const int steps2 = (min(kLB, chi - l0) * D + 7) / 8;
    for (int st = 0; st < steps2; ++st)
      warp_k8<false, 1, 4, true>(acc2, Xs + wm2 * 16 * S::kLdx + 8 * st,
                                 S::kLdx, 1, Ts + wn2 * 32 * S::kLdx + 8 * st,
                                 1, S::kLdx);
    promote<false, 1, 4>(sum2, acc2);
    __syncthreads();
    if (it + 1 < iters) first_of(it + 1, true);  // the slab is free
  }
  float2* pv = partial + (size_t(split) * nv + v) * chi * chi;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + wm2 * 16 + acc_row(e);
      const int q = q0 + wn2 * 32 + 8 * j + acc_col(e);
      if (p < chi && q < chi) pv[size_t(p) * chi + q] = sum2[0][j][e];
    }
}

// out[v, slot, p, q] = sum_s partial[s, v, p, q], in order of s.
__global__ void reduce_kernel(const float2* __restrict__ partial,
                              float2* __restrict__ out, int nv, int chi,
                              int slot, int splits) {
  const size_t cc = size_t(chi) * chi;
  const size_t total = size_t(nv) * cc;
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * blockDim.x) {
    float2 acc = make_float2(0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float2 a = partial[size_t(s) * total + e];
      acc.x += a.x;
      acc.y += a.y;
    }
    const size_t v = e / cc, pq = e % cc;
    out[(v * 3 + slot) * cc + pq] = acc;
  }
}

cudaError_t absorb(const float2* x, const float2* msgs, int leg, float2* out,
                   int nv, int chi, int d, cudaStream_t stream) {
  const int pre = leg == 0 ? 1 : chi;
  const int post = leg == 0 ? chi * chi * d : chi * d;
  const int ctiles = (post + kAbsN - 1) / kAbsN;
  dim3 grid(pre * ctiles, (chi + kAbsM - 1) / kAbsM, nv);
  absorb_kernel<<<grid, 128, 0, stream>>>(
      x, msgs + size_t(leg) * chi * chi, out, chi, post, ctiles,
      size_t(chi) * chi * chi * d, size_t(3) * chi * chi);
  return cudaGetLastError();
}

template <int D, bool P_INNER>
cudaError_t contract_d(const float2* inter, const float2* t, const float2* m,
                       float2* partial, int chi, int sr, int sp, int sl,
                       int splits, int nv, cudaStream_t stream) {
  // per call: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      contract_kernel<D, P_INNER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(ContractSmem<D>::kBytes));
  if (err != cudaSuccess) return err;
  const int rlen = (chi + splits - 1) / splits;
  const int qblocks = (chi + kQB - 1) / kQB;
  dim3 grid(splits, ((chi + kPB - 1) / kPB) * qblocks, nv);
  contract_kernel<D, P_INNER><<<grid, 128, ContractSmem<D>::kBytes, stream>>>(
      inter, t, m, partial, chi, sr, sp, sl, rlen, qblocks, nv,
      size_t(chi) * chi * chi * D, size_t(3) * chi * chi);
  return cudaGetLastError();
}

template <int D>
cudaError_t contract_slot(bool p_inner, const float2* inter, const float2* t,
                          const float2* m, float2* partial, int chi, int sr,
                          int sp, int sl, int splits, int nv,
                          cudaStream_t stream) {
  auto run = p_inner ? contract_d<D, true> : contract_d<D, false>;
  return run(inter, t, m, partial, chi, sr, sp, sl, splits, nv, stream);
}

// The message of one slot for nv vertices: contraction, then the reduction
// into out.  f is the slot of the message absorbed in phase 1.
cudaError_t message(const float2* inter, const float2* t, const float2* msgs,
                    int slot, float2* partial, float2* out, int nv, int chi,
                    int d, int splits, cudaStream_t stream) {
  const int f = slot == 2 ? 1 : 2;
  const int leg_r = slot == 0 ? 1 : 0;            // the outer leg
  const int leg_l = f;                            // the fused leg
  const int stride[3] = {chi * chi * d, chi * d, d};
  const int sr = stride[leg_r], sp = stride[slot], sl = stride[leg_l];
  const float2* m = msgs + size_t(f) * chi * chi;
  cudaError_t err;
  const bool p_inner = slot == 2;  // p has stride d, l stride chi d
  switch (d) {
    case 1: err = contract_slot<1>(p_inner, inter, t, m, partial, chi, sr, sp, sl, splits, nv, stream); break;
    case 2: err = contract_slot<2>(p_inner, inter, t, m, partial, chi, sr, sp, sl, splits, nv, stream); break;
    case 3: err = contract_slot<3>(p_inner, inter, t, m, partial, chi, sr, sp, sl, splits, nv, stream); break;
    case 4: err = contract_slot<4>(p_inner, inter, t, m, partial, chi, sr, sp, sl, splits, nv, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t total = size_t(nv) * chi * chi;
  const int blocks = int((total + 255) / 256);
  reduce_kernel<<<blocks, 256, 0, stream>>>(partial, out, nv, chi, slot,
                                            splits);
  return cudaGetLastError();
}

}  // namespace

// t [V, chi, chi, chi, d], msgs [V, 3, chi, chi] -> out [V, 3, chi, chi];
// scratch holds chunk vertices, partial [splits, chunk, chi, chi].
extern "C" int tnqs_bp_outgoing_d3(const void* t_, const void* msgs_,
                                   void* out_, void* scratch_, void* partial_,
                                   int V, int chi, int d, int chunk,
                                   int splits, void* stream_) {
  const float2* t = static_cast<const float2*>(t_);
  const float2* msgs = static_cast<const float2*>(msgs_);
  float2* out = static_cast<float2*>(out_);
  float2* scratch = static_cast<float2*>(scratch_);
  float2* partial = static_cast<float2*>(partial_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (d < 1 || d > 4 || chunk < 1 || chunk > 65535 || splits < 1)
    return int(cudaErrorInvalidValue);
  const size_t vsize = size_t(chi) * chi * chi * d, msize = size_t(3) * chi * chi;
  cudaError_t err;
#define TNQS_TRY(call)                   \
  if ((err = (call)) != cudaSuccess) return err;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int nv = min(chunk, V - v0);
    const float2* tc = t + v0 * vsize;
    const float2* mc = msgs + v0 * msize;
    float2* oc = out + v0 * msize;
    // slot 0: Y = t x1 m1, then (Y x2 m2) . conj(t)
    TNQS_TRY(absorb(tc, mc, 1, scratch, nv, chi, d, stream));
    TNQS_TRY(message(scratch, tc, mc, 0, partial, oc, nv, chi, d, splits, stream));
    // P = t x0 m0 (over Y: stream order), then slots 1 and 2
    TNQS_TRY(absorb(tc, mc, 0, scratch, nv, chi, d, stream));
    TNQS_TRY(message(scratch, tc, mc, 1, partial, oc, nv, chi, d, splits, stream));
    TNQS_TRY(message(scratch, tc, mc, 2, partial, oc, nv, chi, d, splits, stream));
  }
#undef TNQS_TRY
  return cudaSuccess;
}
