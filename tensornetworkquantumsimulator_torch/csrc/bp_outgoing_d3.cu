// Outgoing BP messages of a degree-3 batched state for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel
//   tensornetworkquantumsimulator_tpu/parallel/pallas_bp.py
//   bp_outgoing_d3 (:166, body _kernel :59)
// m_out[v, j, p, q] = sum over every leg but j and the physical index of
//   (t[v] with the incoming messages of the other two legs absorbed)[..p..]
//   * conj(t[v])[..q..]
// before normalization, for t [V, chi, chi, chi, d] and messages
// [V, 3, chi, chi], all complex64.
//
// What bounds it on the H100.  At chi = 64 one vertex tensor is
// chi^3 d 8 B = 4.2 MB (533 MB for the 127-vertex Eagle lattice), far
// above the 227 KB of shared memory a block may hold, so the TPU design of
// keeping the whole vertex on chip does not carry over.  The work is five
// leg absorbs (each a chi x chi product over one leg of the tensor,
// 2 chi^4 d complex MACs per vertex) and three contractions over chi^2 d;
// about 1.7e11 real flops per call on Eagle at chi = 64, so the call is
// bound by fp32 arithmetic, with the absorbed intermediates streamed
// through device memory and L2.
//
// What the design does about it.  The partial absorbs are shared across
// the three messages exactly as engine._all_except_one shares them
// (t x1 m1 x2 m2 for slot 0; P = t x0 m0, then P x2 m2 for slot 1 and
// P x1 m1 for slot 2): five absorbs instead of six.  Intermediates are
// staged in two device scratch buffers the wrapper allocates.  Every
// contraction runs in this file's own tiled kernels: a shared-memory tiled
// complex product with fp32 accumulation for the absorbs (64 x 64 output
// tile, 4 x 4 per thread), and a split-K tiled product for the three
// message contractions (32 x 32 output tile per vertex, partial sums per
// K chunk reduced by a second small kernel in a fixed order, so the result
// is deterministic).  Tensor cores (wgmma) and TMA are later work.
//
// Interface: one extern "C" function launching the whole chain on the
// given stream; it returns the first non-zero cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
  return acc;
}

// acc += a * conj(b)
__device__ __forceinline__ float2 cfma_conj(float2 a, float2 b, float2 acc) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.y, b.x, fmaf(-a.x, b.y, acc.y));
  return acc;
}

// A vertex tensor seen along one bond leg: [pre, chi, post] with
// pre * chi * post = chi^3 d.  Column c of the (pre, post) plane sits at
// (c / post) * chi * post + c % post.
__device__ __forceinline__ size_t col_offset(int c, int chi, int post) {
  return size_t(c / post) * chi * post + (c % post);
}

constexpr int kAbsTile = 64;  // absorb: output tile (l' x columns)
constexpr int kAbsK = 16;     // absorb: depth step over l

// out[v, i, l', j] = sum_l x[v, i, l, j] * m[v, l, l']
// grid (ceil(pre*post / 64), ceil(chi / 64), V), block 16 x 16.
__global__ void absorb_kernel(const float2* __restrict__ x,
                              const float2* __restrict__ msg,
                              float2* __restrict__ out, int chi, int pre,
                              int post, size_t vstride, size_t mstride) {
  __shared__ float2 Ms[kAbsK][kAbsTile];
  __shared__ float2 Xs[kAbsK][kAbsTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int cols = pre * post;
  const int c0 = blockIdx.x * kAbsTile;
  const int lp0 = blockIdx.y * kAbsTile;
  const size_t v = blockIdx.z;
  const float2* xv = x + v * vstride;
  const float2* mv = msg + v * mstride;

  float2 acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = make_float2(0.f, 0.f);

  for (int l0 = 0; l0 < chi; l0 += kAbsK) {
    for (int e = tid; e < kAbsK * kAbsTile; e += 256) {
      const int kk = e / kAbsTile, jj = e % kAbsTile;
      const int l = l0 + kk;
      const int lp = lp0 + jj;
      Ms[kk][jj] = (l < chi && lp < chi) ? mv[size_t(l) * chi + lp]
                                         : make_float2(0.f, 0.f);
      const int c = c0 + jj;
      Xs[kk][jj] = (l < chi && c < cols)
                       ? xv[col_offset(c, chi, post) + size_t(l) * post]
                       : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kAbsK; ++kk) {
      float2 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ms[kk][ty + 16 * r];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Xs[kk][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = cfma(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }
  float2* ov = out + v * vstride;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lp = lp0 + ty + 16 * r;
    if (lp >= chi) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c = c0 + tx + 16 * s;
      if (c < cols) ov[col_offset(c, chi, post) + size_t(lp) * post] = acc[r][s];
    }
  }
}

constexpr int kOutTile = 32;  // message contraction: output tile (p x q)
constexpr int kOutK = 32;     // message contraction: depth step

// partial[s, v, p, q] = sum_{k in chunk s} x[v, k @ p] * conj(y[v, k @ q])
// with k running over the (pre, post) plane of the leg.
// grid (tiles^2, splitk, V), block 16 x 16.
__global__ void outgoing_kernel(const float2* __restrict__ x,
                                const float2* __restrict__ y,
                                float2* __restrict__ partial, int chi,
                                int pre, int post, size_t vstride, int V,
                                int chunk) {
  __shared__ float2 Xs[kOutK][kOutTile + 1];
  __shared__ float2 Ys[kOutK][kOutTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int tiles = (chi + kOutTile - 1) / kOutTile;
  const int p0 = (blockIdx.x / tiles) * kOutTile;
  const int q0 = (blockIdx.x % tiles) * kOutTile;
  const int split = blockIdx.y;
  const size_t v = blockIdx.z;
  const int K = pre * post;
  const int kbeg = split * chunk;
  const int kend = min(K, kbeg + chunk);
  const float2* xv = x + v * vstride;
  const float2* yv = y + v * vstride;

  float2 acc[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s) acc[r][s] = make_float2(0.f, 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += kOutK) {
    for (int e = tid; e < kOutK * kOutTile; e += 256) {
      // consecutive threads walk k: neighbouring addresses in the plane
      const int kk = e % kOutK, jj = e / kOutK;
      const int k = k0 + kk;
      const bool kin = k < kend;
      const size_t base = kin ? col_offset(k, chi, post) : 0;
      const int p = p0 + jj, q = q0 + jj;
      Xs[kk][jj] = (kin && p < chi) ? xv[base + size_t(p) * post]
                                    : make_float2(0.f, 0.f);
      Ys[kk][jj] = (kin && q < chi) ? yv[base + size_t(q) * post]
                                    : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kOutK; ++kk) {
      float2 a[2], b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r] = Xs[kk][ty + 16 * r];
#pragma unroll
      for (int s = 0; s < 2; ++s) b[s] = Ys[kk][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          acc[r][s] = cfma_conj(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }
  float2* pv = partial + (size_t(split) * V + v) * chi * chi;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + ty + 16 * r;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q = q0 + tx + 16 * s;
      if (p < chi && q < chi) pv[size_t(p) * chi + q] = acc[r][s];
    }
  }
}

// out[v, slot, p, q] = sum_s partial[s, v, p, q], in order of s.
__global__ void reduce_kernel(const float2* __restrict__ partial,
                              float2* __restrict__ out, int V, int chi,
                              int slot, int splitk) {
  const size_t cc = size_t(chi) * chi;
  const size_t total = size_t(V) * cc;
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * blockDim.x) {
    float2 acc = make_float2(0.f, 0.f);
    for (int s = 0; s < splitk; ++s) {
      const float2 a = partial[size_t(s) * total + e];
      acc.x += a.x;
      acc.y += a.y;
    }
    const size_t v = e / cc, pq = e % cc;
    out[(v * 3 + slot) * cc + pq] = acc;
  }
}

struct Leg {
  int pre, post;
};

Leg leg_of(int k, int chi, int d) {
  if (k == 0) return {1, chi * chi * d};
  if (k == 1) return {chi, chi * d};
  return {chi * chi, d};
}

cudaError_t absorb(const float2* x, const float2* msgs, int slot, float2* out,
                   int V, int chi, int d, cudaStream_t stream) {
  const Leg g = leg_of(slot, chi, d);
  const int cols = g.pre * g.post;
  dim3 grid((cols + kAbsTile - 1) / kAbsTile, (chi + kAbsTile - 1) / kAbsTile,
            V);
  absorb_kernel<<<grid, dim3(16, 16), 0, stream>>>(
      x, msgs + size_t(slot) * chi * chi, out, chi, g.pre, g.post,
      size_t(chi) * chi * chi * d, size_t(3) * chi * chi);
  return cudaGetLastError();
}

cudaError_t outgoing(const float2* acc, const float2* t, int slot,
                     float2* partial, float2* out, int V, int chi, int d,
                     int splitk, cudaStream_t stream) {
  const Leg g = leg_of(slot, chi, d);
  const int K = g.pre * g.post;
  const int chunk = (K + splitk - 1) / splitk;
  const int tiles = (chi + kOutTile - 1) / kOutTile;
  dim3 grid(tiles * tiles, splitk, V);
  outgoing_kernel<<<grid, dim3(16, 16), 0, stream>>>(
      acc, t, partial, chi, g.pre, g.post, size_t(chi) * chi * chi * d, V,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = size_t(V) * chi * chi;
  const int blocks = int((total + 255) / 256);
  reduce_kernel<<<blocks, 256, 0, stream>>>(partial, out, V, chi, slot,
                                            splitk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tnqs_bp_outgoing_d3(const void* t_, const void* msgs_,
                                   void* out_, void* s0_, void* s1_,
                                   void* partial_, int V, int chi, int d,
                                   int splitk, void* stream_) {
  const float2* t = static_cast<const float2*>(t_);
  const float2* msgs = static_cast<const float2*>(msgs_);
  float2* out = static_cast<float2*>(out_);
  float2* s0 = static_cast<float2*>(s0_);
  float2* s1 = static_cast<float2*>(s1_);
  float2* partial = static_cast<float2*>(partial_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
#define TNQS_TRY(call)                   \
  if ((err = (call)) != cudaSuccess) return err;
  // slot 0: (t x1 m1) x2 m2
  TNQS_TRY(absorb(t, msgs, 1, s0, V, chi, d, stream));
  TNQS_TRY(absorb(s0, msgs, 2, s1, V, chi, d, stream));
  TNQS_TRY(outgoing(s1, t, 0, partial, out, V, chi, d, splitk, stream));
  // P = t x0 m0, kept in s0 for slots 1 and 2
  TNQS_TRY(absorb(t, msgs, 0, s0, V, chi, d, stream));
  // slot 1: P x2 m2
  TNQS_TRY(absorb(s0, msgs, 2, s1, V, chi, d, stream));
  TNQS_TRY(outgoing(s1, t, 1, partial, out, V, chi, d, splitk, stream));
  // slot 2: P x1 m1 (s1 is free again: stream order)
  TNQS_TRY(absorb(s0, msgs, 1, s1, V, chi, d, stream));
  TNQS_TRY(outgoing(s1, t, 2, partial, out, V, chi, d, splitk, stream));
#undef TNQS_TRY
  return cudaSuccess;
}
