// Batched hermitian Jacobi eigensolver for Hopper (sm_90a): kernels K1, K2.
//
// Replaces the Pallas TPU kernels in
//   tensornetworkquantumsimulator_tpu/parallel/pallas_linalg.py
//   K1  jacobi_pseudo_roots (:428, body _roots_kernel :363)
//   K2  jacobi_eigh         (:220, body _eigh_kernel  :207)
// Both share _jacobi_rounds (:64): a parallel-ordered cyclic Jacobi.  The
// TPU kernel runs a fixed sweep count (default_sweeps); this one stops each
// matrix by a convergence test (a sweep in which every off-diagonal it met
// was at most 4 eps ||A||_F), capped at the caller's max_sweeps.  The fixed
// count leaves spectra that span several decades unconverged at n >= 32
// (|root^2 - A|/|A| up to 1e-4 for the reference algorithm at n = 32 after
// its 7 sweeps; 1e-6 after 12), and already-diagonal inputs such as padded
// identity environments exit after one sweep.
//
// What bounds it on the H100.  The matrices are small (n = 10 and 40 on the
// 5x5 chi=10 layer, n = 64 on the Eagle chi=64 layer) and come in batches of
// tens to a few hundred, so the stage is bound by latency: each round is a
// dependent chain (pair parameters -> 2x2 block rotations) and a call runs
// (n-1) rounds per sweep.  Device memory traffic is one read of the batch and
// one or two writes; flops are tiny.
//
// What the design does about it.  One CTA per matrix, with the working
// matrix A and the rotation accumulator V resident in shared memory as
// float2 (re, im) for the whole call: nothing goes back to device memory
// between rounds, and the batch spreads over the SMs.  Each round rotates
// the n/2 disjoint pairs of a round-robin (circle-method) schedule computed
// by index, so no data moves between rounds (the TPU's lane-batched
// [n,n,G] layout, its padding and roll-based reseating existed only
// because Mosaic had no gathers).  Within a round every 2x2 block
// (row pair a, column pair b) of A is rotated on both sides by one thread,
// and V's column pairs likewise, so a round costs two barriers.  K1 keeps
// its whole epilogue (two Newton-Schulz passes, Rayleigh re-extraction
// from the original matrix, the 10*eps*lambda_max clip, both
// reconstructions) in the same CTA, so the environment-root stage of the
// simple update is one launch, as on the TPU.
//
// Numerical guards kept from the reference: the scaled hypot for |b|
// (no f32 denormals in b.re^2 + b.im^2) and the skip of pairs whose
// off-diagonal is at rounding level.  The Newton refinements of the phase
// and of rsqrt corrected the TPU's approximate divide/rsqrt; here the phase
// and cos use IEEE division and sqrtf (the build passes no fast-math flag),
// so they are left out.
//
// Interface: plain extern "C" functions taking device pointers and a
// stream; each returns cudaGetLastError() after its launch.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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

// Shared-memory scratch of the rounds: per pair k, its indices and its
// rotation J = [[u*cs, u*sn], [-sn, cs]] on (p, q).
struct PairParams {
  int* p;
  int* q;
  float* cs;
  float* sn;
  float2* u;
};

__device__ __forceinline__ void pair_of(int r, int k, int n, int& p, int& q) {
  // circle method: index n-1 stays fixed, the others rotate by one per
  // round; over n-1 rounds every pair of indices meets exactly once
  const int m = n - 1;
  if (k == 0) {
    p = r;
    q = m;
  } else {
    p = (r + k) % m;
    q = (r - k + m) % m;
  }
}

// Diagonalize the hermitian A (n x n, row-major, shared memory) in place;
// V accumulates the rotations (A_in = V diag(A_out) V^H).  All threads of
// the block take part; `red` is blockDim.x floats of scratch and `flags`
// three ints.  Returns the number of sweeps run.
__device__ int jacobi_rounds(float2* A, float2* V, int n, int max_sweeps,
                             PairParams pp, float* red, int* flags) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int h = n / 2;
  float part = 0.f;
  for (int e = tid; e < n * n; e += nt) {
    V[e] = make_float2((e / n) == (e % n) ? 1.f : 0.f, 0.f);
    part += A[e].x * A[e].x + A[e].y * A[e].y;
  }
  red[tid] = part;
  if (tid < 3) flags[tid] = 0;
  __syncthreads();
  // ||A||_F summed in a fixed order, so the stopping sweep is deterministic
  float fro2 = 0.f;
  for (int i = 0; i < nt; ++i) fro2 += red[i];
  const float done_below = 4.f * FLT_EPSILON * sqrtf(fro2);

  int sweep = 0;
  while (sweep < max_sweeps) {
    // flags[s % 3] is set during sweep s by any pair whose |b| exceeds the
    // bound; flags[(s + 1) % 3] was last read two sweeps ago, so it can be
    // cleared now with no race against a late reader
    if (tid == 0) flags[(sweep + 1) % 3] = 0;
    for (int r = 0; r < n - 1; ++r) {
      for (int k = tid; k < h; k += nt) {
        int p, q;
        pair_of(r, k, n, p, q);
        const float d = A[p * n + p].x;
        const float c = A[q * n + q].x;
        const float2 b = A[p * n + q];
        const float m = fmaxf(fabsf(b.x), fabsf(b.y));
        if (m > done_below) flags[sweep % 3] = 1;
        float cs = 1.f, sn = 0.f;
        float2 u = make_float2(1.f, 0.f);
        // skip pairs whose off-diagonal is at rounding level: the induced
        // eigenvalue change is O(b^2/(c-d)) < eps^2
        if (m > FLT_EPSILON * 0.03125f * (fabsf(d) + fabsf(c))) {
          const float x = b.x / m, y = b.y / m;  // in [-1, 1]: no underflow
          const float hyp = sqrtf(x * x + y * y);  // >= 1
          const float absb = m * hyp;
          u = make_float2(x / hyp, y / hyp);  // phase b/|b|
          const float tau = (c - d) / (2.f * absb);
          // t = sign(tau)/(|tau| + sqrt(1 + tau^2)); tau -> inf gives t -> 0
          const float t = (tau >= 0.f ? 1.f : -1.f) /
                          (fabsf(tau) + sqrtf(1.f + tau * tau));
          cs = 1.f / sqrtf(1.f + t * t);
          sn = t * cs;
        }
        pp.p[k] = p;
        pp.q[k] = q;
        pp.cs[k] = cs;
        pp.sn[k] = sn;
        pp.u[k] = u;
      }
      __syncthreads();

      // A <- J^H A J, one 2x2 block (row pair a, column pair b) per item
      for (int e = tid; e < h * h; e += nt) {
        const int a = e / h, bb = e % h;
        const int pa = pp.p[a], qa = pp.q[a], pb = pp.p[bb], qb = pp.q[bb];
        const float2 x_pp = A[pa * n + pb], x_pq = A[pa * n + qb];
        const float2 x_qp = A[qa * n + pb], x_qq = A[qa * n + qb];
        // columns: Y[:,p] = u cs X[:,p] - sn X[:,q]; Y[:,q] = u sn X[:,p] + cs X[:,q]
        const float2 ub = pp.u[bb];
        const float csb = pp.cs[bb], snb = pp.sn[bb];
        const float2 y_pp = cadd(cscale(csb, cmul(ub, x_pp)), cscale(-snb, x_pq));
        const float2 y_pq = cadd(cscale(snb, cmul(ub, x_pp)), cscale(csb, x_pq));
        const float2 y_qp = cadd(cscale(csb, cmul(ub, x_qp)), cscale(-snb, x_qq));
        const float2 y_qq = cadd(cscale(snb, cmul(ub, x_qp)), cscale(csb, x_qq));
        // rows: Z[p] = conj(u) cs Y[p] - sn Y[q]; Z[q] = conj(u) sn Y[p] + cs Y[q]
        const float2 ua = pp.u[a];
        const float csa = pp.cs[a], sna = pp.sn[a];
        A[pa * n + pb] = cadd(cscale(csa, cmulc(ua, y_pp)), cscale(-sna, y_qp));
        A[pa * n + qb] = cadd(cscale(csa, cmulc(ua, y_pq)), cscale(-sna, y_qq));
        A[qa * n + pb] = cadd(cscale(sna, cmulc(ua, y_pp)), cscale(csa, y_qp));
        A[qa * n + qb] = cadd(cscale(sna, cmulc(ua, y_pq)), cscale(csa, y_qq));
      }
      // V <- V J, one (row, column pair) per item
      for (int e = tid; e < n * h; e += nt) {
        const int i = e / h, bb = e % h;
        const int pb = pp.p[bb], qb = pp.q[bb];
        const float2 x_p = V[i * n + pb], x_q = V[i * n + qb];
        const float2 ub = pp.u[bb];
        const float csb = pp.cs[bb], snb = pp.sn[bb];
        V[i * n + pb] = cadd(cscale(csb, cmul(ub, x_p)), cscale(-snb, x_q));
        V[i * n + qb] = cadd(cscale(snb, cmul(ub, x_p)), cscale(csb, x_q));
      }
      __syncthreads();
    }
    const bool converged = flags[sweep % 3] == 0;  // same value in every thread
    ++sweep;
    if (converged) break;
  }
  return sweep;
}

// Carve the pair scratch out of shared memory after `base`.
__device__ PairParams carve_pairs(char* base, int n) {
  const int h = n / 2;
  PairParams pp;
  pp.u = reinterpret_cast<float2*>(base);
  pp.cs = reinterpret_cast<float*>(pp.u + h);
  pp.sn = pp.cs + h;
  pp.p = reinterpret_cast<int*>(pp.sn + h);
  pp.q = pp.p + h;
  return pp;
}

__host__ __device__ constexpr size_t pair_bytes(int n) {
  return size_t(n / 2) * (sizeof(float2) + 2 * sizeof(float) + 2 * sizeof(int));
}

// Scratch of jacobi_rounds after the pair parameters: the Frobenius
// partial sums (one float per thread) and the three convergence flags.
constexpr size_t round_scratch_bytes() {
  return kMaxThreads * sizeof(float) + 3 * sizeof(int);
}

__device__ void load_matrix(float2* dst, const float2* src, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) dst[e] = src[e];
}

// K2: eigenvalues (unsorted, diagonal of the rotated A) and eigenvectors.
__global__ void jacobi_eigh_kernel(const float2* __restrict__ a,
                                   float* __restrict__ w,
                                   float2* __restrict__ v, int n,
                                   int max_sweeps) {
  extern __shared__ __align__(16) char smem[];
  float2* A = reinterpret_cast<float2*>(smem);
  float2* V = A + n * n;
  char* pair_base = reinterpret_cast<char*>(V + n * n);
  PairParams pp = carve_pairs(pair_base, n);
  float* red = reinterpret_cast<float*>(pair_base + pair_bytes(n));
  int* flags = reinterpret_cast<int*>(red + kMaxThreads);
  const size_t off = size_t(blockIdx.x) * n * n;
  load_matrix(A, a + off, n);
  __syncthreads();
  jacobi_rounds(A, V, n, max_sweeps, pp, red, flags);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    w[size_t(blockIdx.x) * n + i] = A[i * n + i].x;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) v[off + e] = V[e];
}

// C = op(X) * Y on n x n shared-memory matrices; op = conj-transpose if
// herm.  All threads; caller synchronizes.
__device__ void small_matmul(float2* C, const float2* X, const float2* Y,
                             int n, bool herm) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    float2 acc = make_float2(0.f, 0.f);
    for (int k = 0; k < n; ++k)
      acc = cadd(acc, herm ? cmulc(X[k * n + i], Y[k * n + j])
                           : cmul(X[i * n + k], Y[k * n + j]));
    C[e] = acc;
  }
}

// K1: eigh -> 2x Newton-Schulz -> Rayleigh -> clip -> sqrt(M), 1/sqrt(M).
__global__ void jacobi_roots_kernel(const float2* __restrict__ a,
                                    float2* __restrict__ root,
                                    float2* __restrict__ inv_root, int n,
                                    int max_sweeps) {
  extern __shared__ __align__(16) char smem[];
  const int nn = n * n;
  float2* A = reinterpret_cast<float2*>(smem);
  float2* A0 = A + nn;  // the original matrix, for the Rayleigh quotient
  float2* W = A0 + nn;
  float2* G = W + nn;
  float2* T = G + nn;
  float* w = reinterpret_cast<float*>(T + nn);
  float* sqw = w + n;
  float* isqw = sqw + n;
  char* pair_base = reinterpret_cast<char*>(isqw + n);
  PairParams pp = carve_pairs(pair_base, n);
  float* red = reinterpret_cast<float*>(pair_base + pair_bytes(n));
  int* flags = reinterpret_cast<int*>(red + kMaxThreads);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t off = size_t(blockIdx.x) * nn;

  load_matrix(A, a + off, n);
  load_matrix(A0, a + off, n);
  __syncthreads();
  jacobi_rounds(A, W, n, max_sweeps, pp, red, flags);

  // Newton-Schulz, twice: W <- W (1.5 I - 0.5 W^H W); each pass squares the
  // unitarity error of the accumulated rotations
  for (int pass = 0; pass < 2; ++pass) {
    small_matmul(G, W, W, n, true);
    __syncthreads();
    for (int e = tid; e < nn; e += nt) {
      const float diag = (e / n) == (e % n) ? 1.5f : 0.f;
      G[e] = make_float2(diag - 0.5f * G[e].x, -0.5f * G[e].y);
    }
    __syncthreads();
    small_matmul(T, W, G, n, false);
    __syncthreads();
    for (int e = tid; e < nn; e += nt) W[e] = T[e];
    __syncthreads();
  }
  // Rayleigh re-extraction from the original matrix:
  // w[k] = Re sum_i conj(W[i,k]) (A0 W)[i,k]
  small_matmul(T, A0, W, n, false);
  __syncthreads();
  for (int k = tid; k < n; k += nt) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += cmulc(W[i * n + k], T[i * n + k]).x;
    w[k] = acc;
  }
  __syncthreads();
  // clip (utils.jl:18-26): keep w > 10 eps max(|w|max, eps)
  for (int k = tid; k < n; k += nt) {
    float wmax = 0.f;
    for (int i = 0; i < n; ++i) wmax = fmaxf(wmax, fabsf(w[i]));
    const bool good = w[k] > 10.f * FLT_EPSILON * fmaxf(wmax, FLT_EPSILON);
    const float s = good ? sqrtf(w[k]) : 0.f;
    sqw[k] = s;
    isqw[k] = good ? 1.f / s : 0.f;
  }
  __syncthreads();
  // root[i,j] = sum_k f(w_k) W[i,k] conj(W[j,k]), both roots in one pass
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e % n;
    float2 r = make_float2(0.f, 0.f), s = make_float2(0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      const float2 pk = cmulc(W[j * n + k], W[i * n + k]);
      r = cadd(r, cscale(sqw[k], pk));
      s = cadd(s, cscale(isqw[k], pk));
    }
    root[off + e] = r;
    inv_root[off + e] = s;
  }
}

int threads_for(int n) {
  const int items = n * (n / 2);
  int t = ((items + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

extern "C" {

const char* tnqs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tnqs_jacobi_eigh(const void* a, void* w, void* v, int batch, int n,
                     int max_sweeps, void* stream) {
  const size_t smem = 2 * size_t(n) * n * sizeof(float2) + pair_bytes(n) +
                      round_scratch_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  jacobi_eigh_kernel<<<batch, threads_for(n), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<float*>(w),
      static_cast<float2*>(v), n, max_sweeps);
  return cudaGetLastError();
}

int tnqs_jacobi_pseudo_roots(const void* a, void* root, void* inv_root,
                             int batch, int n, int max_sweeps,
                             void* stream) {
  const size_t smem = 5 * size_t(n) * n * sizeof(float2) +
                      3 * size_t(n) * sizeof(float) + pair_bytes(n) +
                      round_scratch_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_roots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  jacobi_roots_kernel<<<batch, threads_for(n), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<float2*>(root),
      static_cast<float2*>(inv_root), n, max_sweeps);
  return cudaGetLastError();
}

}  // extern "C"
