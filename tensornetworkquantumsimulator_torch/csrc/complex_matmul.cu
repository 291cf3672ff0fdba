// Batched complex64 matrix product by the 3-multiplication Gauss trick for
// Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernel
//   tensornetworkquantumsimulator_tpu/parallel/pallas_kernels.py
//   K4  complex_matmul (:38, body _gauss_kernel :27)
// C[b] = A[b] @ B[b] for A [batch, N, K], B [batch, K, M], from three real
// products on the re/im planes:
//   P1 = Ar Br,  P2 = Ai Bi,  P3 = (Ar + Ai)(Br + Bi),
//   Cr = P1 - P2,  Ci = P3 - P1 - P2,
// with fp32 accumulation (fp32 FMAs; no TF32 anywhere).  The TPU kernel's
// point was that the split into planes and the recombination stay on chip;
// so here too: A and B are read once as interleaved float2 from device
// memory, split into planes (and the sums Ar + Ai, Br + Bi formed) while
// they are staged into shared memory, and C is written once as interleaved
// complex64.  No plane ever reaches device memory.
//
// What bounds it on the H100.  At the shapes it is called with (batches of
// 40x40 to 128x256 matrices) the products are small: [8,128,128] is 50
// MFLOP of real work and 0.8 MB of traffic, so a call is bound by latency
// and by how many SMs it keeps busy, not by bandwidth.  Against cuBLAS the
// trick saves a quarter of the multiplies of the 4-product complex GEMM,
// but this first version runs on the SIMT fp32 pipes, not the tensor
// cores (whose fp32-accurate modes need a 3xTF32 split; later work).
//
// What the design does about it.  One CTA per (batch element, 32x32 output
// tile), the batch folded into gridDim.x (gridDim.z stops at 65535).  The
// CTA loops over K in chunks of 32: 256 threads stage a 32x32 chunk of A
// and of B (four float2 loads each, neighbouring threads on neighbouring
// addresses) into three shared planes each, then every thread accumulates
// a 2x2 micro-tile of P1, P2 and P3 in registers.  Rows and columns of the
// micro-tile are 16 apart, so a warp's reads of the B planes are
// consecutive words and its reads of the A planes are broadcasts.  Any N,
// K, M work: the loads zero-fill outside the matrix and the stores are
// guarded.
//
// Interface: one extern "C" function taking device pointers and a stream;
// it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // output tile edge and K chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 2 outputs each
constexpr int kHalf = 16;

__global__ void __launch_bounds__(kThreads)
    gauss_matmul_kernel(const float2* __restrict__ a,
                        const float2* __restrict__ b, float2* __restrict__ c,
                        int n, int k, int m, int tiles_n, int tiles_m) {
  // +1 column of padding keeps the transposed-role stores conflict free
  __shared__ float a_re[kTile][kTile + 1];
  __shared__ float a_im[kTile][kTile + 1];
  __shared__ float a_sum[kTile][kTile + 1];
  __shared__ float b_re[kTile][kTile + 1];
  __shared__ float b_im[kTile][kTile + 1];
  __shared__ float b_sum[kTile][kTile + 1];

  const int tiles = tiles_n * tiles_m;
  const long long block = blockIdx.x;
  const long long batch = block / tiles;
  const int tile = int(block - batch * tiles);
  const int row0 = (tile / tiles_m) * kTile;
  const int col0 = (tile % tiles_m) * kTile;

  const float2* a_mat = a + size_t(batch) * n * k;
  const float2* b_mat = b + size_t(batch) * k * m;
  float2* c_mat = c + size_t(batch) * n * m;

  const int tid = threadIdx.x;
  const int tx = tid % kHalf;
  const int ty = tid / kHalf;

  float p1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float p2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float p3[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < k; k0 += kTile) {
    // stage A[row0 : row0+32, k0 : k0+32] and B[k0 : k0+32, col0 : col0+32]
#pragma unroll
    for (int i = 0; i < (kTile * kTile) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kTile;
      const int q = idx % kTile;
      float2 va = make_float2(0.f, 0.f);
      if (row0 + r < n && k0 + q < k) va = a_mat[size_t(row0 + r) * k + k0 + q];
      a_re[r][q] = va.x;
      a_im[r][q] = va.y;
      a_sum[r][q] = va.x + va.y;
      float2 vb = make_float2(0.f, 0.f);
      if (k0 + r < k && col0 + q < m) vb = b_mat[size_t(k0 + r) * m + col0 + q];
      b_re[r][q] = vb.x;
      b_im[r][q] = vb.y;
      b_sum[r][q] = vb.x + vb.y;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kTile; ++q) {
      float ar[2], ai[2], as[2], br[2], bi[2], bs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ar[i] = a_re[ty + kHalf * i][q];
        ai[i] = a_im[ty + kHalf * i][q];
        as[i] = a_sum[ty + kHalf * i][q];
        br[i] = b_re[q][tx + kHalf * i];
        bi[i] = b_im[q][tx + kHalf * i];
        bs[i] = b_sum[q][tx + kHalf * i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          p1[i][j] = fmaf(ar[i], br[j], p1[i][j]);
          p2[i][j] = fmaf(ai[i], bi[j], p2[i][j]);
          p3[i][j] = fmaf(as[i], bs[j], p3[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + kHalf * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = col0 + tx + kHalf * j;
      if (col < m) {
        c_mat[size_t(row) * m + col] =
            make_float2(p1[i][j] - p2[i][j], p3[i][j] - p1[i][j] - p2[i][j]);
      }
    }
  }
}

}  // namespace

extern "C" int tnqs_complex_matmul(const void* a, const void* b, void* c,
                                   int batch, int n, int k, int m,
                                   void* stream) {
  const int tiles_n = (n + kTile - 1) / kTile;
  const int tiles_m = (m + kTile - 1) / kTile;
  const long long blocks = (long long)batch * tiles_n * tiles_m;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  gauss_matmul_kernel<<<unsigned(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<float2*>(c), n, k, m, tiles_n, tiles_m);
  return cudaGetLastError();
}
