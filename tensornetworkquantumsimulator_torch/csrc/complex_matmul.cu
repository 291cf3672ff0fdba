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
// accumulated in fp32.  The TPU kernel's point was that the split into
// planes and the recombination stay on chip; so here too: A and B are read
// once as interleaved complex64, split into planes in registers, and C is
// written once as interleaved complex64.
//
// What bounds it on the H100.  The product is 8 N K M real flops per batch
// element (the count of the 4-product form; the Gauss form does 6) on
// 8 (N K + K M + N M) bytes.  At the shapes it is called with the work is
// small: [8,128,128] is 1.0e8 flops on 3.15 MB, 1.5 us at the 67 TFLOP/s
// of fp32 outside the tensor cores (compute-bound); [16,40,40] is 6.6e6
// flops on 0.61 MB, 0.18 us at 3.35 TB/s (memory-bound).  So a call is
// bound by latency, by how many SMs it keeps busy and by its host path;
// [8,512,512] (4.3e9 flops, 50 MB) is where the arithmetic shows.
//
// What the design does about it.
//   * Tensor cores at fp32-class accuracy: the 3xTF32 Gauss tile product of
//     complex_tf32x3.cuh (9 `mma.sync.m16n8k8` TF32 products per 16x8x8 step;
//     plain TF32 would miss the 1e-5 bar).
//   * Tiles sized to fill the 132 SMs: 64x64 (4 warps of 32x32) for large
//     batches, 32x32 (4 warps of 16x16) for medium, 16x16 (1 warp) for
//     small ones, chosen per call from the CTA count.  [16,40,40] runs
//     144 CTAs of 16x16, [8,128,128] 128 CTAs of 32x32.  The batch is
//     folded into gridDim.x (gridDim.z stops at 65535).
//   * cp.async double buffering: the next K chunk is in flight while the
//     tensor cores work on this one; 16-byte copies (two complex values)
//     when K and M are even and the operands 16-byte aligned, else 8-byte.
//     Out-of-range elements are zero-filled by the copy itself.
//   * K runs in chunks of 32 (16 for 64x64 tiles) but the k-steps stop at
//     the last multiple of 8 that holds data: no zero-padded step wider
//     than the MMA depth (K = 40 is five steps, not eight).
//   * Shared-memory rows padded to 4 mod 16 complex values, so the fragment
//     loads are free of bank conflicts.
//   * The tensor cores' sums are promoted into fp32 registers after every
//     chunk, so the error does not grow with K (complex_tf32x3.cuh).
//
// Interface: one extern "C" function taking device pointers and a stream;
// it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "complex_tf32x3.cuh"

namespace {

using namespace tnqs;

// CTA of WM x WN warps, each warp 16 MT rows x 8 NT columns; K chunk BK;
// VEC complex values per cp.async.
template <int WM, int WN, int MT, int NT, int BK, int VEC>
__global__ void __launch_bounds__(WM * WN * 32)
    gauss_tc_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
                    float2* __restrict__ c, int n, int k, int m, int tiles_n,
                    int tiles_m) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * 16 * MT;
  constexpr int BN = WN * 8 * NT;
  constexpr int LDA = BK + 4;  // 4 mod 16 complex: conflict-free fragments
  constexpr int LDB = BN + 4;
  static_assert(LDA % 16 == 4 && LDB % 16 == 4, "padding");
  __shared__ __align__(16) float2 As[2][BM * LDA];
  __shared__ __align__(16) float2 Bs[2][BK * LDB];

  const int tiles = tiles_n * tiles_m;
  const long long block = blockIdx.x;
  const long long batch = block / tiles;
  const int tile = int(block - batch * tiles);
  const int row0 = (tile / tiles_m) * BM;
  const int col0 = (tile % tiles_m) * BN;
  const float2* a_mat = a + size_t(batch) * n * k;
  const float2* b_mat = b + size_t(batch) * k * m;
  float2* c_mat = c + size_t(batch) * n * m;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  // stage the K chunk at k0 into buffer s
  auto load_chunk = [&](int k0, int s) {
    constexpr int a_per_row = BK / VEC;
    for (int i = tid; i < BM * a_per_row; i += kThreads) {
      const int r = i / a_per_row, q = (i % a_per_row) * VEC;
      const bool ok = row0 + r < n && k0 + q < k;
      const float2* src = ok ? a_mat + size_t(row0 + r) * k + k0 + q : a_mat;
      cp_async<8 * VEC>(&As[s][r * LDA + q], src, ok ? 8 * VEC : 0);
    }
    constexpr int b_per_row = BN / VEC;
    for (int i = tid; i < BK * b_per_row; i += kThreads) {
      const int r = i / b_per_row, q = (i % b_per_row) * VEC;
      const bool ok = k0 + r < k && col0 + q < m;
      const float2* src = ok ? b_mat + size_t(k0 + r) * m + col0 + q : b_mat;
      cp_async<8 * VEC>(&Bs[s][r * LDB + q], src, ok ? 8 * VEC : 0);
    }
  };

  Acc<true> acc[MT][NT];
  zero_acc<true, MT, NT>(acc);
  float2 sum[MT][NT][4];  // promoted after every chunk (complex_tf32x3.cuh)
  zero_sum<MT, NT>(sum);

  const int chunks = (k + BK - 1) / BK;
  load_chunk(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) load_chunk((kc + 1) * BK, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float2* as = &As[kc & 1][(wm * 16 * MT) * LDA];
    const float2* bs = &Bs[kc & 1][wn * 8 * NT];
    const int steps = min(BK, k - kc * BK + 7) / 8;  // no empty step
    for (int st = 0; st < steps; ++st)
      warp_k8<true, MT, NT, false>(acc, as + 8 * st, LDA, 1,
                                   bs + 8 * st * LDB, LDB, 1);
    promote<true, MT, NT>(sum, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm * 16 * MT + 16 * i + acc_row(e);
        const int col = col0 + wn * 8 * NT + 8 * j + acc_col(e);
        if (row < n && col < m)
          c_mat[size_t(row) * m + col] = sum[i][j][e];
      }
}

template <int WM, int WN, int MT, int NT, int BK>
cudaError_t launch(const float2* a, const float2* b, float2* c, int batch,
                   int n, int k, int m, bool vec2, cudaStream_t stream) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  const int tiles_n = (n + BM - 1) / BM, tiles_m = (m + BN - 1) / BN;
  const long long blocks = (long long)batch * tiles_n * tiles_m;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec2)
    gauss_tc_kernel<WM, WN, MT, NT, BK, 2>
        <<<unsigned(blocks), WM * WN * 32, 0, stream>>>(a, b, c, n, k, m,
                                                         tiles_n, tiles_m);
  else
    gauss_tc_kernel<WM, WN, MT, NT, BK, 1>
        <<<unsigned(blocks), WM * WN * 32, 0, stream>>>(a, b, c, n, k, m,
                                                         tiles_n, tiles_m);
  return cudaGetLastError();
}

long long ctas(int batch, int n, int m, int tile) {
  return (long long)batch * ((n + tile - 1) / tile) * ((m + tile - 1) / tile);
}

}  // namespace

extern "C" int tnqs_complex_matmul(const void* a, const void* b, void* c,
                                   int batch, int n, int k, int m,
                                   void* stream_) {
  const float2* pa = static_cast<const float2*>(a);
  const float2* pb = static_cast<const float2*>(b);
  float2* pc = static_cast<float2*>(c);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  // 16-byte copies need every row start 16-byte aligned
  const bool vec2 = k % 2 == 0 && m % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // the largest tile that still gives about two CTAs per SM (one for 32x32)
  if (n >= 64 && m >= 64 && ctas(batch, n, m, 64) >= 264)
    return launch<2, 2, 2, 4, 16>(pa, pb, pc, batch, n, k, m, vec2, stream);
  if (n >= 32 && m >= 32 && ctas(batch, n, m, 32) >= 128)
    return launch<2, 2, 1, 2, 32>(pa, pb, pc, batch, n, k, m, vec2, stream);
  return launch<1, 1, 1, 2, 32>(pa, pb, pc, batch, n, k, m, vec2, stream);
}
