// A plain tiled float32 matrix product for the capsule kernels whose vote
// tensor is small enough to exist (the discriminator class head: 16 input
// capsules of length 8*ndf). Included by capsule_routing.cu only: the vote
// product of K1 at in_length > 8 (K1-D). K2-D's three products run on the
// tensor cores instead (gemm_tf32x3.cuh).
//
//   C[m, n] = sum_k A(m, k) B(k, n)
//   A(m, k) = A[m * sam + k * sak],  B(k, n) = B[k * sbk + n * sbn]
//   C row-major with leading dimension ldc.
//
// One 256-thread block computes a 64 x 64 tile of C, stepping through K in
// slices of 16 staged in shared memory; each thread keeps a 4 x 4 set of
// outputs in registers (rows ty + 16a, columns tx + 16b, so that a warp
// reads shared memory without bank conflicts). A tile is loaded along
// whichever of its operand's axes is contiguous, so global reads coalesce
// for either layout. Sums are float32 in k order. This is the simple
// form: no tensor cores (the JAX kernel computes the votes in float32),
// no double buffering.

#pragma once

#include <cuda_runtime.h>

namespace capsule_gemm {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K, long long sam,
                long long sak, long long sbk, long long sbn, long long ldc) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      int mm, kk;
      if (sak == 1) { kk = idx % kBK; mm = idx / kBK; }
      else          { mm = idx % kBM; kk = idx / kBM; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? A[m * sam + k * sak] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (kBN * kBK) / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      int nn, kk;
      if (sbk == 1) { kk = idx % kBK; nn = idx / kBK; }
      else          { nn = idx % kBN; kk = idx / kBN; }
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? B[k * sbk + n * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[4], rb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ra[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) rb[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ra[a], rb[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty + 16 * a;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tx + 16 * b;
      if (n < N) C[m * ldc + n] = acc[a][b];
    }
  }
}

// Enqueues the product on `stream`; returns the launch's error code.
inline cudaError_t gemm_f32(const float* A, const float* B, float* C, int M,
                            int N, int K, long long sam, long long sak,
                            long long sbk, long long sbn, long long ldc,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, sam, sak,
                                                  sbk, sbn, ldc);
  return cudaGetLastError();
}

}  // namespace capsule_gemm
