// A float32-faithful matrix product on Hopper's tensor cores (3xTF32), for
// the capsule routing at the discriminator class head (materialised votes):
// the vote product of K1-D (capsule_routing.cu) and the three products of
// K2-D (capsule_routing_bwd.cu).
//
//   C[m, n] = sum_k A(m, k) B(k, n)
//   A(m, k) = A[m * lda + k] (K-major) or A[k * lda + m] (M-major)
//   B(k, n) = B[n * ldb + k] (K-major) or B[k * ldb + n] (N-major)
//   C row-major with leading dimension ldc; the layouts of the products:
//   K- and K-major (u), K- and N-major (K2-D's dx), M- and N-major (its dW).
//
// Each float32 operand is split into a tf32 high part and a tf32 low part
// (tf32.cuh), and every product is accumulated in float32 as lo.hi + hi.lo
// + hi.hi; lo.lo is dropped. That keeps ~22 of float32's 24
// significand bits at three times the tensor-core work: single TF32 keeps
// 11 and would change the backward's result beyond K2's bar.
//
// A 256-thread block (two warpgroups) computes a 128 x 104 tile of C with
// wgmma m64n104k8, stepping through K in slices of 32:
// - cp.async stages each float32 slice of A and B in a three-stage ring,
//   in the layout it has in device memory (padded rows: no bank conflicts);
// - every thread splits a share of the B slice into hi and lo tiles,
//   K-major with the 128-byte swizzle that wgmma reads (the split also
//   transposes an N-major B: wgmma takes tf32 operands K-major only);
// - each warp splits its own A fragments in registers, so A needs no
//   K-major copy either;
// - per slice a warpgroup issues 12 wgmma (4 steps of 8 x 3 terms) into a
//   fresh float32 partial sum, then splits the next slice's B. The tensor
//   cores' float32 accumulation does not round to nearest, so the partial
//   sum of each 32-deep slice is added to the running sum in IEEE float32
//   on the CUDA cores: the long K sums stay float32-faithful.
// 128 x 104 tiles give the flagship's u and dW 124 and 130 blocks, one wave
// of one block per SM. A product with too few tiles (dx = du . W at the
// flagship: 20 tiles, K = 3216) splits K over blockIdx.z into float32
// partial slabs that a second kernel sums in split order: no atomics, so
// two calls give the same bits.
//
// What bounds it: the steps of a slice run one after another in every
// warp, ~3,200 cycles a slice on an H100 (clock64 stamps: A split ~350,
// cp.async issue ~700, the 12 wgmma ~1,050, whose register operand holds
// the issuing warps while the tensor cores run, B split ~850, sums and
// barriers ~250) against ~1,250 cycles of tensor-core work. A producer
// warpgroup that stages and splits beside the consumers (setmaxnreg, named
// barriers) was slower (one warpgroup) or no faster (two): shared-memory
// traffic, not threads, bounds the staging and the split.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace gemm_tf32x3 {

using tf32::split;

constexpr int kBM = 128;
constexpr int kBN = 104;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kAcc = kBN / 2;  // accumulator registers of m64n104
// padded float32 staging strides, in floats, per layout
constexpr int kKMajorStride = kBK + 4;  // [m or n][k]
constexpr int kAMStride = kBM + 8;      // [k][m]
constexpr int kBNStride = kBN + 8;      // [k][n]
constexpr int kAStage = kBM * kKMajorStride;  // >= kBK * kAMStride
constexpr int kBStage = kBN * kKMajorStride;  // >= kBK * kBNStride
constexpr int kStageFloats = kAStage + kBStage;
// a swizzled K-major tf32 tile of B: kBN rows of 128 bytes
constexpr int kSwTile = kBN * kBK;
// shared memory: 1 KB of alignment slack | hi, lo tiles x 2 buffers (each
// 1024-byte aligned: 13 KB) | the float32 staging ring
constexpr size_t kSmemBytes =
    1024 + sizeof(float) * (4 * (size_t)kSwTile + kStages * kStageFloats);

static_assert(kSwTile * 4 % 1024 == 0, "swizzled tiles must stay aligned");
static_assert(kSmemBytes <= 232448, "the ring exceeds a block's smem");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes of src copied (0..size), the rest of the size zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stages one rows x cols tile whose source rows are contiguous: row r,
// columns c.. of the tile come from src[(r0 + r) * ld + c0 + c]; rows at or
// past row_end and columns at or past col_end read as zero. kVec floats per
// copy (4 needs ld, c0 and the base 16-byte aligned).
template <int kRows, int kCols, int kStride, int kVec>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, int r0, int row_end,
                                      int c0, int col_end, int tid) {
  constexpr int kPerRow = kCols / kVec;
  constexpr int kCopies = kRows * kPerRow;
#pragma unroll(kVec == 4 ? 4 : 1)
  for (int q = 0; q < (kCopies + kThreads - 1) / kThreads; ++q) {
    const int idx = tid + q * kThreads;
    if (kCopies % kThreads && idx >= kCopies) break;
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    int n = 0;
    const float* p = src;
    if (gr < row_end && gc < col_end) {
      n = min(kVec, col_end - gc) * 4;
      p = src + gr * ld + gc;
    }
    cp_async<kVec * 4>(dst + r * kStride + c, p, n);
  }
}

// Float offset of (n, k) in a K-major tile of 128-byte rows with the
// 128-byte swizzle: the 16-byte chunk k / 4 of row n lands at chunk
// (k / 4) ^ (n % 8).
__device__ __forceinline__ int swizzled(int n, int k) {
  return n * kBK + ((((k >> 2) ^ (n & 7))) << 2) + (k & 3);
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address, leading offset 1 (unused when swizzled), 1024
// bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 104] (+)= A[64 x 8] B[104 x 8]^T: A from registers (tf32, the
// m16n8k8 fragment of each warp's 16 rows), B a K-major swizzled tile; d is
// overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_n104(float (&d)[kAcc],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51},"
      " {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <bool kAK, bool kBKm, int kVec>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K, long long lda,
            long long ldb, long long ldc, int k_chunk) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  float* ring = sw + 4 * kSwTile;  // hi[2] | lo[2] then the staging ring
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's rows
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int tiles = (ke - kb + kBK - 1) / kBK;
  C += (size_t)blockIdx.z * M * ldc;

  auto load = [&](int kt) {
    float* as = ring + (kt % kStages) * kStageFloats;
    float* bs = as + kAStage;
    const int k0 = kb + kt * kBK;
    if (kAK)
      stage<kBM, kBK, kKMajorStride, kVec>(as, A, lda, m0, M, k0, ke, tid);
    else
      stage<kBK, kBM, kAMStride, kVec>(as, A, lda, k0, ke, m0, M, tid);
    if (kBKm)
      stage<kBN, kBK, kKMajorStride, kVec>(bs, B, ldb, n0, N, k0, ke, tid);
    else
      stage<kBK, kBN, kBNStride, kVec>(bs, B, ldb, k0, ke, n0, N, tid);
  };
  // the staged B of slice kt into the hi and lo tiles of buffer kt % 2, a
  // 16-byte chunk (4 along K) at a time; the staged rows are read along
  // their contiguous axis (K-major: one 16-byte load; N-major: four words
  // of consecutive n across the warp)
  auto convert = [&](int kt) {
    const float* bs = ring + (kt % kStages) * kStageFloats + kAStage;
    float* hi = sw + (kt & 1) * kSwTile;
    float* lo = hi + 2 * kSwTile;
    for (int c = tid; c < kSwTile / 4; c += kThreads) {
      const int n = kBKm ? c / (kBK / 4) : c % kBN;
      const int k = 4 * (kBKm ? c % (kBK / 4) : c / kBN);
      float v[4];
      if (kBKm) {
        const float4 q = *reinterpret_cast<const float4*>(
            bs + n * kKMajorStride + k);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = bs[(k + j) * kBNStride + n];
      }
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split(v[j], h[j], l[j]);
      *reinterpret_cast<uint4*>(hi + swizzled(n, k)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + swizzled(n, k)) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;

  load(0);
  cp_async_commit();
  if (tiles > 1) load(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  convert(0);
  __syncthreads();
  for (int kt = 0; kt < tiles; ++kt) {
    // this warp's A fragments of slice kt, split in registers
    const float* as = ring + (kt % kStages) * kStageFloats;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wrow + g + (e & 1) * 8, k = 8 * s + t + (e >> 1) * 4;
        split(kAK ? as[m * kKMajorStride + k] : as[k * kAMStride + m],
              ah[s][e], al[s][e]);
      }
    // stage slice kt + 2 (its ring slot held slice kt - 1, done with):
    // issued before the wgmma, whose register operands hold the warps while
    // the tensor cores run
    if (kt + 2 < tiles) load(kt + 2);
    cp_async_commit();
    const uint32_t hi = smem_addr(sw + (kt & 1) * kSwTile);
    const uint32_t lo = hi + 2 * kSwTile * 4;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // 8 tf32 = 32 bytes along K per step
      wgmma_n104(part, al[s], smem_desc(hi + 32 * s), s > 0);
      wgmma_n104(part, ah[s], smem_desc(lo + 32 * s), 1);
      wgmma_n104(part, ah[s], smem_desc(hi + 32 * s), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // then split slice kt + 1 for the next step
    if (kt + 1 < tiles) {
      cp_async_wait<1>();
      __syncthreads();
      convert(kt + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(ah[s][e]), "+r"(al[s][e])::"memory");
    // the slice's partial sum joins the running sum in IEEE float32
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    __syncthreads();
  }
  cp_async_wait<0>();

  // accumulator i: row 16 (warp % 4) + g + 8 ((i % 4) / 2) of the
  // warpgroup's 64, column 8 (i / 4) + 2 t + i % 2: pairs of columns, one
  // 8-byte store each where the row stride allows
  const bool pairs = ldc % 2 == 0;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int m = m0 + wrow + g + 8 * ((i % 4) / 2);
    const int n = n0 + 8 * (i / 4) + 2 * t;
    if (m >= M || n >= N) continue;
    float* p = C + m * ldc + n;
    if (pairs && n + 1 < N) {
      *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
    } else {
      p[0] = acc[i];
      if (n + 1 < N) p[1] = acc[i + 1];
    }
  }
}

// out[e] = sum_s part[s * count + e], s in order
__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long count,
                                  int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < count; e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int q = 1; q < splits; ++q) s += part[q * count + e];
    out[e] = s;
  }
}

template <bool kAK, bool kBKm, int kVec>
cudaError_t launch(const float* A, const float* B, float* C, int M, int N,
                   int K, long long lda, long long ldb, long long ldc,
                   int splits, int k_chunk, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<kAK, kBKm, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gemm_kernel<kAK, kBKm, kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      A, B, C, M, N, K, lda, ldb, ldc, k_chunk);
  return cudaGetLastError();
}

// Enqueues C = A . B on `stream`; returns the launches' error code. With
// splits > 1, K is cut into runs of k_chunk (a multiple of kBK; splits
// runs cover K and none is empty), `partial` holds splits x M x N floats
// and ldc must be N. Every pointer 4-byte aligned; the 16-byte copies are
// taken where lda, ldb and both bases allow them.
inline cudaError_t gemm(const float* A, bool a_kmajor, long long lda,
                        const float* B, bool b_kmajor, long long ldb,
                        float* C, long long ldc, int M, int N, int K,
                        int splits, int k_chunk, float* partial,
                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || splits < 1 || (splits > 1 && (!partial || ldc != N)) ||
      k_chunk % kBK || (long long)(splits - 1) * k_chunk >= K ||
      (long long)splits * k_chunk < K)
    return cudaErrorInvalidValue;
  float* out = splits > 1 ? partial : C;
  const bool v4 = lda % 4 == 0 && ldb % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(B) % 16 == 0;
  cudaError_t e = cudaErrorInvalidValue;
#define GEMM_TF32X3_CASE(AK, BKM)                                          \
  if (a_kmajor == AK && b_kmajor == BKM)                                   \
    e = v4 ? launch<AK, BKM, 4>(A, B, out, M, N, K, lda, ldb, ldc, splits, \
                                k_chunk, stream)                           \
           : launch<AK, BKM, 1>(A, B, out, M, N, K, lda, ldb, ldc, splits, \
                                k_chunk, stream);
  GEMM_TF32X3_CASE(true, true)    // u = x . W^T
  GEMM_TF32X3_CASE(true, false)   // dx = du . W
  GEMM_TF32X3_CASE(false, false)  // dW = du^T . x
#undef GEMM_TF32X3_CASE
  if (e != cudaSuccess || splits == 1) return e;
  const long long count = (long long)M * N;
  splitk_sum_kernel<<<(int)((count + 1023) / 1024), 256, 0, stream>>>(
      partial, C, count, splits);
  return cudaGetLastError();
}

}  // namespace gemm_tf32x3
