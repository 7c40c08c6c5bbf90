// Pieces shared by the capsule-routing kernels (capsule_routing.cu, K1, and
// capsule_routing_bwd.cu, K2): warp reductions, capsule rows of 8 floats,
// the squash and its derivative, the cluster exchange of per-row
// statistics, and the forward routing of a vote slice on a cluster, which
// K1-D (the forward at the discriminator class head) and K2-D (its
// backward, which recomputes the forward with stashes) both run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <cooperative_groups.h>

#include "gemm_tf32x3.cuh"

namespace capsule {

constexpr int kL = 8;  // the factored form's in_length: two float4 a row
constexpr int kRouteThreads = 512;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&r)[kL]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void load8_global(const float* p, float (&r)[kL]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ float dot8(const float (&a)[kL],
                                      const float (&b)[kL]) {
  float s = 0.f;
#pragma unroll
  for (int l = 0; l < kL; ++l) s = fmaf(a[l], b[l], s);
  return s;
}

__device__ __forceinline__ float squash_scale(float n2) {
  return n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f);
}

// squash scale g(n2) and its derivative dg/dn2 (capsule_pallas.py:196-201)
__device__ __forceinline__ void squash_grad(float n2, float& g, float& gp) {
  const float inv1 = 1.f / (1.f + n2);
  const float rs = rsqrtf(n2 + 1e-8f);
  g = n2 * inv1 * rs;
  gp = inv1 * rs - n2 * inv1 * inv1 * rs - 0.5f * n2 * inv1 * rs * rs * rs;
}

// The exchange rows of cluster rank q for row i of this warp: lane q < C
// reads rank q's value at xw[off + i]; every lane gets rank q's with a
// shuffle, so that the warp combines them in rank order.
template <typename Cluster>
__device__ __forceinline__ float remote_row(Cluster& cluster, float* xw,
                                            int off, int i, int lane, int C) {
  return lane < C ? cluster.map_shared_rank(xw, lane)[off + i] : 0.f;
}

// The cluster-wide (max, sum of exp) of row i from every rank's (max_q,
// sum_q) at xw[i], xw[I + i], combined in rank order by every lane of the
// warp: the same bits in every block.
template <typename Cluster>
__device__ __forceinline__ void softmax_stats(Cluster& cluster, float* xw,
                                              int I, int i, int lane, int C,
                                              float& m, float& z) {
  const float mq = remote_row(cluster, xw, 0, i, lane, C);
  const float zq = remote_row(cluster, xw, I, i, lane, C);
  m = -INFINITY;
  for (int q = 0; q < C; ++q) m = fmaxf(m, __shfl_sync(~0u, mq, q));
  z = 0.f;
  for (int q = 0; q < C; ++q)
    z = fmaf(__shfl_sync(~0u, zq, q), expf(__shfl_sync(~0u, mq, q) - m), z);
}

// ---- votes form: one sample's routing on a cluster --------------------------

// Cluster rank `rank` of C owns the output capsules [rank J / C, (rank + 1)
// J / C) of sample b: nj of them, at most njm = ceil(J / C).
struct VoteSlice {
  int b, j0, nj, njm;
  const float* u;  // u[b, i, j0 + jl, o] at u[i * ldu + jl * O + o]
  size_t ldu;
};

// Starts a block's slice: its votes into shared memory at `us` where `keep`
// (all of the slice's 16-byte copies in flight at once; J O a multiple of
// 4), else read from u [B, I, J, O] in device memory; the first pass's
// logits bl [I][nj] = 0, whose slice statistics (max 0, sum nj) go to the
// first exchange rows xch [2 I].
template <int O>
__device__ __forceinline__ VoteSlice vote_slice(int C, int rank,
                                                const float* __restrict__ u,
                                                float* us, float* bl,
                                                float* xch, int I, int J,
                                                bool keep) {
  VoteSlice sl;
  sl.b = blockIdx.x / C;
  sl.j0 = rank * J / C;
  sl.nj = (rank + 1) * J / C - sl.j0;
  sl.njm = (J + C - 1) / C;
  const int tid = threadIdx.x;
  const int JO = sl.nj * O;
  const float* ug = u + (size_t)sl.b * I * J * O + (size_t)sl.j0 * O;
  sl.u = ug;
  sl.ldu = (size_t)J * O;
  if (keep) {
    const int row4 = JO / 4;
    for (int q = tid; q < I * row4; q += kRouteThreads)
      gemm_tf32x3::cp_async<16>(
          us + 4 * q, ug + (size_t)(q / row4) * J * O + 4 * (q % row4), 16);
    gemm_tf32x3::cp_async_commit();
  }
  for (int p = tid; p < I * sl.nj; p += kRouteThreads) bl[p] = 0.f;
  for (int i = tid; i < I; i += kRouteThreads) {
    xch[i] = 0.f;
    xch[I + i] = (float)sl.nj;
  }
  if (keep) {
    gemm_tf32x3::cp_async_wait<0>();
    sl.u = us;
    sl.ldu = JO;
  }
  return sl;
}

// R forward routing passes over a block's vote slice. Rows i of [I][nj]
// go to warps, columns to lanes: each warp owns its rows through the
// softmax and combines their cluster-wide statistics itself. Rows of
// [nj][O] (s, v) go to threads, the O values of one output capsule to O
// neighbouring lanes (a multiple of 32 threads take part, so that whole
// warps reduce |s|^2). Each pass's statistics cross the cluster through
// exchange rows xch [2][2 I] that alternate between their two halves
// (`xp` counts the exchanges), one cluster barrier a pass.
// kStash (K2-D): the couplings c [R][I][njm], s and v [R][njm][O] of every
// pass stay at cst, sst and vst. Otherwise (K1-D) c and v take one buffer
// each and the last pass writes v to `out` (this slice's [nj][O] rows).
template <int O, bool kStash, typename Cluster>
__device__ __forceinline__ void route_forward(Cluster& cluster,
                                              const VoteSlice& sl, float* bl,
                                              float* cst, float* sst,
                                              float* vst, float* xch,
                                              int& xp, float* __restrict__ out,
                                              int I, int C, int R) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nj = sl.nj, njm = sl.njm;
  const int JO = nj * O;
  const int JO32 = (JO + 31) & ~31;
  const float* ub = sl.u;
  const size_t ldu = sl.ldu;
  for (int r = 0; r < R; ++r) {
    float* cs = cst + (kStash ? (size_t)r * I * njm : 0);
    float* xw = xch + (xp++ & 1) * 2 * I;
    cluster.sync();  // every slice's (max, sum of exp) is in place
    for (int i = warp; i < I; i += kRouteWarps) {
      float m, z;
      softmax_stats(cluster, xw, I, i, lane, C, m, z);
      const float zi = 1.f / z;
      for (int j = lane; j < nj; j += 32)
        cs[i * nj + j] = expf(bl[i * nj + j] - m) * zi;
    }
    __syncthreads();
    const bool last = r == R - 1;
    float* ss = sst + (kStash ? (size_t)r * njm * O : 0);
    float* vs = vst + (kStash ? (size_t)r * njm * O : 0);
    for (int t = tid; t < JO32; t += kRouteThreads) {
      const bool valid = t < JO;
      const int jl = t / O;
      float s = 0.f;
      if (valid)
        for (int i = 0; i < I; ++i)
          s = fmaf(cs[i * nj + jl], ub[i * ldu + t], s);
      float n2 = s * s;
#pragma unroll
      for (int off = O / 2; off > 0; off >>= 1)
        n2 += __shfl_xor_sync(0xffffffffu, n2, off);
      if (valid) {
        const float v = s * squash_scale(n2);
        if (kStash) {
          ss[t] = s;
          vs[t] = v;
        } else if (last) {
          out[t] = v;
        } else {
          vs[t] = v;
        }
      }
    }
    __syncthreads();
    if (last) break;
    // agreement update, then this slice's statistics of the new logits
    float* xn = xch + (xp & 1) * 2 * I;
    for (int i = warp; i < I; i += kRouteWarps) {
      float m = -INFINITY;
      for (int j = lane; j < nj; j += 32) {
        const float* up = ub + i * ldu + (size_t)j * O;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < O; ++q) {
          const int o = (q + j) & (O - 1);  // rotated: no bank conflicts
          acc = fmaf(up[o], vs[j * O + o], acc);
        }
        bl[i * nj + j] += acc;
        m = fmaxf(m, bl[i * nj + j]);
      }
      m = warp_max(m);
      float z = 0.f;
      for (int j = lane; j < nj; j += 32) z += expf(bl[i * nj + j] - m);
      z = warp_sum(z);
      if (lane == 0) {
        xn[i] = m;
        xn[I + i] = z;
      }
    }
  }
}

// Selects `device` in this library's own CUDA runtime (whose current
// device is separate from PyTorch's) and clears the error that a refused
// launch of an earlier call left behind, so that this call's launch checks
// report its own.
inline cudaError_t begin_call(int device) {
  const cudaError_t e = cudaSetDevice(device);
  cudaGetLastError();
  return e;
}

// Launches `kernel` on B clusters of C blocks of kRouteThreads threads with
// `smem` bytes of dynamic shared memory each; returns the launch's error
// (a cluster size or a shared-memory size that the card refuses fails the
// launch: nothing falls back).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int B, int C,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kRouteThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace capsule
