// Pieces shared by the capsule-routing kernels (capsule_routing.cu, K1, and
// capsule_routing_bwd.cu, K2): warp reductions, capsule rows of 8 floats,
// the squash and its derivative, the cluster exchange of per-row
// statistics, and the two forms of one sample's forward routing on a
// cluster of blocks that split the output capsules:
// - the factored form (in_length 8, the generator head), which K1-G runs
//   and K2-G recomputes with stashes (factored_forward);
// - the votes form (the discriminator class head), which K1-D runs and
//   K2-D recomputes with stashes (route_forward).

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

// ---- factored form: one sample's routing on a cluster ------------------------

// Rows of 8 floats per output capsule ([nj][8]: a, e, t and the stashes of
// a and y) are two planes of float4: (j, l) at (l / 4) 4 njm + 4 j + l % 4,
// so that lanes reading consecutive j read consecutive 16-byte words.
__device__ __forceinline__ void ld_row(const float* p, int njm, int j,
                                       float (&r)[kL]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[j];
  const float4 hi = reinterpret_cast<const float4*>(p)[njm + j];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// half h (0: l < 4, 1: l >= 4) of a row of 8
__device__ __forceinline__ float4 half4(const float (&r)[kL], int h) {
  return h ? make_float4(r[4], r[5], r[6], r[7])
           : make_float4(r[0], r[1], r[2], r[3]);
}

// plane h of row j; each lane of a pair stores one
__device__ __forceinline__ void st_half(float* p, int njm, int j, int h,
                                        const float (&r)[kL]) {
  reinterpret_cast<float4*>(p)[h * njm + j] = half4(r, h);
}

// W [J][O][8] as two float4 planes a row o: wt[(2 o + h) J + j] holds
// W[j][o][4 h .. 4 h + 3], so that lanes reading consecutive j read
// consecutive 16-byte words (W's own layout puts them 1 KB apart: 8x the
// L1 wavefronts, which made K2-G's capsule phases 4x slower).
__global__ void w_planes_kernel(const float4* __restrict__ w,
                                float4* __restrict__ wt, int J, int O) {
  const int n = 2 * J * O;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x)
    wt[t] = __ldg(w + (size_t)(t % J) * 2 * O + t / J);
}

inline cudaError_t launch_w_planes(const float* w, float* wt, int J, int O,
                                   cudaStream_t stream) {
  w_planes_kernel<<<(2 * J * O + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(wt), J,
      O);
  return cudaGetLastError();
}

// row o of W_j, j a global output capsule
__device__ __forceinline__ void ld_w(const float4* __restrict__ wt, int J,
                                     int o, int j, float (&r)[kL]) {
  const float4 lo = __ldg(wt + (size_t)2 * o * J + j);
  const float4 hi = __ldg(wt + (size_t)(2 * o + 1) * J + j);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// Cluster rank `rank` of C owns the output capsules [j0, j0 + nj) of sample
// b, j0 = rank J / C: nj of them, at most njm = ceil(J / C). Arrays over
// (i, j) have rows of ldp floats: njm rounded up to 32, plus 16, so that
// the two lanes of a pair read rows 2k and 2k + 1 in different banks.
struct FactoredSlice {
  int b, j0, nj, njm, ldp;
};

__host__ __device__ inline int factored_ldp(int njm) {
  return ((njm + 31) & ~31) + 16;
}

__device__ __forceinline__ FactoredSlice factored_slice(int rank, int J,
                                                        int C) {
  FactoredSlice sl;
  sl.b = blockIdx.x / C;
  sl.j0 = rank * J / C;
  sl.nj = (rank + 1) * J / C - sl.j0;
  sl.njm = (J + C - 1) / C;
  sl.ldp = factored_ldp(sl.njm);
  return sl;
}

// R forward routing passes of one sample's slice, the votes never formed
// (s_j = W_j y_j with y_j = sum_i c_ij x_i, and b_ij = x_i . a_j with a_j =
// sum over passes of W_j^T v_j). Shared memory: xs [I][8] (x), acur
// [njm][8] (a, zero at the start), kk [I], the exchange rows xch [2][2 I];
// cb [I][ldp] (shared memory or the block's part of a scratch) takes the
// exponentials, once a pass, which with the row scale kk are the
// couplings. Work over (i, j) goes to warps by input capsule and lanes by
// output capsule, so that a row's max and sum are warp reductions; each
// slice's (max, sum of exp) of every row crosses the cluster through xch
// behind one cluster barrier a pass (`xp` counts the exchanges, the rows
// alternate between xch's halves) and every block combines them in rank
// order: the same bits in every block and every call. Work per output
// capsule (y_j, then the products with W_j read from its planes wt) goes to
// two lanes each, one per half of the rows i or of W_j's O rows, combined
// by a shuffle.
// kStash (K2-G): a_r and y_r of every pass go to the stashes sa and sy
// [R][8 njm], the max and 1/sum of every pass to mx and zinv [R][I], and
// the last pass ends there. Otherwise (K1-G) the last pass writes v_j =
// squash(W_j y_j) to `out` (this slice's [nj][O] rows), the pair's lanes
// taking alternate fours of W_j's rows, one float4 store per four.
template <int O, bool kStash, typename Cluster>
__device__ __forceinline__ void factored_forward(
    Cluster& cluster, const FactoredSlice& sl, const float4* __restrict__ wt,
    const float* xs, float* acur, float* cb, float* kk, float* xch, int& xp,
    float* sa, float* sy, float* mx, float* zinv, float* __restrict__ out,
    int I, int J, int C, int R) {
  constexpr int kHalf = O / 2;
  constexpr int kPairStride = kRouteThreads / 2;
  // row loops: two iterations in flight, but one at O = 16, where ptxas
  // spills with two (K2-G's registers)
  constexpr int kRowUnroll = O == 32 ? 2 : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = lane >> 4;  // per-capsule phases: which lane of the pair
  const int nj = sl.nj, njm = sl.njm, ldp = sl.ldp;
  for (int r = 0; r < R; ++r) {
    float* xw = xch + (xp++ & 1) * 2 * I;
    // logits x_i . a_j of the slice into c, each row's max over the slice,
    // then exp(b - max) in place and its sum
    for (int i = warp; i < I; i += kRouteWarps) {
      float xi[kL];
      load8(xs + i * kL, xi);
      float* row = cb + (size_t)i * ldp;
      float m = -INFINITY;
#pragma unroll(kRowUnroll)
      for (int j = lane; j < nj; j += 32) {
        float aj[kL];
        ld_row(acur, njm, j, aj);
        const float bij = dot8(xi, aj);
        row[j] = bij;
        m = fmaxf(m, bij);
      }
      m = warp_max(m);
      float z = 0.f;
#pragma unroll(kRowUnroll)
      for (int j = lane; j < nj; j += 32) {
        const float p = expf(row[j] - m);
        row[j] = p;
        z += p;
      }
      z = warp_sum(z);
      if (lane == 0) {
        xw[i] = m;
        xw[I + i] = z;
      }
    }
    cluster.sync();
    // the cluster's statistics, in rank order; c_ij = p_ij kk_i. Thread i
    // combines row i, its C remote reads issued together.
    for (int i = tid; i < I; i += kRouteThreads) {
      float mq[kMaxCluster], zq[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        mq[q] = -INFINITY;
        zq[q] = 0.f;
        if (q < C) {
          const float* rw = cluster.map_shared_rank(xw, q);
          mq[q] = rw[i];
          zq[q] = rw[I + i];
        }
      }
      float m = -INFINITY, z = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) m = fmaxf(m, mq[q]);
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) z = fmaf(zq[q], expf(mq[q] - m), z);
      const float zi = 1.f / z;
      if (kStash) {
        mx[r * I + i] = m;
        zinv[r * I + i] = zi;
      }
      kk[i] = expf(xw[i] - m) * zi;
    }
    __syncthreads();
    // per output capsule, two lanes each: y_j = sum_i c_ij x_i (even and
    // odd i), then a_j += W_j^T v_j (each lane half of W_j), or v_j
    for (int jb = warp * 16; jb < nj; jb += kPairStride) {
      const bool valid = jb + (lane & 15) < nj;
      const int j = min(jb + (lane & 15), nj - 1);
      float y[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) y[l] = 0.f;
#pragma unroll 4
      for (int i = h; i < I; i += 2) {
        float xi[kL];
        load8(xs + i * kL, xi);
        const float c = cb[(size_t)i * ldp + j] * kk[i];
#pragma unroll
        for (int l = 0; l < kL; ++l) y[l] = fmaf(c, xi[l], y[l]);
      }
#pragma unroll
      for (int l = 0; l < kL; ++l) y[l] += __shfl_xor_sync(~0u, y[l], 16);
      if (!kStash && r == R - 1) {
        float s[kHalf];
        float n2 = 0.f;
#pragma unroll
        for (int k = 0; k < O / 8; ++k) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float wo[kL];
            ld_w(wt, J, 8 * k + 4 * h + c, sl.j0 + j, wo);
            const float so = dot8(wo, y);
            s[4 * k + c] = so;
            n2 = fmaf(so, so, n2);
          }
        }
        n2 += __shfl_xor_sync(~0u, n2, 16);
        const float g = squash_scale(n2);
        if (valid) {
          float4* oj = reinterpret_cast<float4*>(out + (size_t)j * O);
#pragma unroll
          for (int k = 0; k < O / 8; ++k)
            oj[2 * k + h] = make_float4(g * s[4 * k], g * s[4 * k + 1],
                                        g * s[4 * k + 2], g * s[4 * k + 3]);
        }
        continue;
      }
      float aj[kL];
      ld_row(acur, njm, j, aj);
      if (kStash && valid) {
        st_half(sy + (size_t)r * kL * njm, njm, j, h, y);
        st_half(sa + (size_t)r * kL * njm, njm, j, h, aj);
      }
      if (r == R - 1) continue;
      float n2 = 0.f, tv[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) tv[l] = 0.f;
#pragma unroll 4
      for (int q = 0; q < kHalf; ++q) {
        float wo[kL];
        ld_w(wt, J, h * kHalf + q, sl.j0 + j, wo);
        const float so = dot8(wo, y);
        n2 = fmaf(so, so, n2);
#pragma unroll
        for (int l = 0; l < kL; ++l) tv[l] = fmaf(so, wo[l], tv[l]);
      }
      n2 += __shfl_xor_sync(~0u, n2, 16);
      const float g = squash_scale(n2);
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        tv[l] += __shfl_xor_sync(~0u, tv[l], 16);
        aj[l] = fmaf(g, tv[l], aj[l]);
      }
      if (valid) st_half(acur, njm, j, h, aj);
    }
    __syncthreads();
  }
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

// The launch of B clusters of C blocks of kRouteThreads threads with
// `smem` bytes of dynamic shared memory each (attr: the cluster's shape).
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute (&attr)[1],
                                         int B, int C, size_t smem,
                                         cudaStream_t stream) {
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
  return cfg;
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
  const cudaLaunchConfig_t cfg = cluster_config(attr, B, C, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of C blocks of kRouteThreads threads with `smem` bytes
// of dynamic shared memory each the card holds at once
// (cudaOccupancyMaxActiveClusters), or 0 where it cannot say; clears the
// error a refusal leaves.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int C, size_t smem) {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, 1, C, smem, nullptr);
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  cudaGetLastError();
  return e == cudaSuccess ? n : 0;
}

}  // namespace capsule
