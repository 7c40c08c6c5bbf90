// Capsule dynamic-routing backward (K2) for Hopper, sm_90a.
//
// Replaces text2img_ekl_tpu/ops/capsule_pallas.py::_bwd_kernel (via
// _backward): recompute the forward, stashing what the reverse passes need,
// then reverse squash, the agreement update and the softmax, and pull the
// vote gradient du back through u = W x:
//   dx[b, i] = sum_{j,o} du[b, i, j, o] W[j, o, :]        (per sample)
//   dW[j, o] = sum_{b,i} du[b, i, j, o] x[b, i, :]        (over the batch)
// The JAX package sends the discriminator head to XLA autodiff instead (a
// TPU measurement); here both heads run a kernel.
//
// The TPU sums dW over the batch in a sequential grid. On Hopper the
// samples run in parallel blocks, so dW is a second pass in both forms
// below, with no atomics: the result does not depend on the schedule.
//
// Both forms route one sample on a cluster of C blocks (C from
// ops/capsule_cuda.py: factored_bwd_plan and votes_bwd_plan). Block `rank`
// owns the output capsules [rank J / C, (rank + 1) J / C). Every
// per-sample quantity is local to a slice but the sums over j: the
// softmax's (max, sum of exp) per input capsule in each forward pass and
// rho_i = sum_j c_ij dc_ij in each reverse pass (and, in the factored
// form, dx_i). Those rows go through distributed shared memory behind
// cluster barriers, double buffered, and are combined in rank order, so
// every block gets the same bits and two calls give the same result.
//
// (1) Factored form, in_length 8 (the generator head, K2-G: 48 capsules of
//     8 -> 1024 of 32). The votes of one sample are 6.3 MB, so, as in K1,
//     they never exist. Every du term is rank one, c_ij ds_j or db_ij v_j,
//     so
//       dc_ij = x_i . e_j,  e_j = W_j^T ds_j
//       dx_i += sum_j c_ij e_j + sum_j db_ij t_j,  t_j = W_j^T v_j(prev)
//       dW_j += ds_j (x) y_j + v_j(prev) (x) z_j,  z_j = sum_i db_ij x_i
//       dv_j(prev) = W_j z_j
//     and every per-j quantity is 8 floats. Three launches:
//     - W's rows as float4 planes (wt, 1 MB), so that lanes reading the
//       rows of consecutive output capsules read consecutive 16-byte words:
//       read in place, 1 KB apart, they cost 8x the L1 wavefronts, which
//       made the capsule phases 4x slower;
//     - the routing reversal, C = 3 at the flagship's batch of 32 (96
//       blocks of 341-342 output capsules): a block holds x, its slice's
//       a_j (forward) or e_j (reverse), the stashes of a_j and y_j of every
//       pass, the couplings c_ij of the current pass and the running logit
//       gradient db_ij (I x nj floats each) in shared memory, 218 KB, one
//       block of 512 threads per SM; the plan takes the largest cluster of
//       which the card holds all B at once (an H100 holds 30 clusters of 4
//       such blocks, its GPCs leaving SMs over, so that 4 would run in two
//       waves). At C = 1 or 2 the stashes, c and db live in a per-block
//       scratch in L2. The forward recompute is K1-G's passes with the
//       stashes (capsule_common.cuh::factored_forward). Each pass computes
//       the exponentials once, into c.
//       Work over (i, j) goes to warps by input capsule (rows) and lanes by
//       output capsule (columns), so that a row's sum is a warp reduction;
//       work per output capsule (sums over i, products with W_j) goes to
//       two lanes each, one per half of the rows i or of W_j's O rows,
//       combined by a shuffle. Cluster barriers: one per forward pass, one
//       per reverse pass but the last (pass 0's logits are constant), two
//       for dx's rank-order sum. Each pass writes its dW factors as the
//       pairs dv (x) g y and s (x) (k2 y + g z_next), the same sum as
//       ds (x) y + v (x) z_next;
//     - the sum dW_j = sum over samples and passes of the factors' outer
//       products, one block per output capsule, no atomics.
//     What bounds it: latency. The arithmetic (about 30 operations per
//     (i, j) pair and pass, 0.97 GFLOP at the flagship) takes 0.014 ms at
//     the float32 peak; the routing runs 24 phases between barriers, each
//     1-27 k cycles (clock64 stamps): the per-capsule phases, which read W
//     from L2 (1 MB a sample a pass), about half of the time, the per-(i, j)
//     phases most of the rest, all with 16 warps an SM to hide the latency
//     of shared memory, L2 and the exponentials.
// (2) Materialised votes, in_length > 8 (the discriminator class head,
//     K2-D: 16 x 512 -> 201 x 16, 206 KB of votes per sample). Four
//     launches:
//     - the vote product u = x . W^T, recomputed into a scratch;
//     - the routing reversal. Each block holds its vote slice (52 KB at
//       C = 4), the stashes of c, db, s, ds and v of every pass and its
//       working rows in shared memory. The forward recompute is K1-D's
//       routing with stashes (capsule_common.cuh::route_forward). du is
//       formed once at the end from the stashes and written once;
//     - dx = du . W and dW = du^T . x, whose contraction over the batch is
//       the sum.
//     The three products run on the tensor cores, float32-faithful
//     (3xTF32: wgmma on hi and lo tf32 parts, gemm_tf32x3.cuh); dx, with 20
//     output tiles of 128 x 104, splits its K = J O over blockIdx.z and sums
//     the partials in a fixed order. No atomics: two calls give the same
//     bits. The bound is the products' tensor-core work (5.06 GFLOP at a
//     batch of 32, done three times: 0.031 ms at the TF32 peak); the
//     routing's arithmetic is small (0.055 GFLOP, 0.0008 ms on the SIMT
//     cores) but its time is latency: about ten block or cluster barriers
//     per pass, each over a few thousand elements.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "capsule_common.cuh"

namespace {

using namespace capsule;

// ---- (1) factored form ----------------------------------------------------

// The sum of v[0..7] over the warp's 32 lanes: lane L gets component
// L % 8, by halving the vector at each of three exchanges, then two plain
// steps (9 shuffles instead of 40; a fixed order).
__device__ __forceinline__ float warp_sum8(const float (&v)[kL], int lane) {
  const bool u4 = lane & 4, u2 = lane & 2, u1 = lane & 1;
  float a[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = (u4 ? v[k + 4] : v[k]) +
           __shfl_xor_sync(~0u, u4 ? v[k] : v[k + 4], 4);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (u2 ? a[k + 2] : a[k]) +
           __shfl_xor_sync(~0u, u2 ? a[k] : a[k + 2], 2);
  float s = (u1 ? c[1] : c[0]) + __shfl_xor_sync(~0u, u1 ? c[0] : c[1], 1);
  s += __shfl_xor_sync(~0u, s, 8);
  return s + __shfl_xor_sync(~0u, s, 16);
}

// Where a block's arrays lie, in floats. Shared memory, always: x [I][8] |
// a [nj][8] in the forward passes, e [nj][8] in the reverse ones | dx
// partial [I][8] | max [R][I] | 1/sum [R][I] | the couplings' row scale
// [I] | exchange rows [2][2 I].
// Then, in shared memory where it fits (`keep`), else in the block's part
// of a scratch: the stashes of a and y [R][nj][8] | c [I][ldp] |
// db [I][ldp], nj = njm = ceil(J / C) rows, ldp = njm rounded up to 32,
// plus 16: the two lanes of a pair read rows 2k and 2k + 1 of c and db in
// different banks.
struct FactoredLayout {
  int njm, ldp;
  size_t xs, ae, dxs, mx, zinv, kk, xch, small;
  size_t sa, sy, cb, db, big;
};

__host__ __device__ inline FactoredLayout factored_layout(int I, int J,
                                                          int R, int C) {
  FactoredLayout f;
  f.njm = (J + C - 1) / C;
  f.ldp = factored_ldp(f.njm);
  const size_t n8 = (size_t)kL * f.njm;
  size_t o = 0;
  f.xs = o; o += (size_t)I * kL;
  f.ae = o; o += n8;
  f.dxs = o; o += (size_t)I * kL;
  f.mx = o; o += (size_t)R * I;
  f.zinv = o; o += (size_t)R * I;
  f.kk = o; o += (size_t)I;
  f.xch = o; o += 4 * (size_t)I;
  f.small = (o + 3) & ~(size_t)3;
  o = 0;
  f.sa = o; o += (size_t)R * n8;
  f.sy = o; o += (size_t)R * n8;
  f.cb = o; o += (size_t)I * f.ldp;
  f.db = o; o += (size_t)I * f.ldp;
  f.big = o;
  return f;
}

template <int O>
__global__ void __launch_bounds__(kRouteThreads)
routing_bwd_factored_cluster_kernel(const float* __restrict__ x,
                                    const float4* __restrict__ wt,
                                    const float* __restrict__ dout,
                                    float* __restrict__ dx,
                                    float* __restrict__ scratch,
                                    float* __restrict__ fp,
                                    float* __restrict__ fq, int I, int J,
                                    int R, int keep) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const FactoredSlice sl = factored_slice(rank, J, C);
  const int b = sl.b, j0 = sl.j0, nj = sl.nj;
  const FactoredLayout f = factored_layout(I, J, R, C);
  const int njm = f.njm, ldp = f.ldp;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = lane >> 4;  // per-capsule phases: which lane of the pair
  const int K = 2 * R;      // dW factor pairs per sample
  constexpr int kPairStride = kRouteThreads / 2;
  // row loops: two iterations in flight, but one at O = 16, where ptxas
  // spills with two
  constexpr int kRowUnroll = O == 32 ? 2 : 1;

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + f.xs;
  float* acur = sm + f.ae;  // forward
  float* es = acur;         // reverse
  float* dxs = sm + f.dxs;
  float* mx = sm + f.mx;
  float* zinv = sm + f.zinv;
  float* kk = sm + f.kk;
  float* xch = sm + f.xch;
  float* big = keep ? sm + f.small : scratch + (size_t)blockIdx.x * f.big;
  float* sa = big + f.sa;
  float* sy = big + f.sy;
  float* cb = big + f.cb;
  float* db = big + f.db;

  const float* xb = x + (size_t)b * I * kL;
  for (int k = tid; k < I * kL; k += kRouteThreads) {
    xs[k] = xb[k];
    dxs[k] = 0.f;
  }
  for (int k = tid; k < kL * njm; k += kRouteThreads) acur[k] = 0.f;
  __syncthreads();

  int xp = 0;  // exchanges so far: rows alternate between two buffers
  // ---- forward recompute (K1-G's passes), stashing a_r, y_r, max_r, 1/Z_r
  factored_forward<O, true>(cluster, sl, wt, xs, acur, cb, kk, xch, xp, sa,
                            sy, mx, zinv, nullptr, I, J, C, R);

  // ---- reverse
  for (int r = R - 1; r >= 0; --r) {
    const float* sar = sa + (size_t)r * kL * njm;
    // (a) per output capsule, two lanes each: z_j = sum_i db_ij x_i of the
    //     pass after (db as it left pass r + 1), dv_j = W_j z_j (or the
    //     output gradient), ds_j through the squash, e_j = W_j^T ds_j, and
    //     this pass's dW factors
    for (int jb = warp * 16; jb < nj; jb += kPairStride) {
      const bool valid = jb + (lane & 15) < nj;
      const int j = min(jb + (lane & 15), nj - 1);
      const int jg = j0 + j;
      float z[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) z[l] = 0.f;
      if (r < R - 1) {
#pragma unroll 4
        for (int i = h; i < I; i += 2) {
          float xi[kL];
          load8(xs + i * kL, xi);
          const float d = db[(size_t)i * ldp + j];
#pragma unroll
          for (int l = 0; l < kL; ++l) z[l] = fmaf(d, xi[l], z[l]);
        }
#pragma unroll
        for (int l = 0; l < kL; ++l) z[l] += __shfl_xor_sync(~0u, z[l], 16);
      }
      float y[kL];
      ld_row(sy + (size_t)r * kL * njm, njm, j, y);
      const float* dvj = dout + ((size_t)b * J + jg) * O;
      // this capsule's rows of the factors dv (pair 2 r) and s (2 r + 1)
      float* f0 = fp ? fp + ((size_t)(b * K + 2 * r) * J + jg) * O : nullptr;
      float av[kL], bv[kL];
      float n2 = 0.f, dots = 0.f;
#pragma unroll
      for (int l = 0; l < kL; ++l) av[l] = bv[l] = 0.f;
      // rows o of W_j four at a time, the pair's lanes taking alternate
      // fours: each lane stores its four factors of a kind as one float4
#pragma unroll 1
      for (int o0 = 4 * h; o0 < O; o0 += 8) {
        const float4 d = r == R - 1
                             ? __ldg(reinterpret_cast<const float4*>(dvj + o0))
                             : float4{};
        float dq[4], so[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float wo[kL];
          ld_w(wt, J, o0 + c, jg, wo);
          so[c] = dot8(wo, y);
          dq[c] = r < R - 1 ? dot8(wo, z)
                  : c == 0  ? d.x
                  : c == 1  ? d.y
                  : c == 2  ? d.z
                            : d.w;
          n2 = fmaf(so[c], so[c], n2);
          dots = fmaf(dq[c], so[c], dots);
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            av[l] = fmaf(dq[c], wo[l], av[l]);
            bv[l] = fmaf(so[c], wo[l], bv[l]);
          }
        }
        if (f0 && valid) {
          *reinterpret_cast<float4*>(f0 + o0) =
              make_float4(dq[0], dq[1], dq[2], dq[3]);
          *reinterpret_cast<float4*>(f0 + (size_t)J * O + o0) =
              make_float4(so[0], so[1], so[2], so[3]);
        }
      }
      n2 += __shfl_xor_sync(~0u, n2, 16);
      dots += __shfl_xor_sync(~0u, dots, 16);
      float g, gp;
      squash_grad(n2, g, gp);
      const float k2 = 2.f * dots * gp;
      // ds_o = dv_o g + s_o k2, so e = g sum_o dv_o W_o + k2 sum_o s_o W_o
      float e[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        e[l] = fmaf(g, av[l], k2 * bv[l]);
        e[l] += __shfl_xor_sync(~0u, e[l], 16);
      }
      if (!valid) continue;
      st_half(es, njm, j, h, e);
      if (fq) {
        // dW_j += ds (x) y + v (x) z_next = dv (x) g y + s (x) (k2 y + g z)
        const float4 yh = half4(y, h), zh = half4(z, h);
        float4* q0 = reinterpret_cast<float4*>(
            fq + ((size_t)(b * K + 2 * r) * J + jg) * kL) + h;
        q0[0] = make_float4(g * yh.x, g * yh.y, g * yh.z, g * yh.w);
        q0[2 * J] = make_float4(fmaf(k2, yh.x, g * zh.x),
                                fmaf(k2, yh.y, g * zh.y),
                                fmaf(k2, yh.z, g * zh.z),
                                fmaf(k2, yh.w, g * zh.w));
      }
    }
    __syncthreads();
    // (b) the couplings of pass r, this slice's part of dx_i = sum_j c_ij
    //     e_j + ..., and, but in pass 0 (whose logits are constant), c_ij,
    //     c_ij dc_ij + db_ij of the pass after, and this slice's part of
    //     rho_i = sum_j c_ij dc_ij, dc_ij = x_i . e_j
    float* xw = xch + (xp & 1) * 2 * I;
    for (int i = warp; i < I; i += kRouteWarps) {
      float xi[kL];
      load8(xs + i * kL, xi);
      const float mi = mx[r * I + i], zi = zinv[r * I + i];
      float* row = cb + (size_t)i * ldp;
      float* drow = db + (size_t)i * ldp;
      float part = 0.f, de[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) de[l] = 0.f;
#pragma unroll(kRowUnroll)
      for (int j = lane; j < nj; j += 32) {
        float aj[kL], ej[kL];
        ld_row(sar, njm, j, aj);
        ld_row(es, njm, j, ej);
        const float c = expf(dot8(xi, aj) - mi) * zi;
#pragma unroll
        for (int l = 0; l < kL; ++l) de[l] = fmaf(c, ej[l], de[l]);
        if (r > 0) {
          const float cdc = c * dot8(xi, ej);
          part += cdc;
          row[j] = c;
          drow[j] = cdc + (r < R - 1 ? drow[j] : 0.f);
        }
      }
      const float d = warp_sum8(de, lane);
      if (lane < kL) dxs[i * kL + lane] += d;
      if (r > 0) {
        part = warp_sum(part);
        if (lane == 0) xw[i] = part;
      }
    }
    if (r == 0) break;
    ++xp;
    cluster.sync();
    // (c) rho summed over the cluster in rank order; db_ij = c_ij dc_ij +
    //     db_ij (next) - c_ij rho_i; this slice's part of sum_j db_ij t_j,
    //     t_j = W_j^T v_j(prev) = a_r - a_(r-1)
    for (int i = warp; i < I; i += kRouteWarps) {
      const float pq = remote_row(cluster, xw, 0, i, lane, C);
      float rho = 0.f;
      for (int q = 0; q < C; ++q) rho += __shfl_sync(~0u, pq, q);
      const float* row = cb + (size_t)i * ldp;
      float* drow = db + (size_t)i * ldp;
      float dt[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) dt[l] = 0.f;
#pragma unroll(kRowUnroll)
      for (int j = lane; j < nj; j += 32) {
        const float d = fmaf(-row[j], rho, drow[j]);
        drow[j] = d;
        float a1[kL], a0[kL];
        ld_row(sar, njm, j, a1);
        ld_row(sar - (size_t)kL * njm, njm, j, a0);
#pragma unroll
        for (int l = 0; l < kL; ++l) dt[l] = fmaf(d, a1[l] - a0[l], dt[l]);
      }
      const float d = warp_sum8(dt, lane);
      if (lane < kL) dxs[i * kL + lane] += d;
    }
    __syncthreads();
  }

  // dx_i = the slices' parts summed in rank order; rank q writes the input
  // capsules [q I / C, (q + 1) I / C)
  cluster.sync();
  if (dx) {
    const int k1 = (rank + 1) * I / C * kL;
    for (int k = rank * I / C * kL + tid; k < k1; k += kRouteThreads) {
      float s = 0.f;
      for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(dxs, q)[k];
      dx[(size_t)b * I * kL + k] = s;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// dW[j, o, l] = sum_k fp[k, j, o] fq[k, j, l] over the B 2R factor pairs k:
// one block per output capsule, one thread per (o, l); two partial sums
// (even and odd k) keep more loads in flight.
__global__ void dw_factored_kernel(const float* __restrict__ fp,
                                   const float* __restrict__ fq,
                                   float* __restrict__ dw, int BK, int J,
                                   int O) {
  const int j = blockIdx.x;
  const int o = threadIdx.x / kL;
  const int l = threadIdx.x % kL;
  float acc[2] = {0.f, 0.f};
#pragma unroll 4
  for (int k = 0; k < BK; ++k)
    acc[k & 1] = fmaf(__ldg(fp + ((size_t)k * J + j) * O + o),
                      __ldg(fq + ((size_t)k * J + j) * kL + l), acc[k & 1]);
  dw[((size_t)j * O + o) * kL + l] = acc[0] + acc[1];
}

template <int O>
cudaError_t launch_factored(const float* x, const float* w, const float* dout,
                            float* dx, float* dw, float* wt, float* scratch,
                            float* fp, float* fq, int B, int I, int J, int R,
                            int C, bool keep, cudaStream_t stream) {
  const FactoredLayout f = factored_layout(I, J, R, C);
  cudaError_t e = launch_w_planes(w, wt, J, O, stream);
  if (e != cudaSuccess) return e;
  e = launch_cluster(routing_bwd_factored_cluster_kernel<O>, B, C,
                     sizeof(float) * (f.small + (keep ? f.big : 0)), stream,
                     x, (const float4*)wt, dout, dx, scratch,
                     dw ? fp : nullptr, dw ? fq : nullptr, I, J, R,
                     (int)keep);
  if (e != cudaSuccess || !dw) return e;
  dw_factored_kernel<<<J, O * kL, 0, stream>>>(
      fp, fq, dw, B * 2 * R, J, O);
  return cudaGetLastError();
}

// ---- (2) materialised votes -----------------------------------------------

// Shared memory of one block of K2-D's routing, in floats: the sample's
// vote slice u [I][njm][O] (only where it fits, `keep`) | stashes of every
// pass: c [R][I][njm] | db [R][I][njm] | s [R][njm][O] | ds [R][njm][O] |
// v [R][njm][O] | logits, then dc [I][njm] | dv [njm][O] | exchange rows
// [2][2 I]; njm = ceil(J / C).
__host__ __device__ inline size_t cluster_smem_floats(int I, int J, int O,
                                                      int R, int C,
                                                      bool keep) {
  const size_t nj = (size_t)(J + C - 1) / C;
  return (keep ? (size_t)I * nj * O : 0) + 2 * (size_t)R * I * nj +
         3 * (size_t)R * nj * O + (size_t)I * nj + nj * O + 4 * (size_t)I;
}

template <int O>
__global__ void __launch_bounds__(kRouteThreads)
routing_bwd_cluster_kernel(const float* __restrict__ u,
                           const float* __restrict__ dout,
                           float* __restrict__ du, int I, int J, int R,
                           int keep) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int njm = (J + C - 1) / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  float* cst = us + (keep ? (size_t)I * njm * O : 0);
  float* dbst = cst + (size_t)R * I * njm;
  float* sst = dbst + (size_t)R * I * njm;
  float* dsst = sst + (size_t)R * njm * O;
  float* vst = dsst + (size_t)R * njm * O;
  float* bl = vst + (size_t)R * njm * O;
  float* dvs = bl + (size_t)I * njm;
  float* xch = dvs + (size_t)njm * O;

  const VoteSlice sl = vote_slice<O>(C, (int)cluster.block_rank(), u, us, bl,
                                     xch, I, J, keep != 0);
  const int b = sl.b, j0 = sl.j0, nj = sl.nj;
  const float* ub = sl.u;
  const size_t ldu = sl.ldu;
  const int JO = nj * O;
  const int JO32 = (JO + 31) & ~31;
  int xp = 0;  // exchanges so far: rows alternate between two buffers
  // ---- forward recompute, stashing c, s and v of every pass
  route_forward<O, true>(cluster, sl, bl, cst, sst, vst, xch, xp, nullptr, I,
                         C, R);

  for (int t = tid; t < JO; t += kRouteThreads)
    dvs[t] = dout[((size_t)b * J + j0) * O + t];
  __syncthreads();
  // ---- reverse
  for (int r = R - 1; r >= 0; --r) {
    const float* cs = cst + (size_t)r * I * njm;
    const float* ss = sst + (size_t)r * njm * O;
    float* dss = dsst + (size_t)r * njm * O;
    float* dbs = dbst + (size_t)r * I * njm;
    // ds through the squash
    for (int t = tid; t < JO32; t += kRouteThreads) {
      const bool valid = t < JO;
      const float s = valid ? ss[t] : 0.f;
      const float dv = valid ? dvs[t] : 0.f;
      float n2 = s * s, dots = dv * s;
#pragma unroll
      for (int off = O / 2; off > 0; off >>= 1) {
        n2 += __shfl_xor_sync(0xffffffffu, n2, off);
        dots += __shfl_xor_sync(0xffffffffu, dots, off);
      }
      float g, gp;
      squash_grad(n2, g, gp);
      if (valid) dss[t] = dv * g + s * (2.f * dots * gp);
    }
    __syncthreads();
    // dc_ij = sum_o ds_jo u_ijo, and this slice's part of
    // rho_i = sum_j c_ij dc_ij
    float* xw = xch + (xp++ & 1) * 2 * I;
    for (int i = warp; i < I; i += kRouteWarps) {
      float part = 0.f;
      for (int j = lane; j < nj; j += 32) {
        const float* up = ub + i * ldu + (size_t)j * O;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < O; ++q) {
          const int o = (q + j) & (O - 1);
          acc = fmaf(up[o], dss[j * O + o], acc);
        }
        bl[i * nj + j] = acc;
        part = fmaf(cs[i * nj + j], acc, part);
      }
      part = warp_sum(part);
      if (lane == 0) xw[i] = part;
    }
    cluster.sync();
    // softmax backward: db = c (dc - rho) + db of the next pass, rho summed
    // over the cluster in rank order
    for (int i = warp; i < I; i += kRouteWarps) {
      const float pq = remote_row(cluster, xw, 0, i, lane, C);
      float rho = 0.f;
      for (int q = 0; q < C; ++q) rho += __shfl_sync(~0u, pq, q);
      for (int j = lane; j < nj; j += 32) {
        const int p = i * nj + j;
        const float next =
            r < R - 1 ? dbst[(size_t)(r + 1) * I * njm + p] : 0.f;
        dbs[p] = cs[p] * (bl[p] - rho) + next;
      }
    }
    __syncthreads();
    // dv of the previous pass: sum_i db_ij u_ij
    if (r > 0) {
      for (int t = tid; t < JO; t += kRouteThreads) {
        const int jl = t / O;
        float acc = 0.f;
        for (int i = 0; i < I; ++i)
          acc = fmaf(dbs[i * nj + jl], ub[i * ldu + t], acc);
        dvs[t] = acc;
      }
      __syncthreads();
    }
  }

  // du = sum_r c_r ds_r + sum_{r > 0} db_r v_{r-1}, from the stashes: a
  // thread takes one (j, o) and walks the input capsules, so that the
  // writes of a warp are contiguous
  for (int t = tid; t < JO; t += kRouteThreads) {
    const int jl = t / O;
    for (int i = 0; i < I; ++i) {
      const int p = i * nj + jl;
      float val = 0.f;
      for (int r = 0; r < R; ++r) {
        val = fmaf(cst[(size_t)r * I * njm + p],
                   dsst[(size_t)r * njm * O + t], val);
        if (r > 0)
          val = fmaf(dbst[(size_t)r * I * njm + p],
                     vst[(size_t)(r - 1) * njm * O + t], val);
      }
      du[((size_t)b * I + i) * J * O + (size_t)j0 * O + t] = val;
    }
  }
  // no block leaves while another may still read its exchange rows
  cluster.sync();
}

template <int O>
cudaError_t launch_votes(const float* u, const float* dout, float* du, int B,
                         int I, int J, int R, int C, bool keep,
                         cudaStream_t stream) {
  return launch_cluster(routing_bwd_cluster_kernel<O>, B, C,
                        sizeof(float) *
                            cluster_smem_floats(I, J, O, R, C, keep),
                        stream, u, dout, du, I, J, R, (int)keep);
}

}  // namespace

extern "C" {

size_t capsule_routing_bwd_smem_bytes(int I, int J, int R, int cluster,
                                      int keep) {
  const FactoredLayout f = factored_layout(I, J, R, cluster);
  return sizeof(float) * (f.small + (keep ? f.big : 0));
}

// How many clusters of `cluster` blocks of the factored backward the card
// can hold at once (cudaOccupancyMaxActiveClusters; 0 where it cannot say):
// the plan keeps every sample's cluster in one wave.
int capsule_routing_bwd_max_clusters(int I, int J, int O, int R, int cluster,
                                     int keep, int device) {
  if (begin_call(device) != cudaSuccess) return 0;
  const FactoredLayout f = factored_layout(I, J, R, cluster);
  const size_t smem = sizeof(float) * (f.small + (keep ? f.big : 0));
  switch (O) {
    case 16:
      return max_active_clusters(routing_bwd_factored_cluster_kernel<16>,
                                 cluster, smem);
    case 32:
      return max_active_clusters(routing_bwd_factored_cluster_kernel<32>,
                                 cluster, smem);
    default: return 0;
  }
}

// floats of scratch one block needs where its stashes, c and db do not
// stay in shared memory
size_t capsule_routing_bwd_scratch_floats(int I, int J, int R, int cluster) {
  return factored_layout(I, J, R, cluster).big;
}

// Factored backward, in_length 8. x [B, I, 8], w [J, O, 8], dout [B, J, O];
// dx [B, I, 8] or null; dw [J, O, 8] or null (then fp and fq may be null);
// wt [J O 8] a scratch for W's planes; the routing on clusters of `cluster`
// blocks (1..8, at most J) per sample, each block's stashes, couplings and
// logit gradient in shared memory where `keep` is set, else in scratch
// [B * cluster * capsule_routing_bwd_scratch_floats]; fp [B, 2R, J, O] and
// fq [B, 2R, J, 8] hold the dW factors (ops/capsule_cuda.py::
// factored_bwd_plan chooses the cluster and keep). All float32, contiguous,
// 16-byte aligned, on `device`. Returns the CUDA error code (0 = success);
// a cluster launch that the card refuses returns its error, and nothing
// falls back to another form.
int capsule_routing_bwd(const void* x, const void* w, const void* dout,
                        void* dx, void* dw, void* wt, void* scratch, void* fp,
                        void* fq, int B, int I, int J, int O, int iters,
                        int cluster, int keep, int device, void* stream) {
  if (B <= 0 || I <= 0 || J <= 0 || iters <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > J || !wt || (!keep && !scratch) ||
      (dw && (!fp || !fq)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = begin_call(device);
  if (e != cudaSuccess) return (int)e;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* df = static_cast<const float*>(dout);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  float* tf = static_cast<float*>(wt);
  float* sf = static_cast<float*>(scratch);
  float* pf = static_cast<float*>(fp);
  float* qf = static_cast<float*>(fq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 16:
      e = launch_factored<16>(xf, wf, df, dxf, dwf, tf, sf, pf, qf, B, I, J,
                              iters, cluster, keep != 0, st);
      break;
    case 32:
      e = launch_factored<32>(xf, wf, df, dxf, dwf, tf, sf, pf, qf, B, I, J,
                              iters, cluster, keep != 0, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

size_t capsule_routing_votes_bwd_smem_bytes(int I, int J, int O, int R,
                                            int cluster, int keep_votes) {
  return sizeof(float) *
         cluster_smem_floats(I, J, O, R, cluster, keep_votes != 0);
}

// Materialised-votes backward, any in_length L. x [B, I, L], w [J, O, L],
// dout [B, J, O]; votes and dvotes are scratch [B, I, J, O]; dx [B, I, L]
// or null; dw [J, O, L] or null; partial [dx_splits, B * I, L] is dx's
// split-K scratch where dx_splits > 1: runs of dx_chunk (a multiple of 32)
// of its K = J O. The routing runs on clusters of
// `cluster` blocks (1..8, at most J) per sample, with each block's vote
// slice in shared memory where keep_votes is set
// (ops/capsule_cuda.py::votes_bwd_plan chooses all of these). Returns the
// CUDA error code; a cluster launch that the card refuses returns its
// error, and nothing falls back to another form.
int capsule_routing_votes_bwd(const void* x, const void* w, const void* dout,
                              void* dx, void* dw, void* votes, void* dvotes,
                              void* partial, int B, int I, int L, int J,
                              int O, int iters, int cluster, int keep_votes,
                              int dx_splits, int dx_chunk, int device,
                              void* stream) {
  if (B <= 0 || I <= 0 || L <= 0 || J <= 0 || iters <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > J || dx_splits < 1 ||
      (dx && dx_splits > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = begin_call(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* u = static_cast<float*>(votes);
  float* du = static_cast<float*>(dvotes);
  const int JO = J * O, BI = B * I;
  const int kb = gemm_tf32x3::kBK;
  // u [B*I, J*O] = x [B*I, L] . w [J*O, L]^T (both K-major)
  e = gemm_tf32x3::gemm(xf, true, L, wf, true, L, u, JO, BI, JO, L, 1,
                        (L + kb - 1) / kb * kb, nullptr, st);
  if (e != cudaSuccess) return (int)e;
  switch (O) {
    case 16:
      e = launch_votes<16>(u, static_cast<const float*>(dout), du, B, I, J,
                           iters, cluster, keep_votes != 0, st);
      break;
    case 32:
      e = launch_votes<32>(u, static_cast<const float*>(dout), du, B, I, J,
                           iters, cluster, keep_votes != 0, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (dx) {
    // dx [B*I, L] = du [B*I, J*O] . w [J*O, L] (w read N-major), K split
    e = gemm_tf32x3::gemm(du, true, JO, wf, false, L, static_cast<float*>(dx),
                          L, BI, L, JO, dx_splits, dx_chunk,
                          static_cast<float*>(partial), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (dw) {
    // dw [J*O, L] = du^T [J*O, B*I] . x [B*I, L] (du read M-major, x
    // N-major): the batch sum is the contraction
    e = gemm_tf32x3::gemm(du, false, JO, xf, false, L,
                          static_cast<float*>(dw), L, JO, L, BI, 1,
                          (BI + kb - 1) / kb * kb, nullptr, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)e;
}

}  // extern "C"
