// Capsule dynamic-routing backward (K2) for Hopper, sm_90a.
//
// Replaces text2img_ekl_tpu/ops/capsule_pallas.py::_bwd_kernel (via
// _backward): recompute the forward, stashing the couplings c, the
// pre-squash outputs s and the outputs v of every pass, then reverse
// squash, the agreement update and the softmax, and pull the vote
// gradient du back through u = W x:
//   dx[b, i] = sum_{j,o} du[b, i, j, o] W[j, o, :]        (per sample)
//   dW[j, o] = sum_{b,i} du[b, i, j, o] x[b, i, :]        (over the batch)
// The JAX package sends the discriminator head to XLA autodiff instead (a
// TPU measurement); here both heads run a kernel.
//
// The TPU sums dW over the batch in a sequential grid. On Hopper the
// samples run in parallel blocks, so dW is a second pass in both forms
// below, with no atomics: the result does not depend on the schedule.
//
// (1) Factored form, in_length 8 (the generator head: 48 capsules of 8 ->
//     1024 of 32). The votes of one sample are 6.3 MB, so, as in K1, they
//     never exist. Every du term is rank one, c_ij ds_j or db_ij v_j, so
//       dc_ij = x_i . e_j,  e_j = W_j^T ds_j
//       dx_i += sum_j c_ij e_j + sum_j db_ij t_j,  t_j = W_j^T v_j(prev)
//       dW_j += ds_j (x) y_j + v_j(prev) (x) z_j,  z_j = sum_i db_ij x_i
//       dv_j(prev) = W_j z_j
//     and every per-j quantity is 8 floats. One 512-thread block handles a
//     sample: x, the current a_j, e_j, t_j, z_j (8 floats per output
//     capsule) and the per-warp dx partials sit in shared memory (161 KB
//     at the flagship head); the per-pass a_j and y_j, the logit gradient
//     db_ij (I x J) and dv_j live in a per-sample scratch that stays in
//     L2. The block writes its dW factors (ds_j, y_j) and (v_j, z_j) per
//     pass; a second kernel sums dW_j = sum over samples and passes of
//     their outer products, one block per output capsule. What bounds it:
//     the per-(i, j) exponentials and 8-wide dots, about 30 per pair per
//     pass, and the L2 traffic of the db scratch.
// (2) Materialised votes, in_length > 8 (the discriminator class head:
//     16 x 512 -> 201 x 16, 206 KB of votes per sample). The vote product
//     is recomputed by the tiled float32 product of gemm_f32.cuh into a
//     scratch; one block per sample reverses the routing with the stash
//     (c and s of every pass) and the working rows in shared memory
//     (141 KB at that head) and writes du; then two more products give
//     dx = du . W and dW = du^T . x, whose contraction over the batch
//     is the sum. What bounds it: the three float32 products (5 GFLOP at
//     a batch of 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm_f32.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 8;

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

__device__ __forceinline__ void store8(float* p, const float (&r)[kL]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
}

__device__ __forceinline__ float dot8(const float (&a)[kL],
                                      const float (&b)[kL]) {
  float s = 0.f;
#pragma unroll
  for (int l = 0; l < kL; ++l) s = fmaf(a[l], b[l], s);
  return s;
}

// |W_j y|^2 for a row-major W_j [O][8]
template <int O>
__device__ __forceinline__ float sq_norm(const float* wj, const float (&y)[kL]) {
  float n2 = 0.f;
  for (int o = 0; o < O; ++o) {
    float wo[kL];
    load8(wj + o * kL, wo);
    const float so = dot8(wo, y);
    n2 = fmaf(so, so, n2);
  }
  return n2;
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

// Block-wide reduction of one value per input capsule: each warp's lane 0
// wrote red[warp * I + i]; thread i < I combines them into dst[i].
__device__ __forceinline__ void combine_max(const float* red, float* dst,
                                            int I, int tid) {
  if (tid < I) {
    float m = red[tid];
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k * I + tid]);
    dst[tid] = m;
  }
}

__device__ __forceinline__ void combine_sum(const float* red, float* dst,
                                            int I, int tid, bool invert) {
  if (tid < I) {
    float z = 0.f;
    for (int k = 0; k < kWarps; ++k) z += red[k * I + tid];
    dst[tid] = invert ? 1.f / z : z;
  }
}

// ---- (1) factored form ----------------------------------------------------

// Shared memory: x [I][8] | a [J][8] | e [J][8] | t [J][8] | z [J][8] |
// dx partials [kWarps][I][8] | reduction rows [kWarps][I] | max [R][I] |
// 1/sum [R][I] | rho [I].
__host__ __device__ inline size_t factored_smem_bytes(int I, int J, int R) {
  return sizeof(float) *
         ((size_t)I * kL + 4 * (size_t)J * kL + (size_t)kWarps * I * kL +
          (size_t)kWarps * I + 2 * (size_t)R * I + (size_t)I);
}

// Per-sample scratch, in floats: a [R][J][8] | y [R][J][8] | dv [J][O] |
// db [I][J]
// (rounded up to whole float4, so that every sample's rows stay aligned)
__host__ __device__ inline size_t factored_scratch_floats(int I, int J, int O,
                                                          int R) {
  return (2 * (size_t)R * J * kL + (size_t)J * O + (size_t)I * J + 3) &
         ~(size_t)3;
}

template <int O>
__global__ void __launch_bounds__(kThreads)
routing_bwd_factored_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ dout,
                            float* __restrict__ dx, float* __restrict__ scratch,
                            float* __restrict__ fp, float* __restrict__ fq,
                            int I, int J, int R) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* as = xs + (size_t)I * kL;
  float* es = as + (size_t)J * kL;
  float* ts = es + (size_t)J * kL;
  float* zs = ts + (size_t)J * kL;
  float* dxp = zs + (size_t)J * kL;
  float* red = dxp + (size_t)kWarps * I * kL;
  float* mx = red + (size_t)kWarps * I;
  float* zinv = mx + (size_t)R * I;
  float* rho = zinv + (size_t)R * I;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = 2 * R - 1;  // dW factor pairs per sample

  float* sa = scratch + (size_t)b * factored_scratch_floats(I, J, O, R);
  float* sy = sa + (size_t)R * J * kL;
  float* sdv = sy + (size_t)R * J * kL;
  float* sdb = sdv + (size_t)J * O;

  const float* xb = x + (size_t)b * I * kL;
  for (int k = tid; k < I * kL; k += kThreads) xs[k] = xb[k];
  for (int k = tid; k < J * kL; k += kThreads) as[k] = 0.f;
  for (int k = tid; k < kWarps * I * kL; k += kThreads) dxp[k] = 0.f;
  __syncthreads();

  // ---- forward recompute (K1's passes), keeping a_r, y_r, max_r, 1/Z_r
  for (int r = 0; r < R; ++r) {
    for (int i = 0; i < I; ++i) {
      float xi[kL];
      load8(xs + i * kL, xi);
      float m = -INFINITY;
      for (int j = tid; j < J; j += kThreads) {
        float aj[kL];
        load8(as + (size_t)j * kL, aj);
        m = fmaxf(m, dot8(xi, aj));
      }
      m = warp_max(m);
      if (lane == 0) red[warp * I + i] = m;
    }
    __syncthreads();
    combine_max(red, mx + r * I, I, tid);
    __syncthreads();
    for (int i = 0; i < I; ++i) {
      float xi[kL];
      load8(xs + i * kL, xi);
      const float mi = mx[r * I + i];
      float z = 0.f;
      for (int j = tid; j < J; j += kThreads) {
        float aj[kL];
        load8(as + (size_t)j * kL, aj);
        z += expf(dot8(xi, aj) - mi);
      }
      z = warp_sum(z);
      if (lane == 0) red[warp * I + i] = z;
    }
    __syncthreads();
    combine_sum(red, zinv + r * I, I, tid, true);
    __syncthreads();
    for (int j = tid; j < J; j += kThreads) {
      float aj[kL];
      load8(as + (size_t)j * kL, aj);
      store8(sa + ((size_t)r * J + j) * kL, aj);
      float y[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) y[l] = 0.f;
      for (int i = 0; i < I; ++i) {
        float xi[kL];
        load8(xs + i * kL, xi);
        const float c = expf(dot8(xi, aj) - mx[r * I + i]) * zinv[r * I + i];
#pragma unroll
        for (int l = 0; l < kL; ++l) y[l] = fmaf(c, xi[l], y[l]);
      }
      store8(sy + ((size_t)r * J + j) * kL, y);
      if (r < R - 1) {
        // a_j += W_j^T v_j; s_j is recomputed rather than kept, which
        // keeps the thread's registers to a few rows of 8
        const float* wj = w + (size_t)j * O * kL;
        const float g = squash_scale(sq_norm<O>(wj, y));
        for (int o = 0; o < O; ++o) {
          float wo[kL];
          load8(wj + o * kL, wo);
          const float vo = g * dot8(wo, y);
#pragma unroll
          for (int l = 0; l < kL; ++l) aj[l] = fmaf(vo, wo[l], aj[l]);
        }
        store8(as + (size_t)j * kL, aj);
      }
    }
    __syncthreads();
  }

  // ---- reverse
  for (int r = R - 1; r >= 0; --r) {
    // (a) per output capsule: ds_j, e_j = W_j^T ds_j, a_r and t_j
    for (int j = tid; j < J; j += kThreads) {
      const float* wj = w + (size_t)j * O * kL;
      float y[kL], aj[kL];
      load8(sy + ((size_t)r * J + j) * kL, y);
      load8(sa + ((size_t)r * J + j) * kL, aj);
      store8(as + (size_t)j * kL, aj);
      if (r > 0) {
        float ap[kL];
        load8(sa + ((size_t)(r - 1) * J + j) * kL, ap);
#pragma unroll
        for (int l = 0; l < kL; ++l) ap[l] = aj[l] - ap[l];
        store8(ts + (size_t)j * kL, ap);
      }
      const float* dvj = (r == R - 1) ? dout + ((size_t)b * J + j) * O
                                      : sdv + (size_t)j * O;
      float n2 = 0.f, dots = 0.f;
      for (int o = 0; o < O; ++o) {
        float wo[kL];
        load8(wj + o * kL, wo);
        const float so = dot8(wo, y);
        n2 = fmaf(so, so, n2);
        dots = fmaf(dvj[o], so, dots);
      }
      float g, gp;
      squash_grad(n2, g, gp);
      float e[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) e[l] = 0.f;
      float* pj = fp ? fp + (((size_t)b * K + 2 * r) * J + j) * O : nullptr;
      for (int o = 0; o < O; ++o) {
        float wo[kL];
        load8(wj + o * kL, wo);
        const float ds = dvj[o] * g + dot8(wo, y) * (2.f * dots * gp);
        if (pj) pj[o] = ds;
#pragma unroll
        for (int l = 0; l < kL; ++l) e[l] = fmaf(ds, wo[l], e[l]);
      }
      store8(es + (size_t)j * kL, e);
      if (fq) store8(fq + (((size_t)b * K + 2 * r) * J + j) * kL, y);
      float zero[kL] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      store8(zs + (size_t)j * kL, zero);
    }
    __syncthreads();

    // (b) rho_i = sum_j c_ij dc_ij
    for (int i = 0; i < I; ++i) {
      float xi[kL];
      load8(xs + i * kL, xi);
      const float mi = mx[r * I + i], zi = zinv[r * I + i];
      float acc = 0.f;
      for (int j = tid; j < J; j += kThreads) {
        float aj[kL], ej[kL];
        load8(as + (size_t)j * kL, aj);
        load8(es + (size_t)j * kL, ej);
        acc = fmaf(expf(dot8(xi, aj) - mi) * zi, dot8(xi, ej), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) red[warp * I + i] = acc;
    }
    __syncthreads();
    combine_sum(red, rho, I, tid, false);
    __syncthreads();

    // (c) db_ij, the dx terms, z_j = sum_i db_ij x_i
    for (int i = 0; i < I; ++i) {
      float xi[kL];
      load8(xs + i * kL, xi);
      const float mi = mx[r * I + i], zi = zinv[r * I + i], ri = rho[i];
      float part[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) part[l] = 0.f;
      for (int j = tid; j < J; j += kThreads) {
        float aj[kL], ej[kL];
        load8(as + (size_t)j * kL, aj);
        load8(es + (size_t)j * kL, ej);
        const float c = expf(dot8(xi, aj) - mi) * zi;
        float* dbp = sdb + (size_t)i * J + j;
        const float db = c * (dot8(xi, ej) - ri) + (r < R - 1 ? *dbp : 0.f);
#pragma unroll
        for (int l = 0; l < kL; ++l) part[l] = fmaf(c, ej[l], part[l]);
        if (r > 0) {
          *dbp = db;
          float tj[kL], zj[kL];
          load8(ts + (size_t)j * kL, tj);
          load8(zs + (size_t)j * kL, zj);
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            part[l] = fmaf(db, tj[l], part[l]);
            zj[l] = fmaf(db, xi[l], zj[l]);
          }
          store8(zs + (size_t)j * kL, zj);
        }
      }
#pragma unroll
      for (int l = 0; l < kL; ++l) part[l] = warp_sum(part[l]);
      if (lane == 0) {
        float* d = dxp + ((size_t)warp * I + i) * kL;
#pragma unroll
        for (int l = 0; l < kL; ++l) d[l] += part[l];
      }
    }
    __syncthreads();

    // (d) dv of the previous pass, and its dW factors (v_prev, z)
    if (r > 0) {
      for (int j = tid; j < J; j += kThreads) {
        const float* wj = w + (size_t)j * O * kL;
        float zj[kL], yp[kL];
        load8(zs + (size_t)j * kL, zj);
        load8(sy + ((size_t)(r - 1) * J + j) * kL, yp);
        for (int o = 0; o < O; ++o) {
          float wo[kL];
          load8(wj + o * kL, wo);
          sdv[(size_t)j * O + o] = dot8(wo, zj);
        }
        if (fp) {
          const float g = squash_scale(sq_norm<O>(wj, yp));
          float* pj = fp + (((size_t)b * K + 2 * r - 1) * J + j) * O;
          for (int o = 0; o < O; ++o) {
            float wo[kL];
            load8(wj + o * kL, wo);
            pj[o] = g * dot8(wo, yp);
          }
          store8(fq + (((size_t)b * K + 2 * r - 1) * J + j) * kL, zj);
        }
      }
      __syncthreads();
    }
  }

  if (dx) {
    for (int k = tid; k < I * kL; k += kThreads) {
      float s = 0.f;
      for (int q = 0; q < kWarps; ++q) s += dxp[(size_t)q * I * kL + k];
      dx[(size_t)b * I * kL + k] = s;
    }
  }
}

// dW[j, o, l] = sum_{b, k} fp[b, k, j, o] fq[b, k, j, l]: one block per
// output capsule, one thread per (o, l).
__global__ void dw_factored_kernel(const float* __restrict__ fp,
                                   const float* __restrict__ fq,
                                   float* __restrict__ dw, int BK, int J,
                                   int O) {
  const int j = blockIdx.x;
  const int o = threadIdx.x / kL;
  const int l = threadIdx.x % kL;
  float acc = 0.f;
  for (int k = 0; k < BK; ++k)
    acc = fmaf(fp[((size_t)k * J + j) * O + o], fq[((size_t)k * J + j) * kL + l],
               acc);
  dw[((size_t)j * O + o) * kL + l] = acc;
}

template <int O>
cudaError_t launch_factored(const float* x, const float* w, const float* dout,
                            float* dx, float* dw, float* scratch, float* fp,
                            float* fq, int B, int I, int J, int R,
                            cudaStream_t stream) {
  const size_t smem = factored_smem_bytes(I, J, R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        routing_bwd_factored_kernel<O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  routing_bwd_factored_kernel<O><<<B, kThreads, smem, stream>>>(
      x, w, dout, dx, scratch, dw ? fp : nullptr, dw ? fq : nullptr, I, J, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !dw) return e;
  dw_factored_kernel<<<J, O * kL, 0, stream>>>(fp, fq, dw, B * (2 * R - 1), J,
                                              O);
  return cudaGetLastError();
}

// ---- (2) materialised votes -----------------------------------------------

// Shared memory: stash c [R][I*J] | stash s [R][J*O] | logits, then dc
// [I*J] | db [I*J] | ds [J*O] | dv [J*O] | v_prev [J*O].
__host__ __device__ inline size_t votes_smem_bytes(int I, int J, int O, int R) {
  return sizeof(float) * ((size_t)R * I * J + (size_t)R * J * O +
                          2 * (size_t)I * J + 3 * (size_t)J * O);
}

template <int O>
__global__ void __launch_bounds__(kThreads)
routing_bwd_votes_kernel(const float* __restrict__ u,
                         const float* __restrict__ dout,
                         float* __restrict__ du, int I, int J, int R) {
  extern __shared__ float4 smem4[];
  const int IJ = I * J;
  const int JO = J * O;
  const int JO32 = (JO + 31) & ~31;
  float* cst = reinterpret_cast<float*>(smem4);
  float* sst = cst + (size_t)R * IJ;
  float* bl = sst + (size_t)R * JO;  // logits in the forward, dc after
  float* dbs = bl + IJ;
  float* dss = dbs + IJ;
  float* dvs = dss + JO;
  float* vps = dvs + JO;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ub = u + (size_t)b * IJ * O;
  float* dub = du + (size_t)b * IJ * O;

  for (int p = tid; p < IJ; p += kThreads) bl[p] = 0.f;
  __syncthreads();
  // ---- forward recompute, stashing c and s of every pass
  for (int r = 0; r < R; ++r) {
    float* cs = cst + (size_t)r * IJ;
    for (int i = warp; i < I; i += kWarps) {
      const float* row = bl + (size_t)i * J;
      float m = -INFINITY;
      for (int j = lane; j < J; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float z = 0.f;
      for (int j = lane; j < J; j += 32) z += expf(row[j] - m);
      const float zi = 1.f / warp_sum(z);
      for (int j = lane; j < J; j += 32)
        cs[(size_t)i * J + j] = expf(row[j] - m) * zi;
    }
    __syncthreads();
    float* ss = sst + (size_t)r * JO;
    for (int t = tid; t < JO32; t += kThreads) {
      const bool valid = t < JO;
      const int j = t / O;
      float s = 0.f;
      if (valid)
        for (int i = 0; i < I; ++i)
          s = fmaf(cs[(size_t)i * J + j], ub[(size_t)i * JO + t], s);
      float n2 = s * s;
#pragma unroll
      for (int off = O / 2; off > 0; off >>= 1)
        n2 += __shfl_xor_sync(0xffffffffu, n2, off);
      if (valid) {
        ss[t] = s;
        vps[t] = s * (n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f));
      }
    }
    __syncthreads();
    if (r < R - 1) {
      for (int p = tid; p < IJ; p += kThreads) {
        const int j = p % J;
        float acc = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o)
          acc = fmaf(ub[(size_t)p * O + o], vps[(size_t)j * O + o], acc);
        bl[p] += acc;
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < JO; t += kThreads) dvs[t] = dout[(size_t)b * JO + t];
  __syncthreads();
  // ---- reverse
  for (int r = R - 1; r >= 0; --r) {
    const float* cs = cst + (size_t)r * IJ;
    const float* ss = sst + (size_t)r * JO;
    // ds, and v of the previous pass
    for (int t = tid; t < JO32; t += kThreads) {
      const bool valid = t < JO;
      const float s = valid ? ss[t] : 0.f;
      const float dv = valid ? dvs[t] : 0.f;
      const float sp = (valid && r > 0) ? sst[(size_t)(r - 1) * JO + t] : 0.f;
      float n2 = s * s, dots = dv * s, n2p = sp * sp;
#pragma unroll
      for (int off = O / 2; off > 0; off >>= 1) {
        n2 += __shfl_xor_sync(0xffffffffu, n2, off);
        dots += __shfl_xor_sync(0xffffffffu, dots, off);
        n2p += __shfl_xor_sync(0xffffffffu, n2p, off);
      }
      float g, gp;
      squash_grad(n2, g, gp);
      if (valid) {
        dss[t] = dv * g + s * (2.f * dots * gp);
        if (r > 0) vps[t] = sp * (n2p / (1.f + n2p) * rsqrtf(n2p + 1e-8f));
      }
    }
    __syncthreads();
    // dc_ij = sum_o ds_jo u_ijo
    for (int p = tid; p < IJ; p += kThreads) {
      const int j = p % J;
      float acc = 0.f;
#pragma unroll
      for (int o = 0; o < O; ++o)
        acc = fmaf(ub[(size_t)p * O + o], dss[(size_t)j * O + o], acc);
      bl[p] = acc;
    }
    __syncthreads();
    // softmax backward, one warp per row: db = c (dc - sum_j c dc) + db_next
    for (int i = warp; i < I; i += kWarps) {
      float acc = 0.f;
      for (int j = lane; j < J; j += 32)
        acc = fmaf(cs[(size_t)i * J + j], bl[(size_t)i * J + j], acc);
      const float rho = warp_sum(acc);
      for (int j = lane; j < J; j += 32) {
        const size_t p = (size_t)i * J + j;
        dbs[p] = cs[p] * (bl[p] - rho) + (r < R - 1 ? dbs[p] : 0.f);
      }
    }
    __syncthreads();
    // du += c ds + db v_prev; dv_prev = sum_i db u
    for (int e = tid; e < IJ * O; e += kThreads) {
      const int p = e / O;
      const int t = (p % J) * O + e % O;
      float val = cs[p] * dss[t];
      if (r > 0) val = fmaf(dbs[p], vps[t], val);
      dub[e] = (r == R - 1) ? val : dub[e] + val;
    }
    if (r > 0) {
      for (int t = tid; t < JO; t += kThreads) {
        const int j = t / O;
        float acc = 0.f;
        for (int i = 0; i < I; ++i)
          acc = fmaf(dbs[(size_t)i * J + j], ub[(size_t)i * JO + t], acc);
        dvs[t] = acc;
      }
    }
    __syncthreads();
  }
}

template <int O>
cudaError_t launch_votes(const float* u, const float* dout, float* du, int B,
                         int I, int J, int R, cudaStream_t stream) {
  const size_t smem = votes_smem_bytes(I, J, O, R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        routing_bwd_votes_kernel<O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  routing_bwd_votes_kernel<O><<<B, kThreads, smem, stream>>>(u, dout, du, I,
                                                             J, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t capsule_routing_bwd_smem_bytes(int I, int J, int R) {
  return factored_smem_bytes(I, J, R);
}

size_t capsule_routing_bwd_scratch_floats(int I, int J, int O, int R) {
  return factored_scratch_floats(I, J, O, R);
}

// Factored backward, in_length 8. x [B, I, 8], w [J, O, 8], dout [B, J, O];
// dx [B, I, 8] or null; dw [J, O, 8] or null (then fp and fq may be null);
// scratch [B * capsule_routing_bwd_scratch_floats]; fp [B, 2R-1, J, O] and
// fq [B, 2R-1, J, 8] hold the dW factors. All float32, contiguous, 16-byte
// aligned, on `device`. Returns the CUDA error code (0 = success).
int capsule_routing_bwd(const void* x, const void* w, const void* dout,
                        void* dx, void* dw, void* scratch, void* fp, void* fq,
                        int B, int I, int J, int O, int iters, int device,
                        void* stream) {
  if (B <= 0 || I <= 0 || I > kThreads || J <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* df = static_cast<const float*>(dout);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  float* sf = static_cast<float*>(scratch);
  float* pf = static_cast<float*>(fp);
  float* qf = static_cast<float*>(fq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 16:
      e = launch_factored<16>(xf, wf, df, dxf, dwf, sf, pf, qf, B, I, J, iters,
                              st);
      break;
    case 32:
      e = launch_factored<32>(xf, wf, df, dxf, dwf, sf, pf, qf, B, I, J, iters,
                              st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

size_t capsule_routing_votes_bwd_smem_bytes(int I, int J, int O, int R) {
  return votes_smem_bytes(I, J, O, R);
}

// Materialised-votes backward, any in_length L. x [B, I, L], w [J, O, L],
// dout [B, J, O]; votes and dvotes are scratch [B, I, J, O]; dx [B, I, L]
// or null; dw [J, O, L] or null. Returns the CUDA error code.
int capsule_routing_votes_bwd(const void* x, const void* w, const void* dout,
                              void* dx, void* dw, void* votes, void* dvotes,
                              int B, int I, int L, int J, int O, int iters,
                              int device, void* stream) {
  if (B <= 0 || I <= 0 || L <= 0 || J <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* u = static_cast<float*>(votes);
  float* du = static_cast<float*>(dvotes);
  const long long JO = (long long)J * O;
  // u [B*I, J*O] = x [B*I, L] . w[J*O, L]^T
  e = capsule_gemm::gemm_f32(xf, wf, u, B * I, (int)JO, L, L, 1, 1, L, JO, st);
  if (e != cudaSuccess) return (int)e;
  switch (O) {
    case 16:
      e = launch_votes<16>(u, static_cast<const float*>(dout), du, B, I, J,
                           iters, st);
      break;
    case 32:
      e = launch_votes<32>(u, static_cast<const float*>(dout), du, B, I, J,
                           iters, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (dx) {
    // dx [B*I, L] = du [B*I, J*O] . w [J*O, L]
    e = capsule_gemm::gemm_f32(du, wf, static_cast<float*>(dx), B * I, L,
                               (int)JO, JO, 1, L, 1, L, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (dw) {
    // dw [J*O, L] = du^T [J*O, B*I] . x [B*I, L]: the batch sum is the
    // contraction
    e = capsule_gemm::gemm_f32(du, xf, static_cast<float*>(dw), (int)JO, L,
                               B * I, 1, JO, L, 1, L, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)e;
}

}  // extern "C"
