// Capsule dynamic-routing forward (K1) for Hopper, sm_90a.
//
// Replaces text2img_ekl_tpu/ops/capsule_pallas.py::_routing_kernel (via
// _forward), which builds the whole vote tensor u[o, i, j] in TPU VMEM and
// runs the routing passes over it.
//
// What bounds it here: the flagship generator head routes 48 input
// capsules of length 8 to 1024 output capsules of length 32, so the votes
// of ONE sample are 48 x 1024 x 32 floats = 6.3 MB. That is far beyond the
// 227 KB of shared memory a block can use, and writing the votes to device
// memory (2 GB at a batch of 320) would make the op bound by device-memory
// bytes. The routing arithmetic of the factored form below is small (about
// 3 GFLOP at B=320); what remains is reading W from L2 on every pass.
//
// What the design does about it: the weight is shared over the input
// capsules and linear in x, so every routing quantity factors through the
// input length L = 8 and the vote tensor never exists:
//   s_j  = sum_i c_ij u_ij = W_j y_j,      y_j = sum_i c_ij x_i
//   b_ij = sum_passes u_ij . v_j = x_i . a_j,  a_j = sum_passes W_j^T v_j
// One block routes one sample. It keeps x (I x 8) and a (J x 8) in shared
// memory; a thread owns output capsules j = tid, tid + 512, ... and
// recomputes b_ij = x_i . a_j (8 FMAs) wherever it needs it. The softmax
// over j needs, for each input capsule i, the max and the sum of exp over
// all j: block reductions (warp shuffles, then one pass over the warps'
// partials). The weight (1 MB at the flagship shape) is read once per pass
// per sample and stays resident in the 50 MB L2 across blocks. Output is
// written once. Floats throughout, as the JAX kernel computes in f32.
//
// The discriminator class head (16 input capsules of length 8*ndf = 512,
// 201 output capsules of length 16) takes the second entry point,
// capsule_routing_votes_fwd (K1-D). There the factored form stops paying:
// a_j and y_j would be 512 floats per output capsule, while the votes of a
// sample are only 16 x 201 x 16 floats = 206 KB. So the votes are
// materialised, as the TPU kernel does, in two launches:
// - the vote product u = x . W^T (1.69 GFLOP at a batch of 32) on the
//   tensor cores, float32-faithful (3xTF32 wgmma, gemm_tf32x3.cuh: the
//   product K2-D recomputes first), into a 6.6 MB scratch that stays in L2;
// - the routing on a cluster of C blocks per sample (C from
//   ops/capsule_cuda.py::votes_fwd_plan: 4 at the flagship, 128 blocks on
//   132 SMs), each block owning about J / C output capsules with its vote
//   slice (52 KB at C = 4), couplings, logits and outputs in shared memory.
//   The softmax's (max, sum of exp) per input capsule crosses the cluster
//   through distributed shared memory, combined in rank order: the same
//   bits in every block and in every call. The passes are K2-D's forward
//   recompute without its stashes (capsule_common.cuh::route_forward).
// What bounds it: the product's tensor-core work (5.06 GFLOP of tf32 at
// 3xTF32, 0.010 ms at the TF32 peak) and the routing's latency: one cluster
// barrier and three block barriers a pass over a few thousand elements;
// the routing's arithmetic is small (0.022 GFLOP).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "capsule_common.cuh"

namespace {

using namespace capsule;

constexpr int kThreads = kRouteThreads;
constexpr int kWarps = kRouteWarps;

// Shared memory: x [I][8] | a [J][8] | warp partials [kWarps][I] |
// max [I] | 1/sum [I].
__host__ __device__ inline size_t smem_bytes(int I, int J) {
  return sizeof(float) *
         ((size_t)I * kL + (size_t)J * kL + (size_t)kWarps * I + 2 * (size_t)I);
}

template <int O>
__global__ void __launch_bounds__(kThreads)
routing_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int I, int J, int iters) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* as = xs + (size_t)I * kL;
  float* red = as + (size_t)J * kL;
  float* mx = red + (size_t)kWarps * I;
  float* zinv = mx + I;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* xb = x + (size_t)b * I * kL;
  for (int k = tid; k < I * kL; k += kThreads) xs[k] = xb[k];
  for (int k = tid; k < J * kL; k += kThreads) as[k] = 0.f;
  __syncthreads();

  for (int r = 0; r < iters; ++r) {
    // (1) m_i = max_j b_ij
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
    if (tid < I) {
      float m = red[tid];
      for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k * I + tid]);
      mx[tid] = m;
    }
    __syncthreads();

    // (2) 1 / Z_i with Z_i = sum_j exp(b_ij - m_i)
    for (int i = 0; i < I; ++i) {
      float xi[kL];
      load8(xs + i * kL, xi);
      const float mi = mx[i];
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
    if (tid < I) {
      float z = 0.f;
      for (int k = 0; k < kWarps; ++k) z += red[k * I + tid];
      zinv[tid] = 1.f / z;
    }
    __syncthreads();

    // (3) per output capsule: y_j, s_j = W_j y_j, v_j = squash(s_j), then
    //     a_j += W_j^T v_j, or write v_j after the last pass.
    const bool last = (r == iters - 1);
    for (int j = tid; j < J; j += kThreads) {
      float aj[kL];
      load8(as + (size_t)j * kL, aj);
      float y[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) y[l] = 0.f;
      for (int i = 0; i < I; ++i) {
        float xi[kL];
        load8(xs + i * kL, xi);
        const float c = expf(dot8(xi, aj) - mx[i]) * zinv[i];
#pragma unroll
        for (int l = 0; l < kL; ++l) y[l] = fmaf(c, xi[l], y[l]);
      }
      const float* wj = w + (size_t)j * O * kL;
      float s[O];
      float t[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) t[l] = 0.f;
      float n2 = 0.f;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        float wo[kL];
        load8_global(wj + o * kL, wo);
        const float so = dot8(wo, y);
        s[o] = so;
        n2 = fmaf(so, so, n2);
#pragma unroll
        for (int l = 0; l < kL; ++l) t[l] = fmaf(wo[l], so, t[l]);
      }
      const float scale = n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f);
      if (last) {
        float4* ob = reinterpret_cast<float4*>(out + ((size_t)b * J + j) * O);
#pragma unroll
        for (int q = 0; q < O / 4; ++q)
          ob[q] = make_float4(s[4 * q] * scale, s[4 * q + 1] * scale,
                              s[4 * q + 2] * scale, s[4 * q + 3] * scale);
      } else {
        float* ap = as + (size_t)j * kL;
#pragma unroll
        for (int l = 0; l < kL; ++l) ap[l] = fmaf(scale, t[l], aj[l]);
      }
    }
    __syncthreads();
  }
}

template <int O>
cudaError_t launch(const float* x, const float* w, float* out, int B, int I,
                   int J, int iters, cudaStream_t stream) {
  const size_t smem = smem_bytes(I, J);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        routing_fwd_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  routing_fwd_kernel<O><<<B, kThreads, smem, stream>>>(x, w, out, I, J, iters);
  return cudaGetLastError();
}

// ---- materialised votes (in_length > 8) ----------------------------------

// Shared memory of one block of K1-D's routing, in floats: the vote slice
// u [I][njm][O] (only where it fits, `keep`) | couplings [I][njm] | outputs
// [njm][O] | logits [I][njm] | exchange rows [2][2 I], njm = ceil(J / C).
__host__ __device__ inline size_t votes_fwd_smem_floats(int I, int J, int O,
                                                        int C, bool keep) {
  const size_t nj = (size_t)(J + C - 1) / C;
  return (keep ? (size_t)I * nj * O : 0) + 2 * (size_t)I * nj + nj * O +
         4 * (size_t)I;
}

// Dynamic routing of u [B, I, J, O] on clusters of C blocks, one cluster a
// sample; the block of rank q owns the output capsules [q J / C,
// (q + 1) J / C) and writes their outputs.
template <int O>
__global__ void __launch_bounds__(kRouteThreads)
routing_votes_fwd_cluster_kernel(const float* __restrict__ u,
                                 float* __restrict__ out, int I, int J, int R,
                                 int keep) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int njm = (J + C - 1) / C;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  float* cs = us + (keep ? (size_t)I * njm * O : 0);
  float* vs = cs + (size_t)I * njm;
  float* bl = vs + (size_t)njm * O;
  float* xch = bl + (size_t)I * njm;
  const VoteSlice sl = vote_slice<O>(C, (int)cluster.block_rank(), u, us, bl,
                                     xch, I, J, keep != 0);
  int xp = 0;
  route_forward<O, false>(cluster, sl, bl, cs, nullptr, vs, xch, xp,
                          out + ((size_t)sl.b * J + sl.j0) * O, I, C, R);
  // no block leaves while another may still read its exchange rows
  cluster.sync();
}

template <int O>
cudaError_t launch_votes(const float* u, float* out, int B, int I, int J,
                         int R, int C, bool keep, cudaStream_t stream) {
  return launch_cluster(routing_votes_fwd_cluster_kernel<O>, B, C,
                        sizeof(float) * votes_fwd_smem_floats(I, J, O, C,
                                                              keep),
                        stream, u, out, I, J, R, (int)keep);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t capsule_routing_smem_bytes(int I, int J) { return smem_bytes(I, J); }

// x [B, I, 8], w [J, O, 8], out [B, J, O]; all float32, contiguous and
// 16-byte aligned, on `device`; `stream` is a cudaStream_t of that device.
// Returns the CUDA error code of the launch (0 = success).
int capsule_routing_fwd(const void* x, const void* w, void* out, int B, int I,
                        int J, int O, int iters, int device, void* stream) {
  if (B <= 0 || I <= 0 || I > kThreads || J <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t se = begin_call(device);
  if (se != cudaSuccess) return (int)se;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (O) {
    case 16: e = launch<16>(xf, wf, of, B, I, J, iters, st); break;
    case 32: e = launch<32>(xf, wf, of, B, I, J, iters, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

size_t capsule_routing_votes_smem_bytes(int I, int J, int O, int cluster,
                                        int keep_votes) {
  return sizeof(float) *
         votes_fwd_smem_floats(I, J, O, cluster, keep_votes != 0);
}

// x [B, I, L], w [J, O, L], votes scratch [B, I, J, O], out [B, J, O]; all
// float32, contiguous and 16-byte aligned, on `device`. Two launches on
// `stream`: the vote product u = x . W^T (3xTF32 on the tensor cores,
// gemm_tf32x3.cuh), then the routing on clusters of `cluster` blocks (1..8,
// at most J) per sample, each block's vote slice in shared memory where
// keep_votes is set (ops/capsule_cuda.py::votes_fwd_plan chooses both).
// Returns the CUDA error code (0 = success); a cluster launch that the card
// refuses returns its error, and nothing falls back to another form.
int capsule_routing_votes_fwd(const void* x, const void* w, void* votes,
                              void* out, int B, int I, int L, int J, int O,
                              int iters, int cluster, int keep_votes,
                              int device, void* stream) {
  if (B <= 0 || I <= 0 || L <= 0 || J <= 0 || iters <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > J)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = begin_call(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* u = static_cast<float*>(votes);
  const int kb = gemm_tf32x3::kBK;
  // u [B*I, J*O] = x [B*I, L] . w [J*O, L]^T (both K-major)
  e = gemm_tf32x3::gemm(static_cast<const float*>(x), true, L,
                        static_cast<const float*>(w), true, L, u, J * O,
                        B * I, J * O, L, 1, (L + kb - 1) / kb * kb, nullptr,
                        st);
  if (e != cudaSuccess) return (int)e;
  float* of = static_cast<float*>(out);
  switch (O) {
    case 16:
      e = launch_votes<16>(u, of, B, I, J, iters, cluster, keep_votes != 0,
                           st);
      break;
    case 32:
      e = launch_votes<32>(u, of, B, I, J, iters, cluster, keep_votes != 0,
                           st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
