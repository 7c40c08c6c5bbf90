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
// bytes. The routing arithmetic of the factored form below is small (0.27
// GFLOP at B=32, 2.7 at B=320: 0.004 and 0.041 ms at the float32 peak);
// what remains is latency: barriers, the exponentials and reading W from
// L2 on every pass.
//
// What the design does about it (K1-G): the weight is shared over the input
// capsules and linear in x, so every routing quantity factors through the
// input length L = 8 and the vote tensor never exists:
//   s_j  = sum_i c_ij u_ij = W_j y_j,      y_j = sum_i c_ij x_i
//   b_ij = sum_passes u_ij . v_j = x_i . a_j,  a_j = sum_passes W_j^T v_j
// Two launches:
// - W's rows as float4 planes (wt, 1 MB at the flagship), so that lanes
//   reading the rows of consecutive output capsules read consecutive
//   16-byte words;
// - the routing on a cluster of C blocks per sample, each owning about
//   J / C output capsules, with x, its slice's a_j, the couplings c_ij of
//   the current pass [I][nj] and the exchange rows in shared memory (84 KB
//   at C = 3; at C = 1 the couplings go to a per-block scratch in L2). The
//   passes are K2-G's forward recompute without its stashes
//   (capsule_common.cuh::factored_forward): the exponentials once a pass,
//   warps over input-capsule rows so that a row's max and sum are warp
//   reductions, two lanes per output capsule, and the softmax's (max, sum
//   of exp) per input capsule crossing the cluster through distributed
//   shared memory, combined in rank order: the same bits in every block
//   and in every call. Blocks of 512 threads, one an SM.
//   ops/capsule_cuda.py::factored_fwd_plan chooses C: the largest cluster
//   of which the card holds the whole batch at once (3 at B = 32 on an
//   H100), and where no cluster fits the batch in one wave, the cluster
//   size the card's sweep found fastest (2).
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

// ---- factored form (in_length 8): K1-G ------------------------------------

// Where a block's arrays lie, in floats. Shared memory, always: x [I][8] |
// a [njm][8] | the couplings' row scale [I] | exchange rows [2][2 I]; then,
// in shared memory where it fits (`keep`), else in the block's part of a
// scratch: the couplings c [I][ldp].
struct FactoredFwdLayout {
  size_t xs, ae, kk, xch, small, big;
};

__host__ __device__ inline FactoredFwdLayout factored_fwd_layout(int I, int J,
                                                                 int C) {
  const int njm = (J + C - 1) / C;
  FactoredFwdLayout f;
  size_t o = 0;
  f.xs = o; o += (size_t)I * kL;
  f.ae = o; o += (size_t)kL * njm;
  f.kk = o; o += (size_t)I;
  f.xch = o; o += 4 * (size_t)I;
  f.small = (o + 3) & ~(size_t)3;
  f.big = (size_t)I * factored_ldp(njm);
  return f;
}

__host__ __device__ inline size_t factored_fwd_smem(int I, int J, int C,
                                                    bool keep) {
  const FactoredFwdLayout f = factored_fwd_layout(I, J, C);
  return sizeof(float) * (f.small + (keep ? f.big : 0));
}

// Dynamic routing of x [B, I, 8] with W (as planes wt) on clusters of C
// blocks, one cluster a sample; the block of rank q routes the output
// capsules [q J / C, (q + 1) J / C) and writes their outputs. Blocks of
// kRouteThreads (512) threads, one an SM (128 registers). Keep the bound's
// minimum of one block an SM: without it the routing took 13 % longer on
// an H100 (47.6 against 41.9 us at the flagship's B = 32).
template <int O>
__global__ void __launch_bounds__(kRouteThreads, 1)
routing_fwd_factored_cluster_kernel(const float* __restrict__ x,
                                    const float4* __restrict__ wt,
                                    float* __restrict__ out,
                                    float* __restrict__ scratch, int I,
                                    int J, int R, int keep) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const FactoredSlice sl = factored_slice((int)cluster.block_rank(), J, C);
  const FactoredFwdLayout f = factored_fwd_layout(I, J, C);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + f.xs;
  float* acur = sm + f.ae;
  float* cb = keep ? sm + f.small : scratch + (size_t)blockIdx.x * f.big;
  const float* xb = x + (size_t)sl.b * I * kL;
  for (int k = threadIdx.x; k < I * kL; k += kRouteThreads) xs[k] = xb[k];
  for (int k = threadIdx.x; k < kL * sl.njm; k += kRouteThreads)
    acur[k] = 0.f;
  __syncthreads();
  int xp = 0;
  factored_forward<O, false>(
      cluster, sl, wt, xs, acur, cb, sm + f.kk, sm + f.xch, xp, nullptr,
      nullptr, nullptr, nullptr, out + ((size_t)sl.b * J + sl.j0) * O, I, J,
      C, R);
  // no block leaves while another may still read its exchange rows
  cluster.sync();
}

template <int O>
cudaError_t launch_factored(const float* x, const float* w, float* out,
                            float* wt, float* scratch, int B, int I, int J,
                            int R, int C, bool keep, cudaStream_t stream) {
  cudaError_t e = launch_w_planes(w, wt, J, O, stream);
  if (e != cudaSuccess) return e;
  return launch_cluster(routing_fwd_factored_cluster_kernel<O>, B, C,
                        factored_fwd_smem(I, J, C, keep), stream, x,
                        (const float4*)wt, out, scratch, I, J, R, (int)keep);
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

// Bytes of dynamic shared memory one block of K1-G's routing needs at
// clusters of `cluster` blocks, the couplings in it where `keep` is set.
size_t capsule_routing_fwd_smem_bytes(int I, int J, int cluster, int keep) {
  return factored_fwd_smem(I, J, cluster, keep != 0);
}

// floats of scratch one block needs where its couplings do not stay in
// shared memory
size_t capsule_routing_fwd_scratch_floats(int I, int J, int cluster) {
  return factored_fwd_layout(I, J, cluster).big;
}

// How many clusters of `cluster` blocks of K1-G's routing the card can
// hold at once (cudaOccupancyMaxActiveClusters; 0 where it cannot say):
// the plan keeps every sample's cluster in one wave where it can.
int capsule_routing_fwd_max_clusters(int I, int J, int O, int cluster,
                                     int keep, int device) {
  if (begin_call(device) != cudaSuccess) return 0;
  const size_t smem = factored_fwd_smem(I, J, cluster, keep != 0);
  if (O == 16)
    return max_active_clusters(routing_fwd_factored_cluster_kernel<16>,
                               cluster, smem);
  if (O == 32)
    return max_active_clusters(routing_fwd_factored_cluster_kernel<32>,
                               cluster, smem);
  return 0;
}

// K1-G, factored form, in_length 8. x [B, I, 8], w [J, O, 8], out [B, J,
// O]; wt [J O 8] a scratch for W's planes; the routing on clusters of
// `cluster` blocks (1..8, at most J) per sample, each block's couplings in
// shared memory where `keep` is set, else in scratch [B * cluster *
// capsule_routing_fwd_scratch_floats] (ops/capsule_cuda.py::
// factored_fwd_plan chooses both). All float32,
// contiguous and 16-byte aligned, on `device`; `stream` is a cudaStream_t of
// that device. Returns the CUDA error code (0 = success); a cluster launch
// that the card refuses returns its error, and nothing falls back to
// another form.
int capsule_routing_fwd(const void* x, const void* w, void* out, void* wt,
                        void* scratch, int B, int I, int J, int O, int iters,
                        int cluster, int keep, int device, void* stream) {
  if (B <= 0 || I <= 0 || J <= 0 || iters <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > J || !wt || (!keep && !scratch))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = begin_call(device);
  if (e != cudaSuccess) return (int)e;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  float* tf = static_cast<float*>(wt);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool k = keep != 0;
  if (O == 16)
    e = launch_factored<16>(xf, wf, of, tf, sf, B, I, J, iters, cluster, k,
                            st);
  else if (O == 32)
    e = launch_factored<32>(xf, wf, of, tf, sf, B, I, J, iters, cluster, k,
                            st);
  else
    return (int)cudaErrorInvalidValue;
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
