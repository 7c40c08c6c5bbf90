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
// capsule_routing_votes_fwd. There the factored form stops paying: a_j and
// y_j would be 512 floats per output capsule, while the votes of a sample
// are only 16 x 201 x 16 floats = 206 KB. So the votes are materialised,
// as the TPU kernel does: a tiled float32 product (gemm_f32.cuh, 1.7 GFLOP
// at a batch of 32) writes u[b, i, j, o] to a scratch of 6.6 MB that stays
// in L2, and one block per sample routes over it with the couplings and
// logits (I x J floats each) and the outputs (J x O) in shared memory.
// What bounds this form is the vote product's float32 arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm_f32.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 8;  // in_length; two float4 per capsule row

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

// Shared memory: logits [I*J] | couplings [I*J] | outputs [J*O], each
// rounded up to whole float4 so that the outputs can be read as float4.
__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

__host__ __device__ inline size_t votes_smem_bytes(int I, int J, int O) {
  return sizeof(float) * (2 * round4((size_t)I * J) + (size_t)J * O);
}

// Dynamic routing of one sample per block over u [B, I, J, O]. A (j, o)
// loop runs to a multiple of 32 so whole warps take part in the squash
// reduction; the O values of one j sit in O neighbouring lanes.
template <int O>
__global__ void __launch_bounds__(kThreads)
routing_votes_fwd_kernel(const float* __restrict__ u, float* __restrict__ out,
                         int I, int J, int iters) {
  extern __shared__ float4 smem4[];
  float* bl = reinterpret_cast<float*>(smem4);
  float* cs = bl + round4((size_t)I * J);
  float* vs = cs + round4((size_t)I * J);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ub = u + (size_t)b * I * J * O;
  const int IJ = I * J;
  const int JO = J * O;
  const int JO32 = (JO + 31) & ~31;
  for (int p = tid; p < IJ; p += kThreads) bl[p] = 0.f;
  __syncthreads();
  for (int r = 0; r < iters; ++r) {
    // couplings: softmax of each row i over the output capsules
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
    const bool last = (r == iters - 1);
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
      const float v = s * (n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f));
      if (valid) {
        if (last) out[(size_t)b * JO + t] = v;
        else vs[t] = v;
      }
    }
    __syncthreads();
    if (!last) {
      for (int p = tid; p < IJ; p += kThreads) {
        const int j = p % J;
        const float4* up = reinterpret_cast<const float4*>(ub + (size_t)p * O);
        const float4* vp = reinterpret_cast<const float4*>(vs + (size_t)j * O);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < O / 4; ++q) {
          const float4 a = __ldg(up + q);
          const float4 c = vp[q];
          acc = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, acc))));
        }
        bl[p] += acc;
      }
      __syncthreads();
    }
  }
}

template <int O>
cudaError_t launch_votes(const float* u, float* out, int B, int I, int J,
                         int iters, cudaStream_t stream) {
  const size_t smem = votes_smem_bytes(I, J, O);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        routing_votes_fwd_kernel<O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  routing_votes_fwd_kernel<O><<<B, kThreads, smem, stream>>>(u, out, I, J,
                                                             iters);
  return cudaGetLastError();
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
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  cudaError_t se = cudaSetDevice(device);
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

size_t capsule_routing_votes_smem_bytes(int I, int J, int O) {
  return votes_smem_bytes(I, J, O);
}

// x [B, I, L], w [J, O, L], votes scratch [B, I, J, O], out [B, J, O]; all
// float32, contiguous and 16-byte aligned, on `device`. Two launches on
// `stream`: the vote product, then the routing. Returns the CUDA error code
// (0 = success).
int capsule_routing_votes_fwd(const void* x, const void* w, void* votes,
                              void* out, int B, int I, int L, int J, int O,
                              int iters, int device, void* stream) {
  if (B <= 0 || I <= 0 || L <= 0 || J <= 0 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* u = static_cast<float*>(votes);
  // u [B*I, J*O] = x [B*I, L] . w[J*O, L]^T
  e = capsule_gemm::gemm_f32(static_cast<const float*>(x),
                             static_cast<const float*>(w), u, B * I, J * O, L,
                             L, 1, 1, L, (long long)J * O, st);
  if (e != cudaSuccess) return (int)e;
  float* of = static_cast<float*>(out);
  switch (O) {
    case 16: e = launch_votes<16>(u, of, B, I, J, iters, st); break;
    case 32: e = launch_votes<32>(u, of, B, I, J, iters, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
