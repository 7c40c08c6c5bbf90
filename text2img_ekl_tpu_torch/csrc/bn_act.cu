// BatchNorm with its activation epilogue (K5), forward and backward, train
// and eval, for Hopper, sm_90a.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the JAX package's
// BatchNorm -> GLU / LeakyReLU chains (text2img_ekl_tpu/nn/blocks.py) into
// its own loops, so no kernel was written there. In the port the same
// chains ran as ~15 eager ATen kernels over float32 copies forward and as
// many again under autograd backward; this file computes each of them in
// two passes each way.
//
// What it computes, over x [N, C, HW] (NCHW, the spatial dims flattened):
// flax's statistics in float32 (mean and E[x^2] - mean^2, biased; the
// variance clipped at 0 before use and before the running update
// 0.9 old + 0.1 batch), or the running statistics in eval mode; the affine
// (x - mean) * (rsqrt(var + eps) * w) + b in float32, rounded to the
// BatchNorm dtype; then the epilogue in that dtype with PyTorch's rounding
// points: GLU a * sigmoid(g) over the two channel halves, LeakyReLU with
// slope 0.2 (0.2 rounded to bfloat16 where the BatchNorm dtype is
// bfloat16), or nothing (a residual block's second BatchNorm). Backward
// recomputes the BatchNorm output from x and the saved per-channel
// statistics, rounds the activation's gradient where autograd's bfloat16
// mul / sigmoid_backward / leaky_relu_backward round, and does the
// BatchNorm part in float32.
//
// What bounds it: device-memory bytes. Per element it does a few tens of
// instructions, below the ~20 flops a byte where an H100 stops being bound
// by its 3.35 TB/s; only the GLU passes, which recompute an exact logistic
// and round as bfloat16 does, come near the instruction limit (on an H100
// they run at 60-80 % of their bytes' time, the others at ~90 %).
//
// What the design does about it: each direction is two streaming passes
// over the activations, with tiny per-channel kernels between them.
//   Forward, train: bn_act_stats reads x once (16-byte vectors) and writes
//   float32 partial sums of x and x^2 per (channel, batch split); the
//   finalize combines a channel's partials in a fixed order, applies the
//   running update and writes the statistics; bn_act_apply reads x once
//   more and writes the activated output once (with a GLU: both channel
//   halves in, one out). Eval: bn_act_apply alone, on the running
//   statistics.
//   Backward: bn_act_bwd_sums reads x and dout once and writes partial sums
//   of dy and dy (x - mean) per (channel, split), where dy is the gradient
//   of the BatchNorm output; the finalize writes dweight, dbias and three
//   coefficients a channel; bn_act_bwd_dx reads x and dout again and writes
//   dx once. Nothing of float32 size is saved for backward: x in its own
//   type and two floats a channel.
// The reduction passes tile [N, C, HW] with blocks of CB channels x TPC
// threads a channel (TPC the largest power of two up to 256 that the plane's
// vectors fill, CB = 256 / TPC), and a batch range a block: a 4x4 map (two
// vectors a plane) takes 128 channels a block, so that neighbouring threads
// still read neighbouring addresses. Every sum is taken in a fixed order
// (per thread, then a shared-memory tree, then the partials in split order)
// with no atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
enum { kNone = 0, kGlu = 1, kLeaky = 2 };

// 0.2 as LeakyReLU's slope: in the BatchNorm dtype's arithmetic, 0.2
// rounded to bfloat16 (the JAX constant's rounding) or float32's 0.2
constexpr float kSlopeBf16 = 0.2001953125f;
constexpr float kSlopeF32 = 0.2f;
// the running update's factors, as float32 scalars: 0.9 and 1 - 0.9
constexpr float kKeep = 0.9f;
constexpr float kTake = 0.1f;

template <typename T> struct Tag { using type = T; };
template <int V> using IC = std::integral_constant<int, V>;

// The output type: the BatchNorm dtype without an epilogue, else the
// compute dtype, which is x's.
template <typename TI, bool BF, int ACT>
using OutT = std::conditional_t<ACT == kNone,
                                std::conditional_t<BF, __nv_bfloat16, float>,
                                TI>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16(v);
}

// W consecutive elements as floats: W == 8 in 16-byte vectors (the caller
// guarantees alignment), W == 1 one element.
template <typename T, int W>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[W]) {
  if constexpr (W == 8) {
    alignas(16) T buf[8];
    constexpr int kN = 8 * sizeof(T) / 16;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      reinterpret_cast<uint4*>(buf)[i] =
          __ldg(reinterpret_cast<const uint4*>(p) + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = to_f(buf[j]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) f[j] = to_f(p[j]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[W]) {
  if constexpr (W == 8) {
    alignas(16) T buf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) buf[j] = from_f<T>(f[j]);
    constexpr int kN = 8 * sizeof(T) / 16;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(buf)[i];
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = from_f<T>(f[j]);
  }
}

// Pairwise sum of W values; the _rn forms keep ptxas from contracting a
// square and a sum into one fused multiply-add (the eager graph rounds
// x * x before it sums).
template <int W>
__device__ __forceinline__ float vsum(const float (&f)[W]) {
  if constexpr (W == 8) {
    return __fadd_rn(__fadd_rn(__fadd_rn(f[0], f[1]), __fadd_rn(f[2], f[3])),
                     __fadd_rn(__fadd_rn(f[4], f[5]), __fadd_rn(f[6], f[7])));
  } else {
    float s = f[0];
#pragma unroll
    for (int j = 1; j < W; ++j) s = __fadd_rn(s, f[j]);
    return s;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// a value rounded to the BatchNorm dtype
template <bool BF>
__device__ __forceinline__ float rbn(float v) {
  return BF ? round_bf16(v) : v;
}

// One channel's affine, as the eager graph computes it: scale =
// rsqrt(var + eps) * w, then (x - mean) * scale + b, three roundings.
struct Affine {
  float mean, scale, bias;
};
__device__ __forceinline__ float rstd_of(float var, float eps) {
  return rsqrtf(__fadd_rn(fmaxf(var, 0.0f), eps));
}
__device__ __forceinline__ Affine affine_of(const float* __restrict__ mean,
                                            const float* __restrict__ var,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            int c, float eps) {
  Affine a;
  a.mean = __ldg(mean + c);
  a.scale = __fmul_rn(rstd_of(__ldg(var + c), eps), __ldg(w + c));
  a.bias = __ldg(b + c);
  return a;
}
template <bool BF>
__device__ __forceinline__ float bn_out(float x, const Affine& a) {
  return rbn<BF>(
      __fadd_rn(__fmul_rn(__fsub_rn(x, a.mean), a.scale), a.bias));
}

// PyTorch's logistic, 1 / (1 + exp(-g)) in float32; the correctly rounded
// reciprocal is the correctly rounded quotient 1 / d, so __frcp_rn gives
// the division's bits in fewer instructions (5-9 % off the GLU passes)
__device__ __forceinline__ float sigm(float g) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-g)));
}
template <bool BF>
__device__ __forceinline__ float slope() {
  return BF ? kSlopeBf16 : kSlopeF32;
}
template <bool BF>
__device__ __forceinline__ float leaky(float y) {
  return y > 0.0f ? y : rbn<BF>(__fmul_rn(y, slope<BF>()));
}

// Per-channel statistics, coefficients and partials live in float32
// buffers laid out [k][splits][C] for a partial k of a channel.

// ---- forward --------------------------------------------------------------

// Partial sums of x and x * x of channel c over batch rows [n0, n1): grid
// (ceil(C / cb), splits), tpc * cb == kThreads.
template <typename TI, int W>
__global__ void __launch_bounds__(kThreads)
bn_act_stats(const TI* __restrict__ x, int N, int C, long long HW, int V,
             int tpc, int cb, int splits, float* __restrict__ part) {
  __shared__ float red[2][kThreads];
  const int t = threadIdx.x;
  const int ul = t / tpc, lane = t - ul * tpc;
  const int c = blockIdx.x * cb + ul;
  const int s = blockIdx.y;
  const int n0 = (int)((long long)s * N / splits);
  const int n1 = (int)((long long)(s + 1) * N / splits);
  float s1 = 0.0f, s2 = 0.0f;
  if (c < C) {
    for (int n = n0; n < n1; ++n) {
      const TI* p = x + ((long long)n * C + c) * HW;
#pragma unroll 4
      for (int v = lane; v < V; v += tpc) {
        float f[W], q[W];
        load<TI, W>(p + (long long)v * W, f);
#pragma unroll
        for (int j = 0; j < W; ++j) q[j] = __fmul_rn(f[j], f[j]);
        s1 = __fadd_rn(s1, vsum<W>(f));
        s2 = __fadd_rn(s2, vsum<W>(q));
      }
    }
  }
  red[0][t] = s1;
  red[1][t] = s2;
  for (int st = tpc / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (lane < st) {
      red[0][t] = __fadd_rn(red[0][t], red[0][t + st]);
      red[1][t] = __fadd_rn(red[1][t], red[1][t + st]);
    }
  }
  __syncthreads();
  if (lane == 0 && c < C) {
    part[(long long)s * C + c] = red[0][t];
    part[((long long)splits + s) * C + c] = red[1][t];
  }
}

// One warp a channel: combine its `splits` partials (lanes in split order,
// then a fixed shuffle tree, in double), write mean and the unclipped
// variance to stats [2][C], and fold the batch statistics into the running
// ones unless `update` is 0.
__global__ void __launch_bounds__(kThreads)
bn_act_stats_finalize(const float* __restrict__ part, int splits, int C,
                      double count, float* __restrict__ stats,
                      float* __restrict__ rmean, float* __restrict__ rvar,
                      int update) {
  const int c = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  double s1 = 0.0, s2 = 0.0;
  for (int i = lane; i < splits; i += 32) {
    s1 += part[(long long)i * C + c];
    s2 += part[((long long)splits + i) * C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane) return;
  const float mean = (float)(s1 / count);
  const float ex2 = (float)(s2 / count);
  const float var = __fsub_rn(ex2, __fmul_rn(mean, mean));
  stats[c] = mean;
  stats[C + c] = var;
  if (update) {
    rmean[c] = __fmaf_rn(kTake, mean, __fmul_rn(kKeep, rmean[c]));
    rvar[c] = __fmaf_rn(kTake, fmaxf(var, 0.0f), __fmul_rn(kKeep, rvar[c]));
  }
}

// One thread a run of W outputs of one output plane (n, co): Co output
// channels (C / 2 with a GLU, else C), `runs` = HW / W runs a plane.
template <typename TI, bool BF, int ACT, int W>
__global__ void __launch_bounds__(kThreads)
bn_act_apply(const TI* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ var, const float* __restrict__ w,
             const float* __restrict__ b, float eps,
             OutT<TI, BF, ACT>* __restrict__ out, int C, int Co,
             unsigned runs, unsigned units, long long HW) {
  using TO = OutT<TI, BF, ACT>;
  const unsigned unit = blockIdx.x * kThreads + threadIdx.x;
  if (unit >= units) return;
  const unsigned plane = unit / runs;
  const unsigned r = unit - plane * runs;
  const unsigned n = plane / Co;
  const int co = (int)(plane - n * Co);
  const long long off = (long long)r * W;
  const TI* xa = x + ((long long)n * C + co) * HW + off;
  const Affine aa = affine_of(mean, var, w, b, co, eps);
  float fa[W], o[W];
  load<TI, W>(xa, fa);
  if constexpr (ACT == kGlu) {
    const Affine ag = affine_of(mean, var, w, b, co + Co, eps);
    float fg[W];
    load<TI, W>(xa + (long long)Co * HW, fg);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float a = bn_out<BF>(fa[j], aa);
      const float s = rbn<BF>(sigm(bn_out<BF>(fg[j], ag)));
      o[j] = rbn<BF>(__fmul_rn(a, s));
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float y = bn_out<BF>(fa[j], aa);
      o[j] = ACT == kLeaky ? leaky<BF>(y) : y;
    }
  }
  store<TO, W>(out + (long long)plane * HW + off, o);
}

// ---- backward -------------------------------------------------------------

// The gradients of the BatchNorm outputs (float32 values of the BatchNorm
// dtype) of one element from its x (a, and g with a GLU) and dout, with
// autograd's roundings: the output's cast back to the BatchNorm dtype, then
// mul's two products and sigmoid_backward (g (1 - s) s), or
// leaky_relu_backward, each rounded to the BatchNorm dtype.
template <bool BF, int ACT>
__device__ __forceinline__ void act_grad(float xa, float xg, float d,
                                         const Affine& aa, const Affine& ag,
                                         float& dya, float& dyg) {
  if constexpr (ACT == kNone) {
    dya = d;
  } else if constexpr (ACT == kLeaky) {
    const float g = rbn<BF>(d);
    dya = bn_out<BF>(xa, aa) > 0.0f ? g : rbn<BF>(__fmul_rn(g, slope<BF>()));
  } else {
    const float g = rbn<BF>(d);
    const float a = bn_out<BF>(xa, aa);
    const float s = rbn<BF>(sigm(bn_out<BF>(xg, ag)));
    dya = rbn<BF>(__fmul_rn(g, s));
    const float ds = rbn<BF>(__fmul_rn(g, a));
    dyg = rbn<BF>(__fmul_rn(__fmul_rn(ds, __fsub_rn(1.0f, s)), s));
  }
}

// Partial sums of dy and dy (x - mean) of each input channel over batch
// rows [n0, n1), tiled as bn_act_stats over the Co output channels; with a
// GLU a thread also takes the gate channel co + Co.
template <typename TI, bool BF, int ACT, int W>
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_sums(const TI* __restrict__ x,
                const OutT<TI, BF, ACT>* __restrict__ dout,
                const float* __restrict__ mean, const float* __restrict__ var,
                const float* __restrict__ w, const float* __restrict__ b,
                float eps, int N, int C, int Co, long long HW, int V, int tpc,
                int cb, int splits, float* __restrict__ part) {
  using TO = OutT<TI, BF, ACT>;
  constexpr int kAcc = ACT == kGlu ? 4 : 2;
  __shared__ float red[kAcc][kThreads];
  const int t = threadIdx.x;
  const int ul = t / tpc, lane = t - ul * tpc;
  const int co = blockIdx.x * cb + ul;
  const int s = blockIdx.y;
  const int n0 = (int)((long long)s * N / splits);
  const int n1 = (int)((long long)(s + 1) * N / splits);
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  if (co < Co) {
    const Affine aa = affine_of(mean, var, w, b, co, eps);
    const Affine ag = ACT == kGlu ? affine_of(mean, var, w, b, co + Co, eps)
                                  : aa;
    for (int n = n0; n < n1; ++n) {
      const TI* pa = x + ((long long)n * C + co) * HW;
      const TO* pd = dout + ((long long)n * Co + co) * HW;
#pragma unroll 2
      for (int v = lane; v < V; v += tpc) {
        const long long e = (long long)v * W;
        float fa[W], fg[W], fd[W];
        load<TI, W>(pa + e, fa);
        load<TO, W>(pd + e, fd);
        if constexpr (ACT == kGlu) load<TI, W>(pa + (long long)Co * HW + e, fg);
        float dya[W], dyg[W], pa1[W], pg1[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          act_grad<BF, ACT>(fa[j], ACT == kGlu ? fg[j] : 0.0f, fd[j], aa, ag,
                            dya[j], dyg[j]);
          pa1[j] = __fmul_rn(dya[j], __fsub_rn(fa[j], aa.mean));
          if constexpr (ACT == kGlu)
            pg1[j] = __fmul_rn(dyg[j], __fsub_rn(fg[j], ag.mean));
        }
        acc[0] = __fadd_rn(acc[0], vsum<W>(dya));
        acc[1] = __fadd_rn(acc[1], vsum<W>(pa1));
        if constexpr (ACT == kGlu) {
          acc[2] = __fadd_rn(acc[2], vsum<W>(dyg));
          acc[3] = __fadd_rn(acc[3], vsum<W>(pg1));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) red[k][t] = acc[k];
  for (int st = tpc / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (lane < st) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k)
        red[k][t] = __fadd_rn(red[k][t], red[k][t + st]);
    }
  }
  __syncthreads();
  if (lane == 0 && co < Co) {
    part[(long long)s * C + co] = red[0][t];
    part[((long long)splits + s) * C + co] = red[1][t];
    if constexpr (ACT == kGlu) {
      part[(long long)s * C + co + Co] = red[2][t];
      part[((long long)splits + s) * C + co + Co] = red[3][t];
    }
  }
}

// One warp a channel: combine the partials as bn_act_stats_finalize does;
// dbias = sum dy, dweight = rstd * sum dy (x - mean) (each written where its
// pointer is not null), and dx's coefficients coef [3][C]: k = w rstd, the
// mean of dy, and rstd^2 times the mean of dy (x - mean), so that dx = k
// (dy - mean dy - (x - mean) coef2). In eval mode, and for the variance's
// term where the batch variance was clipped (whose gradient the clip
// stops), the subtracted terms are 0.
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_finalize(const float* __restrict__ part, int splits, int C,
                    double count, const float* __restrict__ var,
                    const float* __restrict__ w, float eps, int train,
                    float* __restrict__ dw, float* __restrict__ db,
                    float* __restrict__ coef) {
  const int c = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / 32);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  double sd = 0.0, sdx = 0.0;
  for (int i = lane; i < splits; i += 32) {
    sd += part[(long long)i * C + c];
    sdx += part[((long long)splits + i) * C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sd += __shfl_down_sync(0xffffffffu, sd, off);
    sdx += __shfl_down_sync(0xffffffffu, sdx, off);
  }
  if (lane) return;
  const float v = var[c];
  const float rstd = rstd_of(v, eps);
  if (db) db[c] = (float)sd;
  if (dw) dw[c] = (float)(sdx * rstd);
  coef[c] = __fmul_rn(w[c], rstd);
  coef[C + c] = train ? (float)(sd / count) : 0.0f;
  coef[2 * C + c] = train && v >= 0.0f
                        ? (float)(sdx / count * rstd * rstd) : 0.0f;
}

// dx, one thread a run of W elements of one output plane (n, co), as
// bn_act_apply; with a GLU it writes the planes co and co + Co of dx.
template <typename TI, bool BF, int ACT, int W>
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_dx(const TI* __restrict__ x,
              const OutT<TI, BF, ACT>* __restrict__ dout,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ w, const float* __restrict__ b,
              float eps, const float* __restrict__ coef, TI* __restrict__ dx,
              int C, int Co, unsigned runs, unsigned units, long long HW) {
  using TO = OutT<TI, BF, ACT>;
  const unsigned unit = blockIdx.x * kThreads + threadIdx.x;
  if (unit >= units) return;
  const unsigned plane = unit / runs;
  const unsigned r = unit - plane * runs;
  const unsigned n = plane / Co;
  const int co = (int)(plane - n * Co);
  const long long off = (long long)r * W;
  const long long ia = ((long long)n * C + co) * HW + off;
  const long long ig = ia + (long long)Co * HW;
  const Affine aa = affine_of(mean, var, w, b, co, eps);
  const Affine ag = ACT == kGlu ? affine_of(mean, var, w, b, co + Co, eps)
                                : aa;
  float fa[W], fg[W], fd[W], oa[W], og[W];
  load<TI, W>(x + ia, fa);
  load<TO, W>(dout + (long long)plane * HW + off, fd);
  if constexpr (ACT == kGlu) load<TI, W>(x + ig, fg);
  const float ka = __ldg(coef + co), ma = __ldg(coef + C + co),
              qa = __ldg(coef + 2 * C + co);
  const int cg = ACT == kGlu ? co + Co : co;
  const float kg = __ldg(coef + cg), mg = __ldg(coef + C + cg),
              qg = __ldg(coef + 2 * C + cg);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    float dya, dyg;
    act_grad<BF, ACT>(fa[j], ACT == kGlu ? fg[j] : 0.0f, fd[j], aa, ag, dya,
                      dyg);
    oa[j] = __fmul_rn(ka, __fsub_rn(__fsub_rn(dya, ma),
                                    __fmul_rn(__fsub_rn(fa[j], aa.mean), qa)));
    if constexpr (ACT == kGlu)
      og[j] = __fmul_rn(kg, __fsub_rn(__fsub_rn(dyg, mg),
                                      __fmul_rn(__fsub_rn(fg[j], ag.mean),
                                                qg)));
  }
  store<TI, W>(dx + ia, oa);
  if constexpr (ACT == kGlu) store<TI, W>(dx + ig, og);
}

// ---- dispatch -------------------------------------------------------------

// Calls fn(Tag<TI>, IC<BF>, IC<ACT>, IC<W>) with the template arguments of
// the runtime flags.
template <typename Fn>
cudaError_t dispatch(int in_bf16, int bn_bf16, int act, int vec, Fn&& fn) {
  auto with_act = [&](auto ti, auto bf) -> cudaError_t {
    auto with_vec = [&](auto ac) -> cudaError_t {
      return vec ? fn(ti, bf, ac, IC<8>{}) : fn(ti, bf, ac, IC<1>{});
    };
    switch (act) {
      case kNone: return with_vec(IC<kNone>{});
      case kGlu: return with_vec(IC<kGlu>{});
      case kLeaky: return with_vec(IC<kLeaky>{});
      default: return cudaErrorInvalidValue;
    }
  };
  auto with_bf = [&](auto ti) -> cudaError_t {
    return bn_bf16 ? with_act(ti, IC<1>{}) : with_act(ti, IC<0>{});
  };
  return in_bf16 ? with_bf(Tag<__nv_bfloat16>{}) : with_bf(Tag<float>{});
}

// grid of the run-wise kernels; 0 where the units do not fit 32 bits
unsigned run_blocks(long long N, int Co, long long HW, int W,
                    unsigned* runs, unsigned* units) {
  const long long r = HW / W;
  const long long u = N * Co * r;
  if (u <= 0 || u > 0xffffffffLL - kThreads) return 0;
  *runs = (unsigned)r;
  *units = (unsigned)u;
  return (unsigned)((u + kThreads - 1) / kThreads);
}

unsigned warp_blocks(int C) {
  return (unsigned)(((long long)C * 32 + kThreads - 1) / kThreads);
}

cudaError_t prologue(int device) {
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// All tensors contiguous on `device`; `stream` a cudaStream_t of it. x is
// [N, C, HW] in float32 (in_bf16 0) or bfloat16 (1); the output is of x's
// type with an epilogue (act 1 GLU, 2 LeakyReLU) and of the BatchNorm type
// (bn_bf16) without one (act 0). vec: 16-byte vectors (HW % 8 == 0 and
// every pointer 16-byte aligned), else single elements. Partials are float32
// [2][splits][C]; tpc * cb == 256, tpc a power of two. Each returns the
// CUDA error of its launches (0 = success).

int bn_act_stats_fwd(const void* x, int in_bf16, long long N, int C,
                     long long HW, int vec, int tpc, int cb, int splits,
                     float* part, double count, float* stats, float* rmean,
                     float* rvar, int update, int device, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || N > 0x7fffffffLL || tpc * cb != kThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prologue(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = vec ? 8 : 1;
  const dim3 grid((unsigned)((C + cb - 1) / cb), (unsigned)splits);
  const int V = (int)(HW / W);
  if (in_bf16) {
    auto xt = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      bn_act_stats<__nv_bfloat16, 8><<<grid, kThreads, 0, st>>>(
          xt, (int)N, C, HW, V, tpc, cb, splits, part);
    else
      bn_act_stats<__nv_bfloat16, 1><<<grid, kThreads, 0, st>>>(
          xt, (int)N, C, HW, V, tpc, cb, splits, part);
  } else {
    auto xt = static_cast<const float*>(x);
    if (vec)
      bn_act_stats<float, 8><<<grid, kThreads, 0, st>>>(
          xt, (int)N, C, HW, V, tpc, cb, splits, part);
    else
      bn_act_stats<float, 1><<<grid, kThreads, 0, st>>>(
          xt, (int)N, C, HW, V, tpc, cb, splits, part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_act_stats_finalize<<<warp_blocks(C), kThreads, 0, st>>>(
      part, splits, C, count, stats, rmean, rvar, update);
  return (int)cudaGetLastError();
}

int bn_act_apply_fwd(const void* x, int in_bf16, const float* mean,
                     const float* var, const float* w, const float* b,
                     float eps, void* out, int bn_bf16, int act,
                     long long N, int C, long long HW, int vec, int device,
                     void* stream) {
  const int Co = act == kGlu ? C / 2 : C;
  unsigned runs, units;
  const unsigned blocks = run_blocks(N, Co, HW, vec ? 8 : 1, &runs, &units);
  if (blocks == 0 || C <= 0 || (act == kGlu && C % 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prologue(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(in_bf16, bn_bf16, act, vec,
                       [&](auto ti, auto bf, auto ac, auto vc) {
    using TI = typename decltype(ti)::type;
    constexpr bool BF = decltype(bf)::value;
    constexpr int ACT = decltype(ac)::value;
    constexpr int W = decltype(vc)::value;
    bn_act_apply<TI, BF, ACT, W><<<blocks, kThreads, 0, st>>>(
        static_cast<const TI*>(x), mean, var, w, b, eps,
        static_cast<OutT<TI, BF, ACT>*>(out), C, Co, runs, units, HW);
    return cudaGetLastError();
  });
}

// Backward: dout of the forward's output type; mean and var the statistics
// the forward normalised with (batch or running); dw, db may be null (not
// wanted); dx may be null (not wanted), then only the sums and dw / db run.
// train: the batch statistics' own gradient terms (train mode) or not.
int bn_act_bwd(const void* x, int in_bf16, const void* dout,
               const float* mean, const float* var, const float* w,
               const float* b, float eps, int bn_bf16, int act, int train,
               long long N, int C, long long HW, int vec, int tpc, int cb,
               int splits, float* part, double count, float* coef, float* dw,
               float* db, void* dx, int device, void* stream) {
  const int Co = act == kGlu ? C / 2 : C;
  unsigned runs, units;
  const unsigned blocks = run_blocks(N, Co, HW, vec ? 8 : 1, &runs, &units);
  if (blocks == 0 || C <= 0 || (act == kGlu && C % 2) ||
      N > 0x7fffffffLL || tpc * cb != kThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prologue(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = vec ? 8 : 1;
  const int V = (int)(HW / W);
  const dim3 grid((unsigned)((Co + cb - 1) / cb), (unsigned)splits);
  e = dispatch(in_bf16, bn_bf16, act, vec,
               [&](auto ti, auto bf, auto ac, auto vc) {
    using TI = typename decltype(ti)::type;
    constexpr bool BF = decltype(bf)::value;
    constexpr int ACT = decltype(ac)::value;
    constexpr int VW = decltype(vc)::value;
    bn_act_bwd_sums<TI, BF, ACT, VW><<<grid, kThreads, 0, st>>>(
        static_cast<const TI*>(x),
        static_cast<const OutT<TI, BF, ACT>*>(dout), mean, var, w, b, eps,
        (int)N, C, Co, HW, V, tpc, cb, splits, part);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return (int)e;
  bn_act_bwd_finalize<<<warp_blocks(C), kThreads, 0, st>>>(
      part, splits, C, count, var, w, eps, train, dw, db, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  return (int)dispatch(in_bf16, bn_bf16, act, vec,
                       [&](auto ti, auto bf, auto ac, auto vc) {
    using TI = typename decltype(ti)::type;
    constexpr bool BF = decltype(bf)::value;
    constexpr int ACT = decltype(ac)::value;
    constexpr int VW = decltype(vc)::value;
    bn_act_bwd_dx<TI, BF, ACT, VW><<<blocks, kThreads, 0, st>>>(
        static_cast<const TI*>(x),
        static_cast<const OutT<TI, BF, ACT>*>(dout), mean, var, w, b, eps,
        coef, static_cast<TI*>(dx), C, Co, runs, units, HW);
    return cudaGetLastError();
  });
}

}  // extern "C"
