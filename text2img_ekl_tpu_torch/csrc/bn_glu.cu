// Fused BatchNorm-normalise + GLU (K3) for Hopper, sm_90a.
//
// Replaces text2img_ekl_tpu/ops/bn_glu.py::_fwd_kernel (via _fused_fwd),
// which reads row blocks of y [M, 2C] (NHWC rows) into TPU VMEM and writes
// (y*k + b)[:, :C] * sigmoid((y*k + b)[:, C:]) in one pass, with the folded
// per-channel affine k = rsqrt(var + eps) * scale, b = bias - mean * k.
//
// What bounds it here: nothing but device-memory bytes. Per output element
// it reads two inputs and two per-channel pairs (cached) and does a handful
// of flops and one exp, so at 3.35 TB/s and bf16 the flagship's largest
// launch ([32, 64, 128, 128] -> [32, 32, 128, 128]) takes ~0.03 ms at
// the bound.
//
// What the design does about it: the port keeps PyTorch's NCHW layout, so
// the two GLU halves of one output plane (b, c) are the planes (b, c) and
// (b, C + c) of y, each H*W contiguous elements. One thread owns a run of 8
// contiguous outputs inside one plane: it loads 8 elements of each half
// (16 bytes in bf16, two float4 in float32), the two (k, b) pairs of its
// channel, computes in float32 (the logistic too, as the TPU kernel does)
// and stores 8 outputs in y's type with one vector store. Every byte is
// read once and written once, neighbouring threads touch neighbouring
// addresses, and no shared memory is needed. Where H*W is not a multiple
// of 8 (or a pointer is not 16-byte aligned), the runs are not aligned and
// a scalar path masks the ragged tail of each plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // outputs per thread

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The affine is a rounded product then a rounded sum, never contracted to
// a fused multiply-add, so that it rounds as the plain version's separate
// multiply and add do: where y*k nearly cancels b, a contraction would move
// the small result by more than one bfloat16 ulp of it. kBf16: the affine
// in bfloat16, as the JAX kernel computes it where the BatchNorm dtype is
// bfloat16: y, k and b rounded to bfloat16, and the product and the sum
// each rounded to bfloat16 (exact float32 operations on bfloat16 values,
// then one rounding, as a bfloat16 multiply and add round).
template <bool kBf16>
__device__ __forceinline__ float affine(float y, float k, float b) {
  if (!kBf16) return __fadd_rn(__fmul_rn(y, k), b);
  const float p = round_bf16(__fmul_rn(round_bf16(y), round_bf16(k)));
  return round_bf16(__fadd_rn(p, round_bf16(b)));
}

// a * sigmoid(g), the logistic in float32 as the TPU kernel does
__device__ __forceinline__ float gate(float xa, float xg) {
  return xa * (1.0f / (1.0f + expf(-xg)));
}

// the GLU of one output
template <bool kBf16>
__device__ __forceinline__ float glu1(float a, float g, float ka, float ba,
                                      float kg, float bg) {
  return gate(affine<kBf16>(a, ka, ba), affine<kBf16>(g, kg, bg));
}

// The bfloat16 affine of two neighbours at once, on the packed bfloat16
// units: the same bits as affine<true>, since a product of two bfloat16
// values is exact in float32 and a float32 sum of two bfloat16 values
// rounds to bfloat16 as their exact sum does (where it is not exact, the
// smaller one lies far below half an ulp of the larger). The _rn forms
// keep ptxas from contracting the two into one fused multiply-add.
__device__ __forceinline__ __nv_bfloat162 pair_bf16(const float* v, int i) {
  return __floats2bfloat162_rn(v[i], v[i + 1]);
}
__device__ __forceinline__ __nv_bfloat162 pair_bf16(const __nv_bfloat16* v,
                                                    int i) {
  return __halves2bfloat162(v[i], v[i + 1]);
}
__device__ __forceinline__ float2 affine2(__nv_bfloat162 y,
                                          __nv_bfloat162 k,
                                          __nv_bfloat162 b) {
  return __bfloat1622float2(__hadd2_rn(__hmul2_rn(y, k), b));
}

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

// y [B, 2C, HW], out [B, C, HW]; k, b [2C] float32. One thread per run of
// kRun outputs of one plane; `runs` = ceil(HW / kRun) runs per plane.
template <typename T, bool kVec, bool kBf16>
__global__ void __launch_bounds__(kThreads)
bn_glu_kernel(const T* __restrict__ y, const float* __restrict__ k,
              const float* __restrict__ b, T* __restrict__ out,
              long long planes, int C, long long HW, long long runs) {
  const long long unit = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (unit >= planes * runs) return;
  const long long plane = unit / runs;   // b * C + c
  const long long r = unit - plane * runs;
  const long long bi = plane / C;
  const int c = (int)(plane - bi * C);
  const float ka = __ldg(k + c), ba = __ldg(b + c);
  const float kg = __ldg(k + C + c), bg = __ldg(b + C + c);
  const T* ya = y + (bi * 2 * C + c) * HW;
  const T* yg = ya + (long long)C * HW;
  T* o = out + plane * HW;
  const long long x0 = r * kRun;
  if (kVec) {
    // HW % 8 == 0 and every pointer 16-byte aligned: whole runs only
    alignas(16) T va[kRun];
    alignas(16) T vg[kRun];
    alignas(16) T vo[kRun];
    constexpr int kVecs = kRun * sizeof(T) / sizeof(uint4);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      reinterpret_cast<uint4*>(va)[v] =
          __ldg(reinterpret_cast<const uint4*>(ya + x0) + v);
      reinterpret_cast<uint4*>(vg)[v] =
          __ldg(reinterpret_cast<const uint4*>(yg + x0) + v);
    }
    if (kBf16) {
      const __nv_bfloat162 ka2 = __float2bfloat162_rn(ka);
      const __nv_bfloat162 ba2 = __float2bfloat162_rn(ba);
      const __nv_bfloat162 kg2 = __float2bfloat162_rn(kg);
      const __nv_bfloat162 bg2 = __float2bfloat162_rn(bg);
#pragma unroll
      for (int i = 0; i < kRun; i += 2) {
        const float2 xa = affine2(pair_bf16(va, i), ka2, ba2);
        const float2 xg = affine2(pair_bf16(vg, i), kg2, bg2);
        vo[i] = from_f<T>(gate(xa.x, xg.x));
        vo[i + 1] = from_f<T>(gate(xa.y, xg.y));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        vo[i] = from_f<T>(glu1<false>(to_f(va[i]), to_f(vg[i]), ka, ba, kg,
                                      bg));
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      reinterpret_cast<uint4*>(o + x0)[v] = reinterpret_cast<uint4*>(vo)[v];
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const long long x = x0 + i;
      if (x < HW)
        o[x] = from_f<T>(glu1<kBf16>(to_f(ya[x]), to_f(yg[x]), ka, ba, kg, bg));
    }
  }
}

template <typename T, bool kBf16>
cudaError_t launch(const void* y, const float* k, const float* b, void* out,
                   long long B, int C, long long HW, cudaStream_t st) {
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  const long long planes = B * C;
  const long long runs = (HW + kRun - 1) / kRun;
  const long long units = planes * runs;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = HW % kRun == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    bn_glu_kernel<T, true, kBf16><<<(unsigned)blocks, kThreads, 0, st>>>(
        yt, k, b, ot, planes, C, HW, runs);
  else
    bn_glu_kernel<T, false, kBf16><<<(unsigned)blocks, kThreads, 0, st>>>(
        yt, k, b, ot, planes, C, HW, runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [B, 2C, HW] (NCHW with the spatial dims flattened), out [B, C, HW], of
// one type: dtype 0 float32, 1 bfloat16; k and b [2C] float32 (the folded
// affine); bf16_affine: the affine in bfloat16 (the BatchNorm dtype
// bfloat16), else in float32. All contiguous, on `device`; `stream` is a
// cudaStream_t of that device. Returns the CUDA error code of the launch
// (0 = success).
int bn_glu_fwd(const void* y, const void* k, const void* b, void* out,
               long long B, int C, long long HW, int dtype, int bf16_affine,
               int device, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  cudaError_t se = cudaSetDevice(device);
  if (se != cudaSuccess) return (int)se;
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (2 * dtype + (bf16_affine != 0)) {
    case 0: return (int)launch<float, false>(y, kf, bf, out, B, C, HW, st);
    case 1: return (int)launch<float, true>(y, kf, bf, out, B, C, HW, st);
    case 2:
      return (int)launch<__nv_bfloat16, false>(y, kf, bf, out, B, C, HW, st);
    case 3:
      return (int)launch<__nv_bfloat16, true>(y, kf, bf, out, B, C, HW, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
