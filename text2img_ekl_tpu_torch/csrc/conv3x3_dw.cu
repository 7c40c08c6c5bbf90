// Weight gradient of a 3x3 stride-1 SAME bias-free convolution (K4) for
// Hopper, sm_90a.
//
// Replaces text2img_ekl_tpu/ops/conv_dw.py::_dw_kernel (dw3x3) and
// _dw_kernel_v2 (dw3x3_v2, the one conv3x3_dw's backward calls). Both TPU
// bodies compute the same function,
//   dW[f, c, ky, kx] = sum_{b, y, x} x[b, c, y+ky-1, x+kx-1] * dy[b, f, y, x]
// (zero outside the image), accumulated in float32: they stream (batch,
// row-tile) slabs of x and dy through VMEM once, lane-stack the column taps
// and contract on the MXU, carrying the float32 sum in an output block that
// the sequential grid revisits.
//
// What bounds it here: a product with a tiny output and a huge contraction
// (M = F <= 128, N = 9C <= 576, K = B*H*W up to 524,288 at the flagship).
// Its bytes are x and dy read once (~34 MB at the largest flagship shape in
// bf16, 0.01 ms), its operations 2*F*9C*K (up to 39 GFLOP, 0.04 ms at the
// bf16 tensor-core rate): operation-bound, as the TPU kernels are, which
// contract on the MXU.
//
// What the design does about it:
// - Hopper's blocks run in no order, so the TPU's sequential carry becomes
//   split-K: block (tile, split) owns an output tile of 64 f x 32 c x 9
//   taps and a contiguous chunk of slabs, each slab one image row segment
//   (b, y, up to 64 columns). It writes its float32 partial tile to a
//   scratch, and a second kernel sums the partials of every output in a
//   fixed order: no atomics, and a result that does not depend on the
//   schedule.
// - bfloat16 inputs contract on the tensor cores (mma.sync m16n8k16, float32
//   accumulators), as the TPU kernels do on the MXU. A slab stages dy[b,
//   f0:f0+64, y, x0:x0+XT] as the A operand ([f][x]) and, as the B operand,
//   one row per (c, ky, kx): x[b, c0+c, y+ky-1, x0-1+kx : x0-1+kx+XT], with
//   the SAME padding zeroed. That is the TPU kernels' lane-stacking of the
//   column taps: three shifted copies of each x row, so that every operand
//   pair of bf16 values is 4-byte aligned. Rows lie 4 words (mod 32) apart,
//   so a warp's fragment loads hit 32 banks. Eight warps split the tile into
//   2 x 4 warp tiles of 32 f x (8 c x 9 taps): 72 float32 accumulators a
//   thread.
// - float32 inputs stay in float32 (the tensor cores would round them to
//   TF32) on the SIMT cores: the same slab, staged as float32 with dy
//   transposed ([x][f]) and three x rows per channel; a thread owns 8 f x 1
//   c x 9 taps = 72 accumulators, reads its 8 dy values with two 16-byte
//   broadcast loads and one new x value per row tap (a sliding window;
//   channel rows lie an odd number of words apart), then does 72 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileF = 64;   // output channels of a block
constexpr int kTileC = 32;   // input channels of a block
constexpr int kFPer = 8;     // SIMT: output channels of a thread
constexpr int kMaxXT = 64;   // columns of a slab
constexpr int kDyStride = kTileF + 4;  // SIMT: floats per staged dy column
// tensor cores: bf16 elements per staged row (A: one f, B: one (c, ky, kx));
// XT + 8 puts consecutive rows 4 words apart modulo 32 banks
constexpr int kRowPad = 8;
constexpr int kTaps = 9;

__host__ __device__ inline int slab_cols(int W) {
  return W < kMaxXT ? W : kMaxXT;
}

// floats between two staged x channels: 3 rows of XT + 2 columns, odd
__host__ __device__ inline int xs_stride(int xt) { return (3 * (xt + 2)) | 1; }

inline size_t smem_bytes(int W) {
  const int xt = slab_cols(W);
  return sizeof(float) * ((size_t)xt * kDyStride +
                          (size_t)kTileC * xs_stride(xt));
}

inline size_t smem_bytes_mma(int W) {
  return sizeof(__nv_bfloat16) * (size_t)(kTileF + kTileC * kTaps) *
         (slab_cols(W) + kRowPad);
}

// x [B, C, H, W], dy [B, F, H, W]; partial [splits, F, C, 9]. Block
// (tile, split): tile = fi * nct + ci. The float32 (SIMT) form.
__global__ void __launch_bounds__(kThreads, 2)
dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partial, int B, int C, int H, int W,
                  int F, int nct, long long slabs, long long chunk) {
  extern __shared__ float4 smem4[];
  float* dys = reinterpret_cast<float*>(smem4);
  const int xt = slab_cols(W);
  const int ncols = W / xt;
  const int xw = xt + 2;
  const int xstride = xs_stride(xt);
  float* xs = dys + xt * kDyStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int fg = tid >> 5;
  const int f0 = (blockIdx.x / nct) * kTileF;
  const int c0 = (blockIdx.x % nct) * kTileC;
  const int split = blockIdx.y;
  const long long s_begin = (long long)split * chunk;
  long long s_end = s_begin + chunk;
  if (s_end > slabs) s_end = slabs;

  float acc[kFPer][9];
#pragma unroll
  for (int i = 0; i < kFPer; ++i)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[i][t] = 0.0f;

  const long long HW = (long long)H * W;
  for (long long s = s_begin; s < s_end; ++s) {
    const long long row = s / ncols;          // b * H + y
    const int x0 = (int)(s - row * ncols) * xt;
    const int b = (int)(row / H);
    const int y = (int)(row - (long long)b * H);
    __syncthreads();  // the previous slab's readers are done
    // dy[b, f0 + f, y, x0 + j] -> dys[j][f]
    for (int idx = tid; idx < kTileF * xt; idx += kThreads) {
      const int f = idx / xt;
      const int j = idx - f * xt;
      float v = 0.0f;
      if (f0 + f < F)
        v = dy[((long long)b * F + f0 + f) * HW + (long long)y * W + x0 + j];
      dys[j * kDyStride + f] = v;
    }
    // x[b, c0 + c, y + ky - 1, x0 + j - 1] -> xs[c][ky][j], zero outside
    for (int idx = tid; idx < kTileC * 3 * xw; idx += kThreads) {
      const int c = idx / (3 * xw);
      const int r = idx - c * 3 * xw;
      const int ky = r / xw;
      const int j = r - ky * xw;
      const int gy = y + ky - 1;
      const int gx = x0 + j - 1;
      float v = 0.0f;
      if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[((long long)b * C + c0 + c) * HW + (long long)gy * W + gx];
      xs[c * xstride + ky * xw + j] = v;
    }
    __syncthreads();

    const float* xc = xs + lane * xstride;
    const float* dcol = dys + fg * kFPer;
    float w[3][3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      w[ky][0] = xc[ky * xw];
      w[ky][1] = xc[ky * xw + 1];
    }
#pragma unroll 4
    for (int j = 0; j < xt; ++j) {
      const float4 d0 = *reinterpret_cast<const float4*>(dcol + j * kDyStride);
      const float4 d1 =
          *reinterpret_cast<const float4*>(dcol + j * kDyStride + 4);
      const float d[kFPer] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) w[ky][2] = xc[ky * xw + j + 2];
#pragma unroll
      for (int i = 0; i < kFPer; ++i)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            acc[i][ky * 3 + kx] = fmaf(d[i], w[ky][kx], acc[i][ky * 3 + kx]);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        w[ky][0] = w[ky][1];
        w[ky][1] = w[ky][2];
      }
    }
  }

  const int c = c0 + lane;
  if (c >= C) return;
  float* out = partial + (long long)split * F * C * 9;
#pragma unroll
  for (int i = 0; i < kFPer; ++i) {
    const int f = f0 + fg * kFPer + i;
    if (f < F) {
      float* o = out + ((long long)f * C + c) * 9;
#pragma unroll
      for (int t = 0; t < 9; ++t) o[t] = acc[i][t];
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bfloat16 (tensor-core) form of dw_partial_kernel: the same blocks,
// slabs and partial layout. Warp w owns f rows [32 (w & 1), +32) and the
// block's columns n = c * 9 + tap for c in [8 (w >> 1), +8): 2 x 9
// m16n8 accumulator tiles.
__global__ void __launch_bounds__(kThreads, 2)
dw_partial_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ dy,
                      float* __restrict__ partial, int B, int C, int H, int W,
                      int F, int nct, long long slabs, long long chunk) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int xt = slab_cols(W);
  const int ncols = W / xt;
  const int rs = xt + kRowPad;            // elements per staged row
  __nv_bfloat16* bs = as + kTileF * rs;   // [c * 9 + ky * 3 + kx][j]
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp & 1) * 32;         // warp's first f row
  const int wn = (warp >> 1) * 8 * kTaps; // warp's first column
  const int f0 = (blockIdx.x / nct) * kTileF;
  const int c0 = (blockIdx.x % nct) * kTileC;
  const int split = blockIdx.y;
  const long long s_begin = (long long)split * chunk;
  long long s_end = s_begin + chunk;
  if (s_end > slabs) s_end = slabs;

  float acc[2][kTaps][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const long long HW = (long long)H * W;
  const int half = xt / 2;
  for (long long s = s_begin; s < s_end; ++s) {
    const long long row = s / ncols;          // b * H + y
    const int x0 = (int)(s - row * ncols) * xt;
    const int b = (int)(row / H);
    const int y = (int)(row - (long long)b * H);
    __syncthreads();  // the previous slab's readers are done
    // A: dy[b, f0 + f, y, x0 + j] -> as[f][j]
    for (int idx = tid; idx < kTileF * xt; idx += kThreads) {
      const int f = idx / xt;
      const int j = idx - f * xt;
      as[f * rs + j] = f0 + f < F
          ? dy[((long long)b * F + f0 + f) * HW + (long long)y * W + x0 + j]
          : zero;
    }
    // B: per (c, ky) and column pair j = 2p, the four x values at columns
    // x0 + j - 1 .. x0 + j + 2 give the pairs of the three kx rows
    for (int idx = tid; idx < kTileC * 3 * half; idx += kThreads) {
      const int c = idx / (3 * half);
      const int r = idx - c * 3 * half;
      const int ky = r / half;
      const int j = 2 * (r - ky * half);
      const int gy = y + ky - 1;
      __nv_bfloat16 v[4];
      const bool live = c0 + c < C && gy >= 0 && gy < H;
      const __nv_bfloat16* src =
          x + ((long long)b * C + c0 + c) * HW + (long long)gy * W;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gx = x0 + j - 1 + i;
        v[i] = live && gx >= 0 && gx < W ? src[gx] : zero;
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          bs + ((c * 3 + ky) * 3) * rs + j);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        dst[kx * rs / 2] = pack_bf16(v[kx], v[kx + 1]);
    }
    __syncthreads();

    for (int k0 = 0; k0 < xt; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ar = as + (wm + mt * 16 + g) * rs + k0 + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ar);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * rs);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * rs + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kTaps; ++nt) {
        const __nv_bfloat16* br = bs + (wn + nt * 8 + g) * rs + k0 + 2 * t;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(br);
        bf[1] = *reinterpret_cast<const uint32_t*>(br + 8);
        mma_bf16(acc[0][nt], a[0], bf);
        mma_bf16(acc[1][nt], a[1], bf);
      }
    }
  }

  // accumulator (mt, nt, r): f row wm + 16 mt + g + 8 (r >> 1), column
  // n = wn + 8 nt + 2 t + (r & 1) = c * 9 + tap of the block's tile
  float* out = partial + (long long)split * F * C * kTaps;
  const int cols = C * kTaps;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTaps; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int f = f0 + wm + mt * 16 + g + 8 * (r >> 1);
        const int n = wn + nt * 8 + 2 * t + (r & 1);
        if (f < F && c0 + n / kTaps < C)
          out[(long long)f * cols + c0 * kTaps + n] = acc[mt][nt][r];
      }
}

// out[i] = sum over splits of partial[s][i], in split order.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 long long n, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + i];
  out[i] = s;
}

// The partial kernel of the input type, then the fixed-order sum.
cudaError_t launch(const void* x, const void* dy, float* partial, float* out,
                   int B, int C, int H, int W, int F, int splits, bool bf16,
                   cudaStream_t st) {
  const int nft = (F + kTileF - 1) / kTileF;
  const int nct = (C + kTileC - 1) / kTileC;
  const long long slabs = (long long)B * H * (W / slab_cols(W));
  const long long chunk = (slabs + splits - 1) / splits;
  const dim3 grid(nft * nct, splits);
  cudaError_t e;
  if (bf16) {
    const size_t smem = smem_bytes_mma(W);
    e = cudaFuncSetAttribute(dw_partial_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dw_partial_mma_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), partial, B, C, H, W, F, nct,
        slabs, chunk);
  } else {
    const size_t smem = smem_bytes(W);
    e = cudaFuncSetAttribute(dw_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dw_partial_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), partial,
        B, C, H, W, F, nct, slabs, chunk);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)F * C * 9;
  dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(partial, out, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W] and dy [B, F, H, W] of one type (dtype 0 float32, 1
// bfloat16), contiguous; W a multiple of min(W, 128). partial: float32
// scratch of splits * F * C * 9; out [F, C, 3, 3] float32. On `device`;
// `stream` is a cudaStream_t of that device. Returns the CUDA error code
// of the launches (0 = success).
int conv3x3_dw(const void* x, const void* dy, void* partial, void* out,
               int B, int C, int H, int W, int F, int splits, int dtype,
               int device, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || F <= 0 || splits <= 0 ||
      W % slab_cols(W) != 0)
    return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  cudaError_t se = cudaSetDevice(device);
  if (se != cudaSuccess) return (int)se;
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)launch(x, dy, pf, of, B, C, H, W, F, splits, dtype == 1, st);
}

}  // extern "C"
