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
// At the flagship's bf16 shapes, against an H100 SXM's peaks at 700 W (989
// TFLOP/s bf16, 3.35 TB/s): x [32,64,64,64] with F = 128 is bound by its
// operations (19.3 GFLOP, 0.0195 ms), with F = 64 by its bytes (x and dy
// read once, 33.6 MB, 0.0101 ms), and x [32,64,128,128] with F = 64 by its
// bytes (134 MB, 0.0401 ms). The split-K partials add splits x F x C x 9
// float32 written once and read once by the fixed-order sum: about 19 MB
// each way at all three shapes (0.011 ms more). Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (tools/bench_conv_dw_torch.py --profile): 41-42, 26-27
// and 71-75 us of device time per call plus 5-7 us for the sum, against
// cuDNN's 94, 68 and 227 us for the same weight gradients; PERF.md has the
// runs.
//
// The bfloat16 body (dw_wgmma_kernel), and what it does about each limit
// of the first port (an mma.sync kernel that thread-staged its operands):
// - Scalar 2-byte global loads -> no thread loads an operand from global
//   memory. One producer thread issues TMA loads through two tensor maps
//   built per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so no -lcuda): the dy tile [64 f][KT x] at
//   (x0, y, f0, b), 128B-swizzled (64B at W = 32, where a K-step is 32
//   columns) as the K-major operand wgmma reads, and each x row as a staged
//   box [64 c][KT + 16 x] at (x0 - 8, row, 0, b). TMA zero-fills whatever
//   lies outside the tensor: the SAME padding, the image edges, c >= C and
//   f >= F cost no instruction. A box must start at a column that is a
//   multiple of 8 bf16 (16 bytes; a column of 1 is an illegal instruction),
//   so TMA cannot cut the +-1 column taps itself: three producer warps
//   shift each staged row into its three swizzled kx tiles (16-byte shared
//   loads, funnel shifts, 16-byte stores).
// - No overlap between loads and math -> mbarrier rings: 5 dy tiles, 6
//   staged rows, 5 x rows of three kx tiles. The loads run ahead of the
//   shifting, the shifting ahead of the products, and each consumer
//   releases a step's slots only when its next step's wgmma group is in
//   flight (wgmma.wait_group 1), so products overlap the next waits.
// - A short inner loop -> a K-step is still one 64-column row segment, but
//   it is 4 wgmma m64n192k16 per warpgroup with no block barrier.
// - Redundant reads -> a block owns 64 f x all 64 c x 9 taps, so dy is read
//   once per f tile; each x row is loaded and shifted once per run of rows
//   and read by all three ky warpgroups (the dy rows below, at and above
//   it): x crosses from L2 once per f tile, plus two rows at each run
//   start.
// - The old instructions -> wgmma m64n192k16 (bf16 in, float32
//   accumulators): three consumer warpgroups, one per ky, each multiply the
//   dy tile by the three kx tiles of x row y-1+ky (contiguous in shared
//   memory: one N = 192 operand). 96 accumulators a thread. Registers are
//   allocated per SM sub-partition, four warps each, so the producer is a
//   whole warpgroup that gives registers back (setmaxnreg 56) for the
//   consumers to take 152.
// Hopper's blocks run in no order, so the TPU's sequential carry becomes
// split-K: block (f tile, split) owns a contiguous run of K-steps (about
// one block per SM) and writes its float32 partial tile, [F][9][C], to a
// scratch that a second kernel sums in a fixed order: no atomics, the same
// bits on every call.
// The float32 body stays on the SIMT cores (the tensor cores would round
// float32 to TF32): see dw_partial_kernel. It is not redesigned yet.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileF = 64;   // SIMT: output channels of a block
constexpr int kTileC = 32;   // SIMT: input channels of a block
constexpr int kFPer = 8;     // SIMT: output channels of a thread
constexpr int kMaxXT = 64;   // columns of a slab (a K-step)
constexpr int kDyStride = kTileF + 4;  // SIMT: floats per staged dy column
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

// The float32 body: x [B, C, H, W], dy [B, F, H, W]; partial [splits, F,
// 9, C]. Block (tile, split), tile = fi * nct + ci, over the same K-steps
// as the bf16 body. A K-step is staged by the block's threads as float32,
// dy transposed ([x][f]) and three x rows per channel (zero outside the
// image); a thread owns 8 f x 1 c x 9 taps = 72 accumulators, reads its 8
// dy values with two 16-byte broadcast loads and one new x value per row
// tap (a sliding window; channel rows lie an odd number of words apart),
// then does 72 FMAs.
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
      float* o = out + (long long)f * 9 * C + c;
#pragma unroll
      for (int t = 0; t < 9; ++t) o[t * C] = acc[i][t];
    }
  }
}

// out[f][c][tap] = sum over splits of partial[s][f][tap][c], in split order.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int C, long long n, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + i];
  const long long ft = i / C;  // f * 9 + tap
  const int c = (int)(i - ft * C);
  const long long f = ft / kTaps;
  out[(f * C + c) * kTaps + (ft - f * kTaps)] = s;
}

// ---------------------------------------------------------------------------
// The bfloat16 body: TMA + wgmma.

constexpr int kBoxRows = 64;                 // f rows of a dy box, c of an x box
constexpr int kConsumers = 3;                // warpgroups, one per ky
constexpr int kConsumerWarps = 4 * kConsumers;
// + a producer warpgroup: registers are allocated per SM sub-partition, four
// warps each, so a lone producer warp would cap every thread at 128
constexpr int kRingThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 56, kConsumerRegs = 152;  // 3 x 152 + 56 <= 512
constexpr int kDyStages = 5;
constexpr int kXSlots = 5;    // x rows as three swizzled kx tiles
constexpr int kStages = 6;    // x rows as landed by TMA
constexpr int kShifters = 96;  // producer threads that shift x rows
constexpr int kAcc = 96;                     // m64n192 float32 accumulators
constexpr long long kSpinLimit = 1LL << 22;  // a wait this long is a fault

template <int KT>
struct WgmmaTile {
  static constexpr int kBox = kBoxRows * KT * 2;  // bytes of one operand tile
  static constexpr int kRow = (KT + 16) * 2;      // bytes of a staged x row
  static constexpr int kStage = kBoxRows * kRow;  // bytes of a staged x box
  static constexpr uint32_t kSbo = 8 * KT * 2;    // bytes per 8 rows
  static constexpr uint64_t kLayout = KT == 64 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int kSwizzle = KT == 64 ? 7 : 3;      // 16-byte chunk XOR
  static constexpr size_t kSmem =
      1024 + (size_t)kBox * (kDyStages + 3 * kXSlots) +
      (size_t)kStage * kStages + 16 * (kDyStages + kXSlots + kStages);
};

static_assert(WgmmaTile<64>::kSmem <= 232448,
              "the ring exceeds a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity; a wait
// that never ends traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

// TMA: the box of `map` at (c0 innermost .. c3) into shared memory, counted
// on `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major swizzled tile: start address,
// leading offset 1 (unused when swizzled), stride between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 192] += A[64 x 16] B[192 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_n192(float (&d)[kAcc], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// One K-step of a consumer warpgroup, issued as one wgmma group: acc +=
// dy tile [64 f x KT] times the three kx tiles [3 x 64 c x KT] at b_addr.
template <int KT>
__device__ __forceinline__ void mma_issue(float (&acc)[kAcc], uint32_t a_addr,
                                          uint32_t b_addr) {
  using T = WgmmaTile<KT>;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < KT / 16; ++k)  // 16 bf16 = 32 bytes along K
    wgmma_n192(acc, smem_desc(a_addr + 32 * k, T::kSbo, T::kLayout),
               smem_desc(b_addr + 32 * k, T::kSbo, T::kLayout));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(acc);
}

// Wait until at most N wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void mma_wait(float (&acc)[kAcc]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(acc);
}

// Accumulator i of thread t of warpgroup ky: row f0 + 16 (t / 32) + (t % 32)
// / 4 + 8 ((i % 4) / 2), column n = 8 (i / 4) + 2 (t % 4) + i % 2 = 64 kx +
// c. The partial is [F][9 taps][C] of this block's split: four lanes write
// 32 contiguous bytes of a row.
__device__ __forceinline__ void store_partial(const float (&acc)[kAcc],
                                              float* out, int f0, int ky,
                                              int C, int F) {
  const int t = threadIdx.x % 128;
  const int row = f0 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int tap = ky * 3 + j / 8;
    const int c = (j % 8) * 8 + 2 * (t % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = row + 8 * h;
      if (f >= F || c >= C) continue;
      float* o = out + ((long long)f * kTaps + tap) * C + c;
      if ((C & 1) == 0)  // c even, so c + 1 < C and o 8-byte aligned
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else {
        o[0] = acc[4 * j + 2 * h];
        if (c + 1 < C) o[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// Builds the three kx tiles [64 c][KT] of one x row, K-major and swizzled
// as TMA would have swizzled them, from its staged copy [64 c][KT + 16],
// which starts 8 columns left of the slab: tile kx, column k is staged
// column k + kx + 7. (TMA cannot start a box at a column that is not a
// multiple of 8 bf16, so the +-1 column shifts of kx = 0, 2 are made here.)
// Thread t of n takes the 16-byte chunk pairs (j, j + 1) of rows c, (c,
// j / 2) = t, t + n, ...: four loads, eight funnel shifts per shifted
// tile, six stores.
template <int KT>
__device__ __forceinline__ void shift_taps(const uint8_t* stage,
                                           uint8_t* tiles, int t, int n) {
  using T = WgmmaTile<KT>;
  constexpr int kPairs = KT / 16;  // pairs of 16-byte chunks of a tile row
#pragma unroll 2
  for (int q = t; q < kBoxRows * kPairs; q += n) {
    const int j = 2 * (q % kPairs), c = q / kPairs;
    const uint4* src = reinterpret_cast<const uint4*>(stage + c * T::kRow) + j;
    uint4 w[4];  // staged elements 8j .. 8j + 31
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = src[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // chunk j + h of each tile
      const uint4 a = w[h], m = w[h + 1], z = w[h + 2];
      uint4 lo, hi;  // staged 8(j+h) + 7 .. +14 and 8(j+h) + 9 .. +16
      lo.x = __funnelshift_r(a.w, m.x, 16);
      lo.y = __funnelshift_r(m.x, m.y, 16);
      lo.z = __funnelshift_r(m.y, m.z, 16);
      lo.w = __funnelshift_r(m.z, m.w, 16);
      hi.x = __funnelshift_r(m.x, m.y, 16);
      hi.y = __funnelshift_r(m.y, m.z, 16);
      hi.z = __funnelshift_r(m.z, m.w, 16);
      hi.w = __funnelshift_r(m.w, z.x, 16);
      const int at = c * KT * 2 + 16 * (j + h);
      uint8_t* dst = tiles + (at ^ (((at >> 7) & T::kSwizzle) << 4));
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + T::kBox) = m;
      *reinterpret_cast<uint4*>(dst + 2 * T::kBox) = hi;
    }
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// x [B, C, H, W] and dy [B, F, H, W] bf16 through their tensor maps;
// partial [splits, F, 9, C]. Block (f tile, split); K-step s = (g, y), g =
// b * nslab + column slab, y fastest; split `blockIdx.y` owns K-steps
// [chunk * split, +chunk). Warps 0-11 are the consumer warpgroups (ky =
// warp / 4), warpgroup 3 the producer: one thread issues the TMA loads
// (dy tiles and staged x rows, in K order), three warps turn each landed x
// row into its three kx tiles. x rows outside the image contribute
// nothing: they are neither loaded nor multiplied.
template <int KT>
__global__ void __launch_bounds__(kRingThreads, 1)
dw_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                __grid_constant__ const CUtensorMap dymap,
                float* __restrict__ partial, int C, int H, int F, int nslab,
                int steps, int chunk) {
  using T = WgmmaTile<KT>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* dys = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = dys + kDyStages * T::kBox;       // [kXSlots][3 kx][tile]
  uint8_t* stage = xs + 3 * kXSlots * T::kBox;   // [kStages][staged row]
  uint64_t* dy_full = reinterpret_cast<uint64_t*>(stage + kStages * T::kStage);
  uint64_t* dy_empty = dy_full + kDyStages;
  uint64_t* x_full = dy_empty + kDyStages;
  uint64_t* x_empty = x_full + kXSlots;
  uint64_t* st_full = x_empty + kXSlots;
  uint64_t* st_empty = st_full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDyStages; ++i) {
      mbar_init(&dy_full[i], 1);
      mbar_init(&dy_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&st_full[i], 1);
      mbar_init(&st_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int f0 = blockIdx.x * kBoxRows;
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(steps, s_begin + chunk);

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps) {  // the loads, from one thread
      if (lane != 0) return;
      int dq = 0, xq = 0;  // dy tiles, x rows issued
      for (int s = s_begin; s < s_end;) {
        const int g = s / H, y0 = s - g * H, n = min(s_end - s, H - y0);
        const int b = g / nslab, x0 = (g - b * nslab) * KT;
        // a run: x rows y0-1 .. y0+n, dy rows y0 .. y0+n-1, each dy row
        // after the x rows its ky = 0, 1 warpgroups read and before the
        // one its ky = 2 warpgroup reads
        for (int i = -2; i < n; ++i) {
          if (i >= 0) {
            const int slot = dq % kDyStages, round = dq / kDyStages;
            if (round > 0) mbar_wait(&dy_empty[slot], (round - 1) & 1);
            mbar_expect_tx(&dy_full[slot], T::kBox);
            tma_load(dys + slot * T::kBox, &dymap, &dy_full[slot], x0,
                     y0 + i, f0, b);
            ++dq;
          }
          const int row = y0 + i + 1;
          if (row < 0 || row >= H) continue;
          const int st = xq % kStages, round = xq / kStages;
          if (round > 0) mbar_wait(&st_empty[st], (round - 1) & 1);
          mbar_expect_tx(&st_full[st], T::kStage);
          tma_load(stage + st * T::kStage, &xmap, &st_full[st], x0 - 8, row,
                   0, b);
          ++xq;
        }
        s += n;
      }
    } else {  // the shifters: each landed x row into its slot, in order
      const int t = threadIdx.x - 128 * kConsumers - 32;
      int q = 0;
      for (int s = s_begin; s < s_end;) {
        const int g = s / H, y0 = s - g * H, n = min(s_end - s, H - y0);
        for (int row = max(y0 - 1, 0); row <= min(y0 + n, H - 1); ++row) {
          const int st = q % kStages, slot = q % kXSlots;
          mbar_wait(&st_full[st], (q / kStages) & 1);
          if (q >= kXSlots) mbar_wait(&x_empty[slot], (q / kXSlots - 1) & 1);
          shift_taps<KT>(stage + st * T::kStage, xs + 3 * slot * T::kBox, t,
                         kShifters);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_sync(1, kShifters);  // the slot written, the staged row read
          if (t == 0) {
            mbar_arrive(&st_empty[st]);
            mbar_arrive(&x_full[slot]);
          }
          ++q;
        }
        s += n;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ky = warp / 4;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    int dq = 0, xq = 0;  // loads consumed so far
    // an x slot this warpgroup does not read: wait for it and release it,
    // so that every slot sees every consumer warp once per fill
    auto skip_x = [&]() {
      const int slot = xq % kXSlots;
      mbar_wait(&x_full[slot], (xq / kXSlots) & 1);
      if (lane == 0) mbar_arrive(&x_empty[slot]);
      ++xq;
    };
    // the slots of the wgmma group in flight, released once it completes:
    // a step's products overlap the next step's waits and issue
    int busy_dy = -1, busy_x = -1;
    auto release = [&]() {
      if (busy_dy >= 0 && lane == 0) {
        mbar_arrive(&dy_empty[busy_dy]);
        mbar_arrive(&x_empty[busy_x]);
      }
      busy_dy = -1;
    };
    // Only the waits for the next product's operands may hold a group in
    // flight: the producer fills those slots without waiting for it. Any
    // other wait (a slot this warpgroup skips, a dy row without its x row)
    // first completes the group and frees its slots.
    auto drain = [&]() {
      mma_wait<0>(acc);
      release();
    };
    for (int s = s_begin; s < s_end;) {
      const int g = s / H, y0 = s - g * H, n = min(s_end - s, H - y0);
      for (int r = y0 - 1; r < y0 - 1 + ky; ++r)
        if (r >= 0 && r < H) skip_x();
      for (int i = 0; i < n; ++i) {  // dy row y0 + i, x row y0 + i - 1 + ky
        const int ds = dq % kDyStages;
        const int r = y0 + i - 1 + ky;
        if (r < 0 || r >= H) drain();
        mbar_wait(&dy_full[ds], (dq / kDyStages) & 1);
        if (r >= 0 && r < H) {
          const int xsl = xq % kXSlots;
          mbar_wait(&x_full[xsl], (xq / kXSlots) & 1);
          mma_issue<KT>(acc, smem_u32(dys + ds * T::kBox),
                        smem_u32(xs + 3 * xsl * T::kBox));
          mma_wait<1>(acc);  // the previous step's group is done
          release();
          busy_dy = ds;
          busy_x = xsl;
          ++xq;
        } else if (lane == 0) {
          mbar_arrive(&dy_empty[ds]);  // a row outside the image: no product
        }
        ++dq;
      }
      drain();
      for (int r = y0 + n - 1 + ky; r <= y0 + n; ++r)
        if (r >= 0 && r < H) skip_x();
      s += n;
    }
    store_partial(acc, partial + (long long)blockIdx.y * F * C * kTaps, f0,
                  ky, C, F);
  }
}

// cuTensorMapEncodeTiled from the CUDA driver, found at run time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 [B, R, H, W] tensor, boxes of `cols`
// columns x 1 row x 64 of R x 1 image, swizzled for wgmma (or not).
bool make_map(CUtensorMap* map, const void* base, int B, int R, int H, int W,
              int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)R,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * W, 2ull * W * H, 2ull * W * H * R};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KT>
cudaError_t launch_wgmma(const CUtensorMap& xm, const CUtensorMap& dm,
                         float* partial, int C, int H, int F, int nslab,
                         int steps, int chunk, dim3 grid, cudaStream_t st) {
  using T = WgmmaTile<KT>;
  static bool sized = false;  // the attribute holds for the process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_wgmma_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  dw_wgmma_kernel<KT><<<grid, kRingThreads, T::kSmem, st>>>(
      xm, dm, partial, C, H, F, nslab, steps, chunk);
  return cudaGetLastError();
}

// The partial kernel of the input type, then the fixed-order sum.
cudaError_t launch(const void* x, const void* dy, float* partial, float* out,
                   int B, int C, int H, int W, int F, int splits, int chunk,
                   bool bf16, cudaStream_t st) {
  const int kt = slab_cols(W);
  const int nslab = W / kt;
  const int steps = B * H * nslab;
  cudaError_t e;
  if (bf16) {
    CUtensorMap xm, dm;
    // dy: operand tiles as they are; x: staged rows of KT + 16 columns
    if (C > kBoxRows || (kt != 32 && kt != 64) ||
        !make_map(&xm, x, B, C, H, W, kt + 16, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&dm, dy, B, F, H, W, kt,
                  kt == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
    const dim3 grid((F + kBoxRows - 1) / kBoxRows, splits);
    e = kt == 64 ? launch_wgmma<64>(xm, dm, partial, C, H, F, nslab, steps,
                                    chunk, grid, st)
                 : launch_wgmma<32>(xm, dm, partial, C, H, F, nslab, steps,
                                    chunk, grid, st);
  } else {
    const int nct = (C + kTileC - 1) / kTileC;
    const dim3 grid(((F + kTileF - 1) / kTileF) * nct, splits);
    const size_t smem = smem_bytes(W);
    e = cudaFuncSetAttribute(dw_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dw_partial_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), partial,
        B, C, H, W, F, nct, steps, chunk);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  const long long n = (long long)F * C * kTaps;
  dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(partial, out, C, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W] and dy [B, F, H, W] of one type (dtype 0 float32, 1
// bfloat16), contiguous (bf16: 16-byte aligned, C <= 64); W a multiple of
// min(W, 64). K-steps (image row segments of min(W, 64) columns) split
// into `splits` runs of `chunk`. partial: float32 scratch of splits * F *
// C * 9; out [F, C, 3, 3] float32. On `device`; `stream` is a cudaStream_t
// of that device. Returns the CUDA error code of the launches (0 =
// success; a refused shape or tensor map is cudaErrorInvalidValue).
int conv3x3_dw(const void* x, const void* dy, void* partial, void* out,
               int B, int C, int H, int W, int F, int splits, int chunk,
               int dtype, int device, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || F <= 0 || splits <= 0 ||
      chunk <= 0 || W % slab_cols(W) != 0 ||
      (long long)splits * chunk < (long long)B * H * (W / slab_cols(W)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  cudaError_t se = cudaSetDevice(device);
  if (se != cudaSuccess) return (int)se;
  return (int)launch(x, dy, static_cast<float*>(partial),
                     static_cast<float*>(out), B, C, H, W, F, splits, chunk,
                     dtype == 1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
