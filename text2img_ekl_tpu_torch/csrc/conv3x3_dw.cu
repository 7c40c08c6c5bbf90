// Weight gradient of a 3x3 stride-1 SAME bias-free convolution (K4) for
// Hopper, sm_90a: a bfloat16 and a float32 body, both TMA + wgmma.
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
//
// The float32 body (dw_tf32x3_kernel) runs on the same ring, on the tensor
// cores, float32-faithful (3xTF32, as gemm_tf32x3.cuh's products): the
// tensor cores take float32 only as tf32 (10 stored significand bits), so
// each value v is split into hi = rna(v) and lo = rna(v - hi) (tf32.cuh)
// and each product is taken as lo.hi + hi.lo + hi.hi.
// - Layout: in NCHW, x is the innermost dimension of both dy[b, f, y, x]
//   and x[b, c, y, x]: A = the dy tile (M = f, K = x), B = the x taps (N =
//   (kx, c), K = x) are both K-major, the one layout in which wgmma takes
//   tf32 operands. A K-step is 32 columns, one 128-byte row (the 128B
//   swizzle) of a dy box [64 f][32 x]; each x row is staged as a box [32
//   c][40 x] at (x0 - 4, row, c0, b) (16-byte alignment is 4 float32
//   columns).
// - The split: the shifter warps turn a staged row into its three kx
//   tiles as before, the +-1 column shifts now whole words (no funnel
//   shifts), and write each as a hi and a lo tile: [3 kx x 32 c][32],
//   K-major, swizzled. Each consumer splits its A fragments (the dy tile's
//   rows of its warp) in registers, as gemm_tf32x3.cuh does, so A needs
//   no second shared-memory copy. (Hi and lo A tiles split once by the
//   shifters and read by the three ky warpgroups through descriptors took
//   19 % longer on an H100: more shared-memory traffic.)
// - Faithful sums: the tensor cores' float32 accumulation does not round
//   to nearest, so each 32-deep K-step goes into a fresh wgmma partial
//   (12 wgmma m64n96k8: 4 steps of 8 along K x 3 terms) that is added to
//   the running sum in IEEE float32 on the CUDA cores; the split-K partials
//   and their fixed-order sum are the bf16 body's.
// - Registers: ptxas allocates the 128 of the launch (512 threads) to the
//   consumers' code too, setmaxnreg notwithstanding: the partial and the
//   sum take 48 + 48 a thread at m64n96 and A's fragments 16 (a group of
//   three wgmma per 8 columns, the next 8 split while it runs); so a block
//   owns 64 f x 32 c x 9 taps (m64n192 would need 96 + 96). ptxas spills
//   16 bytes, the run loop's state, reloaded once a run of up to H
//   K-steps: none inside the K-step loop. One group of 12 wgmma a K-step
//   (32 fragment registers) spilled 148 bytes and took 14 % longer.
// - Rings of 4 dy tiles, 4 x slots and 4 staged rows (power-of-two
//   indices; 3 % faster than the bf16 body's 5 / 5 / 6).
// What bounds it: the tensor cores. 3 x 2 F 9C B H W tf32 operations at
// 495 TFLOP/s: 0.117, 0.059 and 0.234 ms at the flagship's three shapes,
// against 0.030, 0.020 and 0.080 ms to read x and dy once; a K-step is
// 36 wgmma m64n96k8 (~1,730 cycles of tensor-core work a block) while
// shared memory carries ~104 B a cycle of the 128 it can (B operands read
// three times, A's fragments, the shifters' reads and hi/lo writes, the
// TMA tiles). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/bench_conv_dw_torch.py --dtype float32 --profile): 182, 93 and
// 355 us of device time per call plus 4 us for the sum, 1.56-1.80x the
// bound, against cuDNN's float32 wgrad with TF32 off at 362, 392 and
// 1,479 us; each warpgroup's tensor-core queue drains once a K-step, while
// it adds the partial to its sum and splits the next K-step's A.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kReduceThreads = 256;
constexpr int kMaxXT = 64;   // bf16: columns of a K-step
constexpr int kTaps = 9;

// Columns of a K-step: an image row segment of min(W, 64) bf16 or 32
// float32 columns (one 128-byte row of a swizzled operand tile either way,
// or 64 bytes at W = 32 in bf16).
__host__ __device__ inline int step_cols(int W, bool bf16) {
  return bf16 ? (W < kMaxXT ? W : kMaxXT) : 32;
}

// out[f][c][tap] = sum over splits of partial[s][f][tap][c], in split order.
__global__ void __launch_bounds__(kReduceThreads)
dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                 int C, long long n, int splits) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
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
// The ring both bodies share: TMA loads, mbarriers, the producer warpgroup.

constexpr int kBoxRows = 64;                 // f rows of a dy box, c of an x box
constexpr int kConsumers = 3;                // warpgroups, one per ky
constexpr int kConsumerWarps = 4 * kConsumers;
// + a producer warpgroup: registers are allocated per SM sub-partition, four
// warps each, so a lone producer warp would cap every thread at 128
constexpr int kRingThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 56, kConsumerRegs = 152;  // 3 x 152 + 56 <= 512
constexpr int kShifters = 96;  // producer threads that shift x rows
constexpr int kSpinLimit = 1 << 22;  // a wait this long is a fault

// bf16: a block owns 64 f x all (<= 64) c; KT columns a K-step
// Each body's ring: kDyStages dy tiles, kXSlots x rows as their kx tiles,
// kStages x rows as landed by TMA.
template <int KT>
struct WgmmaTile {
  static constexpr int kDyStages = 5, kXSlots = 5, kStages = 6;
  static constexpr int kCols = KT;
  static constexpr int kPad = 8;                  // staged columns left of x0
  static constexpr int kBox = kBoxRows * KT * 2;  // bytes of one operand tile
  static constexpr int kDy = kBox;
  static constexpr int kSlot = 3 * kBox;          // the three kx tiles
  static constexpr int kRow = (KT + 16) * 2;      // bytes of a staged x row
  static constexpr int kStage = kBoxRows * kRow;  // bytes of a staged x box
  static constexpr uint32_t kSbo = 8 * KT * 2;    // bytes per 8 rows
  static constexpr uint64_t kLayout = KT == 64 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int kSwizzle = KT == 64 ? 7 : 3;      // 16-byte chunk XOR
  static constexpr int kAcc = 96;                 // m64n192 accumulators
  static constexpr size_t kSmem =
      1024 + (size_t)kBox * (kDyStages + 3 * kXSlots) +
      (size_t)kStage * kStages + 16 * (kDyStages + kXSlots + kStages);
};

// float32: a block owns 64 f x 32 c; a K-step is 32 columns (128 bytes)
struct Tf32Tile {
  // power-of-two depths: 4 % faster than 5 / 5 / 6 on an H100
  static constexpr int kDyStages = 4, kXSlots = 4, kStages = 4;
  static constexpr int kCols = 32;
  static constexpr int kPad = 4;
  static constexpr int kTileC = 32;
  static constexpr int kN = 3 * kTileC;           // wgmma N: 3 kx x 32 c
  static constexpr int kDy = kBoxRows * kCols * 4;
  static constexpr int kTaps = kN * kCols * 4;    // hi (or lo) kx tiles
  static constexpr int kSlot = 2 * kTaps;         // hi, then lo
  static constexpr int kRow = (kCols + 8) * 4;    // bytes of a staged x row
  static constexpr int kStage = kTileC * kRow;
  static constexpr int kAcc = kN / 2;             // m64n96 accumulators
  static constexpr size_t kSmem =
      1024 + (size_t)kDy * kDyStages + (size_t)kSlot * kXSlots +
      (size_t)kStage * kStages + 16 * (kDyStages + kXSlots + kStages);
};

static_assert(WgmmaTile<64>::kSmem <= 232448 && Tf32Tile::kSmem <= 232448,
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
  for (int spin = 0;; ++spin) {
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

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The shared memory of a ring: dy tiles, x slots, staged x rows, barriers.
struct Ring {
  uint8_t *dys, *xs, *stage;
  uint64_t *dy_full, *dy_empty, *x_full, *x_empty, *st_full, *st_empty;
};

template <class T>
__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  Ring r;
  // the swizzled tiles need 1024-byte alignment
  r.dys = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  r.xs = r.dys + T::kDyStages * T::kDy;    // [kXSlots][slot]
  r.stage = r.xs + T::kXSlots * T::kSlot;  // [kStages][staged row]
  r.dy_full = reinterpret_cast<uint64_t*>(r.stage + T::kStages * T::kStage);
  r.dy_empty = r.dy_full + T::kDyStages;
  r.x_full = r.dy_empty + T::kDyStages;
  r.x_empty = r.x_full + T::kXSlots;
  r.st_full = r.x_empty + T::kXSlots;
  r.st_empty = r.st_full + T::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kDyStages; ++i) {
      mbar_init(&r.dy_full[i], 1);
      mbar_init(&r.dy_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < T::kXSlots; ++i) {
      mbar_init(&r.x_full[i], 1);
      mbar_init(&r.x_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(&r.st_full[i], 1);
      mbar_init(&r.st_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The K-steps [s_begin, s_end) of a block as runs down an image column
// slab: K-step s = (g, y), g = b * nslab + slab, y fastest; fn(b, x0, y0,
// n) for each run of the n dy rows y0 .. y0 + n - 1 at columns x0 ..
template <int kCols, class Fn>
__device__ __forceinline__ void for_runs(int s_begin, int s_end, int H,
                                         int nslab, Fn fn) {
  for (int s = s_begin; s < s_end;) {
    const int g = s / H, y0 = s - g * H, n = min(s_end - s, H - y0);
    const int b = g / nslab;
    fn(b, (g - b * nslab) * kCols, y0, n);
    s += n;
  }
}

// The producer warpgroup: one thread issues the TMA loads (dy tiles and
// staged x rows, in K order), three warps turn each landed x row into its
// slot with shift(staged row, slot, thread, threads). x rows outside the
// image are neither loaded nor multiplied.
template <class T, class Shift>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* xmap,
                                        const CUtensorMap* dymap, int f0,
                                        int c0, int H, int nslab, int s_begin,
                                        int s_end, Shift shift) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {  // the loads, from one thread
    if (lane != 0) return;
    int dq = 0, xq = 0;  // dy tiles, x rows issued
    for_runs<T::kCols>(s_begin, s_end, H, nslab, [&](int b, int x0, int y0,
                                                     int n) {
      // a run: x rows y0-1 .. y0+n, dy rows y0 .. y0+n-1, each dy row
      // after the x rows its ky = 0, 1 warpgroups read and before the one
      // its ky = 2 warpgroup reads
      for (int i = -2; i < n; ++i) {
        if (i >= 0) {
          const int slot = dq % T::kDyStages, round = dq / T::kDyStages;
          if (round > 0) mbar_wait(&r.dy_empty[slot], (round - 1) & 1);
          mbar_expect_tx(&r.dy_full[slot], T::kDy);
          tma_load(r.dys + slot * T::kDy, dymap, &r.dy_full[slot], x0, y0 + i,
                   f0, b);
          ++dq;
        }
        const int row = y0 + i + 1;
        if (row < 0 || row >= H) continue;
        const int st = xq % T::kStages, round = xq / T::kStages;
        if (round > 0) mbar_wait(&r.st_empty[st], (round - 1) & 1);
        mbar_expect_tx(&r.st_full[st], T::kStage);
        tma_load(r.stage + st * T::kStage, xmap, &r.st_full[st],
                 x0 - T::kPad, row, c0, b);
        ++xq;
      }
    });
  } else {  // the shifters: each landed x row into its slot, in order
    const int t = threadIdx.x - 128 * kConsumers - 32;
    int q = 0;
    for_runs<T::kCols>(s_begin, s_end, H, nslab, [&](int, int, int y0,
                                                     int n) {
      for (int row = max(y0 - 1, 0); row <= min(y0 + n, H - 1); ++row) {
        const int st = q % T::kStages, slot = q % T::kXSlots;
        mbar_wait(&r.st_full[st], (q / T::kStages) & 1);
        if (q >= T::kXSlots)
          mbar_wait(&r.x_empty[slot], (q / T::kXSlots - 1) & 1);
        shift(r.stage + st * T::kStage, r.xs + slot * T::kSlot, t, kShifters);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1, kShifters);  // the slot written, the staged row read
        if (t == 0) {
          mbar_arrive(&r.st_empty[st]);
          mbar_arrive(&r.x_full[slot]);
        }
        ++q;
      }
    });
  }
}

// A consumer warpgroup's walk over the block's K-steps: step(dy stage, x
// slot) multiplies dy row y by x row y - 1 + ky and releases both slots,
// at once or later; before_outside() runs before any other wait (a dy row
// whose x row lies outside the image, the rows a run skips), so that a
// deferred release cannot hold a slot the producer waits for. Every
// consumer warp arrives once at every dy tile and x slot.
template <class T, class Step, class Before>
__device__ __forceinline__ void consume(const Ring& r, int ky, int H,
                                        int s_begin, int s_end,
                                        Before before_outside, Step step) {
  const int lane = threadIdx.x % 32;
  int xq = 0;  // x rows consumed so far
  auto skip_x = [&]() {
    const int slot = xq % T::kXSlots;
    mbar_wait(&r.x_full[slot], (xq / T::kXSlots) & 1);
    if (lane == 0) mbar_arrive(&r.x_empty[slot]);
    ++xq;
  };
  // for_runs's walk, with the count of dy rows consumed as its counter
  for (int dq = 0; dq < s_end - s_begin;) {
    const int s = s_begin + dq, g = s / H, y0 = s - g * H;
    const int n = min(s_end - s, H - y0);
    for (int row = y0 - 1; row < y0 - 1 + ky; ++row)
      if (row >= 0 && row < H) skip_x();
    for (int y = y0; y < y0 + n; ++y, ++dq) {  // dy row y, x row y - 1 + ky
      const int ds = dq % T::kDyStages;
      const int row = y - 1 + ky;
      const bool inside = row >= 0 && row < H;
      if (!inside) before_outside();
      mbar_wait(&r.dy_full[ds], (dq / T::kDyStages) & 1);
      if (inside) {
        const int xsl = xq % T::kXSlots;
        mbar_wait(&r.x_full[xsl], (xq / T::kXSlots) & 1);
        step(ds, xsl);
        ++xq;
      } else if (lane == 0) {
        mbar_arrive(&r.dy_empty[ds]);  // a row outside the image: no product
      }
    }
    before_outside();
    for (int row = y0 + n - 1 + ky; row <= y0 + n; ++row)
      if (row >= 0 && row < H) skip_x();
  }
}

// Accumulator i of thread t of warpgroup ky (m64nN, N = 3 x kTileC): row
// f0 + 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4) / 2), column n = 8 (i / 4) +
// 2 (t % 4) + i % 2 = kTileC kx + c - c0. The partial is [F][9 taps][C] of
// this block's split: four lanes write 32 contiguous bytes of a row.
template <int kTileC, int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N],
                                              float* out, int f0, int c0,
                                              int ky, int C, int F) {
  constexpr int kPer = kTileC / 8;  // accumulator quads per kx
  const int t = threadIdx.x % 128;
  const int row = f0 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int tap = ky * 3 + j / kPer;
    const int c = c0 + (j % kPer) * 8 + 2 * (t % 4);
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

// ---------------------------------------------------------------------------
// The bfloat16 body.

// d[64 x 192] += A[64 x 16] B[192 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
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
__device__ __forceinline__ void mma_issue(float (&acc)[96], uint32_t a_addr,
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
template <int N, int A>
__device__ __forceinline__ void mma_wait(float (&acc)[A]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(acc);
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

// x [B, C, H, W] and dy [B, F, H, W] bf16 through their tensor maps;
// partial [splits, F, 9, C]. Block (f tile, split); split `blockIdx.y` owns
// K-steps [chunk * split, +chunk) (for_runs). Warps 0-11 are the consumer
// warpgroups (ky = warp / 4), warpgroup 3 the producer (produce).
template <int KT>
__global__ void __launch_bounds__(kRingThreads, 1)
dw_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                __grid_constant__ const CUtensorMap dymap,
                float* __restrict__ partial, int C, int H, int F, int nslab,
                int steps, int chunk) {
  using T = WgmmaTile<KT>;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring_init<T>(smem_raw);
  const int f0 = blockIdx.x * kBoxRows;
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(steps, s_begin + chunk);
  if (threadIdx.x >= 128 * kConsumers) {
    produce<T>(r, &xmap, &dymap, f0, 0, H, nslab, s_begin, s_end,
               [](const uint8_t* stage, uint8_t* slot, int t, int n) {
                 shift_taps<KT>(stage, slot, t, n);
               });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ky = threadIdx.x / 128, lane = threadIdx.x % 32;
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.0f;
  // the slots of the wgmma group in flight, released once it completes:
  // a step's products overlap the next step's waits and issue
  int busy_dy = -1, busy_x = -1;
  auto release = [&]() {
    if (busy_dy >= 0 && lane == 0) {
      mbar_arrive(&r.dy_empty[busy_dy]);
      mbar_arrive(&r.x_empty[busy_x]);
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
  consume<T>(r, ky, H, s_begin, s_end, drain, [&](int ds, int xsl) {
    mma_issue<KT>(acc, smem_u32(r.dys + ds * T::kDy),
                  smem_u32(r.xs + xsl * T::kSlot));
    mma_wait<1>(acc);  // the previous step's group is done
    release();
    busy_dy = ds;
    busy_x = xsl;
  });
  store_partial<kBoxRows>(acc, partial + (long long)blockIdx.y * F * C * kTaps,
                          f0, 0, ky, C, F);
}

// ---------------------------------------------------------------------------
// The float32 body: 3xTF32.

// d[64 x 96] (+)= A[64 x 8] B[96 x 8]^T in tf32: A from registers (the
// m16n8k8 fragment of each warp's 16 rows), B a K-major 128B-swizzled tile;
// d is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_n96_tf32(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The three kx tiles [32 c][32] of one x row, each split into a tf32 hi
// and lo tile, K-major and 128B-swizzled as wgmma reads them ([3 kx x 32
// c][32] hi, then lo), from its staged copy [32 c][40], which starts 4
// columns left of the slab: tile kx, column k is staged column k + kx + 3.
// In float32 the +-1 column shifts are whole words. Thread t of n takes
// the 16-byte chunk pairs (j, j + 1) of rows c, (c, j / 2) = t, t + n,
// ...: four loads, 24 splits, twelve stores.
__device__ __forceinline__ void split_taps(const uint8_t* stage,
                                           uint8_t* tiles, int t, int n) {
  using T = Tf32Tile;
  constexpr int kPairs = T::kCols / 8;  // pairs of 16-byte chunks of a row
  for (int q = t; q < T::kTileC * kPairs; q += n) {
    const int j = 2 * (q % kPairs), c = q / kPairs;
    const float4* src =
        reinterpret_cast<const float4*>(stage + c * T::kRow) + j;
    float4 w[4];  // staged columns 4j .. 4j + 15
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = src[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // chunk j + h of each tile
      const float4 a = w[h], m = w[h + 1], z = w[h + 2];
      const float v[3][4] = {{a.w, m.x, m.y, m.z},
                             {m.x, m.y, m.z, m.w},
                             {m.y, m.z, m.w, z.x}};
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int row = kx * T::kTileC + c;
        const int at = row * 128 + (((j + h) ^ (row & 7)) << 4);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32::split(v[kx][i], hi[i], lo[i]);
        *reinterpret_cast<uint4*>(tiles + at) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(tiles + T::kTaps + at) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
}

// One K-step of a consumer warpgroup, float32-faithful: part = the dy tile
// [64 f][32] (128B-swizzled, as TMA landed it) times the slot's kx tiles
// [96][32]^T, as lo.hi + hi.lo + hi.hi: 12 wgmma into a fresh partial, a
// group of 3 for each 8 columns. Each warp splits its A fragments of the
// next 8 columns in registers while the current group runs (two sets of
// 4 + 4, so the partial, the running sum and A fit 128 registers). On
// return the products have read the dy tile and the slot.
__device__ __forceinline__ void tf32x3_step(float (&part)[48],
                                            const float* dy, uint32_t hi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m = 16 * ((threadIdx.x / 32) % 4) + g;  // rows m, m + 8
  const uint32_t lo = hi + Tf32Tile::kTaps;
  uint32_t ah[2][4], al[2][4];
  // the fragment of columns 8s .. 8s + 7: (row, k) of the swizzled tile,
  // 16-byte chunk k / 4 of row `row` at chunk (k / 4) ^ (row % 8), row % 8
  // = g
  auto split_a = [&](int s, uint32_t(&h)[4], uint32_t(&l)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m + 8 * (e & 1), k = 8 * s + t + 4 * (e >> 1);
      tf32::split(dy[row * 32 + (((k >> 2) ^ g) << 2) + (k & 3)], h[e], l[e]);
    }
  };
  // a set's registers stay live until its group is done
  auto hold = [](uint32_t(&h)[4], uint32_t(&l)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(h[e]), "+r"(l[e])::"memory");
  };
  split_a(0, ah[0], al[0]);
  fence_acc(part);
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // 8 tf32 = 32 bytes along K per group
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_n96_tf32(part, al[s & 1], smem_desc(hi + 32 * s, 1024, 1), s > 0);
    wgmma_n96_tf32(part, ah[s & 1], smem_desc(lo + 32 * s, 1024, 1), 1);
    wgmma_n96_tf32(part, ah[s & 1], smem_desc(hi + 32 * s, 1024, 1), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (s < 3) {
      mma_wait<1>(part);  // group s - 1 is done with the other set
      hold(ah[(s + 1) & 1], al[(s + 1) & 1]);
      split_a(s + 1, ah[(s + 1) & 1], al[(s + 1) & 1]);
    }
  }
  mma_wait<0>(part);
  hold(ah[0], al[0]);
  hold(ah[1], al[1]);
}

// x [B, C, H, W] and dy [B, F, H, W] float32 through their tensor maps;
// partial [splits, F, 9, C]. Block (f tile x nct + c tile, split), the
// bf16 body's ring and walk over K-steps of 32 columns; each consumer adds
// a K-step's partial to its running sum in IEEE float32 and releases the
// step's slots at once.
__global__ void __launch_bounds__(kRingThreads, 1)
dw_tf32x3_kernel(__grid_constant__ const CUtensorMap xmap,
                 __grid_constant__ const CUtensorMap dymap,
                 float* __restrict__ partial, int C, int H, int F, int nct,
                 int nslab, int steps, int chunk) {
  using T = Tf32Tile;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = ring_init<T>(smem_raw);
  const int f0 = (blockIdx.x / nct) * kBoxRows;
  const int c0 = (blockIdx.x % nct) * T::kTileC;
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(steps, s_begin + chunk);
  if (threadIdx.x >= 128 * kConsumers) {
    produce<T>(r, &xmap, &dymap, f0, c0, H, nslab, s_begin, s_end,
               [](const uint8_t* stage, uint8_t* slot, int t, int n) {
                 split_taps(stage, slot, t, n);
               });
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ky = threadIdx.x / 128, lane = threadIdx.x % 32;
  float acc[T::kAcc], part[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = part[i] = 0.0f;
  consume<T>(r, ky, H, s_begin, s_end, [] {}, [&](int ds, int xsl) {
    tf32x3_step(part, reinterpret_cast<const float*>(r.dys + ds * T::kDy),
                smem_u32(r.xs + xsl * T::kSlot));
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] += part[i];  // IEEE float32
    if (lane == 0) {
      mbar_arrive(&r.dy_empty[ds]);
      mbar_arrive(&r.x_empty[xsl]);
    }
  });
  store_partial<T::kTileC>(acc,
                           partial + (long long)blockIdx.y * F * C * kTaps,
                           f0, c0, ky, C, F);
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

// The tensor map of a contiguous [B, R, H, W] tensor of `type` (`bytes`
// each), boxes of `cols` columns x 1 row x `rows` of R x 1 image, swizzled
// for wgmma (or not). Fails (false) where the driver refuses the map, e.g.
// a base address that is not 16-byte aligned.
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
              int bytes, int B, int R, int H, int W, int cols, int rows,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)R,
                              (cuuint64_t)B};
  const cuuint64_t e = (cuuint64_t)bytes;
  const cuuint64_t strides[3] = {e * W, e * W * H, e * W * H * R};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches a ring kernel with `smem` bytes of dynamic shared memory, the
// attribute set once for the process.
template <class Kernel, class... Args>
cudaError_t launch_ring(Kernel kernel, bool& sized, size_t smem, dim3 grid,
                        cudaStream_t st, Args... args) {
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kernel<<<grid, kRingThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The partial kernel of the input type, then the fixed-order sum.
cudaError_t launch(const void* x, const void* dy, float* partial, float* out,
                   int B, int C, int H, int W, int F, int splits, int chunk,
                   bool bf16, cudaStream_t st) {
  const int kt = step_cols(W, bf16);
  const int nslab = W / kt;
  const int steps = B * H * nslab;
  const int nft = (F + kBoxRows - 1) / kBoxRows;
  CUtensorMap xm, dm;
  cudaError_t e;
  if (bf16) {
    static bool sized32 = false, sized64 = false;
    // dy: operand tiles as they are; x: staged rows of KT + 16 columns
    if (C > kBoxRows || (kt != 32 && kt != 64) ||
        !make_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, C, H, W,
                  kt + 16, kBoxRows, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&dm, dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, F, H, W,
                  kt, kBoxRows,
                  kt == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
    const dim3 grid(nft, splits);
    e = kt == 64 ? launch_ring(dw_wgmma_kernel<64>, sized64,
                               WgmmaTile<64>::kSmem, grid, st, xm, dm,
                               partial, C, H, F, nslab, steps, chunk)
                 : launch_ring(dw_wgmma_kernel<32>, sized32,
                               WgmmaTile<32>::kSmem, grid, st, xm, dm,
                               partial, C, H, F, nslab, steps, chunk);
  } else {
    using T = Tf32Tile;
    static bool sized = false;
    // dy: operand tiles [64 f][32] as they are; x: staged rows [32 c][40]
    if (!make_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, C, H, W,
                  kt + 2 * T::kPad, T::kTileC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&dm, dy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, F, H, W, kt,
                  kBoxRows, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    const int nct = (C + T::kTileC - 1) / T::kTileC;
    e = launch_ring(dw_tf32x3_kernel, sized, T::kSmem, dim3(nft * nct, splits),
                    st, xm, dm, partial, C, H, F, nct, nslab, steps, chunk);
  }
  if (e != cudaSuccess) return e;
  const long long n = (long long)F * C * kTaps;
  dw_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads),
                     kReduceThreads, 0, st>>>(partial, out, C, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W] and dy [B, F, H, W] of one type (dtype 0 float32, 1
// bfloat16), contiguous, 16-byte aligned (bf16: C <= 64); W a multiple of
// a K-step's columns (bf16 min(W, 64), float32 32). K-steps (image row
// segments of that many columns) split into `splits` runs of `chunk`.
// partial: float32 scratch of splits * F * C * 9; out [F, C, 3, 3]
// float32. On `device`; `stream` is a cudaStream_t of that device. Returns
// the CUDA error code of the launches (0 = success; a refused shape or
// tensor map is cudaErrorInvalidValue).
int conv3x3_dw(const void* x, const void* dy, void* partial, void* out,
               int B, int C, int H, int W, int F, int splits, int chunk,
               int dtype, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int kt = step_cols(W, dtype == 1);
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || F <= 0 || splits <= 0 ||
      chunk <= 0 || W % kt != 0 ||
      (long long)splits * chunk < (long long)B * H * (W / kt))
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
