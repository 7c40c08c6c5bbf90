// The three batch-blocked capsule-routing variants (V) for Hopper, sm_90a.
//
// Replaces tools/capsule_variants.py: forward_stored (_kernel_stored),
// forward_seq (_kernel_seq) and forward_recompute (_kernel_recompute), the
// bench-only redesigns of K1 (csrc/capsule_routing.cu). Each computes K1's
// function: dynamic routing of x [B, I, L] through a weight W [J, O, L]
// shared over the input capsules, v [B, J, O], float32 throughout. What
// the variants try is a block that owns NB samples, so that every weight
// tile it reads serves all NB of them; they differ in where the votes
// u[b, i, j, :] = W_j x_i live:
//
//   stored     the votes of the block's NB samples are computed once and
//              kept for every routing pass;
//   seq        the block routes its NB samples one after another through
//              one votes buffer that it reuses;
//   recompute  no votes are kept: every pass recomputes them from x and W.
//
// What bounds them here. The votes of one sample are I x J x O floats: at
// the generator head (48, 8, 1024, 32) 6.3 MB, beyond the 227 KB of shared
// memory a block can use, so where they are kept they live in a device
// scratch (stored: B of them, 2.0 GB at B=320; seq: one per block), as K1's
// votes form keeps them (csrc/capsule_routing.cu). Then bytes bound the
// variant: the votes are written once and read again in every pass, 4 x
// 2.0 GB at the generator head at B=320 with 3 passes, at least 2.4 ms by
// the memory rate alone. The logits b[b, i, j] (I x J floats a sample,
// 196 KB at the generator head) do not fit on chip for NB samples either
// and live in the same scratch.
// recompute trades those bytes for arithmetic: at in_length 8 it uses K1's
// factored algebra (b_ij = x_i . a_j, s_j = W_j y_j with a_j = sum over
// passes of W_j^T v_j, y_j = sum_i c_ij x_i), so that neither the votes nor
// the couplings ever exist and only a_j (8 floats per sample and output
// capsule, in the device scratch) is kept; at any other in_length it
// recomputes u_ij = W_j x_i in every pass, tile by tile in shared memory,
// with the logits in the device scratch. The grid is ceil(B / NB) blocks,
// so small batches with large NB leave most of the 132 SMs idle.
//
// What the design does. One block of 256 threads owns NB samples (the last
// block routes only the samples that exist: the batch padding of the JAX
// functions is cut from the output, so it is not computed). Per-sample sums
// are warp reductions (shuffles), not the block-ones products of the Pallas
// kernels, which were a Mosaic workaround. The vote products are one tiled
// float32 product written for a single block (block_gemm_nt): a slice of W
// staged in shared memory serves up to 256 rows of x, NB samples' worth at
// the discriminator head (I = 16). Routing over votes walks the output
// capsules in tiles: the tile's votes (from the scratch, or recomputed) sit
// in shared memory, the couplings of the tile are taken from the logits, a
// thread per (sample, j, o) sums over the input capsules and squashes with
// shuffles over the O lanes of the capsule, and a thread per (row, j)
// updates the logit from the same votes tile. The factored recompute keeps
// K1's thread per output capsule, now one per (sample, j) with samples
// fastest, so that the lanes of a warp that share j share every load of W_j.
// Simple first: no tensor cores (the JAX kernels compute in float32), no
// asynchronous copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL8 = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kStored = 0, kSeq = 1, kRecompute = 2 };

// block_gemm_nt: tiles of 64 rows x 64 columns, 16 deep; up to kGroup row
// tiles share each staged slice of the second operand.
constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 16;
constexpr int kGroup = 4;
constexpr int kGroupRows = kTM * kGroup;
constexpr int kAS = kGroupRows + 2;  // staging strides: conflict-free stores
constexpr int kBS = kTN + 2;
constexpr int kGemmFloats = kTK * kAS + kTK * kBS;
// floats of a votes tile the routing aims for (R rows x jt capsules x O)
constexpr int kTileFloats = 4096;
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t r4(size_t n) { return (n + 3) & ~(size_t)3; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&r)[kL8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void load8_ro(const float* p, float (&r)[kL8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ float dot8(const float (&a)[kL8],
                                      const float (&b)[kL8]) {
  float s = 0.f;
#pragma unroll
  for (int l = 0; l < kL8; ++l) s = fmaf(a[l], b[l], s);
  return s;
}

// C[m, n] = sum_k A[m * K + k] * Bw[n * K + k] for m < M, n < N, written
// at C[m * ldc + n]; A and Bw are read-only inputs (x rows and W rows, both
// k-contiguous), C is device memory or shared memory. All kThreads threads
// of the block call it; `stage` is kGemmFloats of shared memory. A thread
// owns a 4 x 4 set of each 64 x 64 tile (rows ty + 16a, columns tx + 16b),
// for up to kGroup row tiles at once, so a staged 16 x 64 slice of Bw
// serves up to 256 rows. Sums in k order, float32.
__device__ void block_gemm_nt(const float* __restrict__ A,
                              const float* __restrict__ Bw, float* C,
                              size_t ldc, int M, int N, int K, float* stage) {
  float* As = stage;              // [kTK][kAS]
  float* Bs = stage + kTK * kAS;  // [kTK][kBS]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int n0 = 0; n0 < N; n0 += kTN) {
    for (int m0 = 0; m0 < M; m0 += kGroupRows) {
      const int ng = min(kGroup, (M - m0 + kTM - 1) / kTM);
      float acc[kGroup][4][4];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[g][a][b] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTK) {
        for (int idx = tid; idx < kTK * kTM * ng; idx += kThreads) {
          const int kk = idx % kTK, mm = idx / kTK;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * kAS + mm] =
              (m < M && k < K) ? __ldg(A + (size_t)m * K + k) : 0.f;
        }
        for (int idx = tid; idx < kTK * kTN; idx += kThreads) {
          const int kk = idx % kTK, nn = idx / kTK;
          const int n = n0 + nn, k = k0 + kk;
          Bs[kk * kBS + nn] =
              (n < N && k < K) ? __ldg(Bw + (size_t)n * K + k) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kTK; ++kk) {
          float rb[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) rb[b] = Bs[kk * kBS + tx + 16 * b];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g < ng) {
              float ra[4];
#pragma unroll
              for (int a = 0; a < 4; ++a)
                ra[a] = As[kk * kAS + g * kTM + ty + 16 * a];
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                  acc[g][a][b] = fmaf(ra[a], rb[b], acc[g][a][b]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g < ng) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int m = m0 + g * kTM + ty + 16 * a;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int n = n0 + tx + 16 * b;
              if (m < M && n < N) C[(size_t)m * ldc + n] = acc[g][a][b];
            }
          }
        }
      }
    }
  }
}

// ---- routing over votes (stored, seq, and recompute at in_length != 8) --

// Output capsules per tile: about kTileFloats floats of votes for R rows;
// a recomputed tile is at least one product tile wide (kTN columns), as
// far as shared memory allows.
__host__ __device__ inline size_t route_floats(int R, int ns, int jt, int O) {
  // votes [R][jt*O + 4] | couplings [R][jt] | v [ns][jt*O] | max [R] |
  // 1/sum [R] | product staging
  return r4((size_t)R * (jt * O + 4)) + r4((size_t)R * jt) +
         r4((size_t)ns * jt * O) + 2 * r4(R) + kGemmFloats;
}

inline int tile_j(int kind, int R, int ns, int J, int O) {
  int jt = kTileFloats / (R * O);
  if (kind == kRecompute && jt < kTN / O) jt = kTN / O;
  if (jt < 1) jt = 1;
  if (jt > J) jt = J;
  while (jt > 1 && route_floats(R, ns, jt, O) * sizeof(float) > kMaxSmem)
    jt /= 2;
  return jt;
}

struct RouteSmem {
  float *u, *c, *v, *m, *zinv, *stage;
};

__device__ inline RouteSmem route_smem(float* base, int R, int ns, int jt,
                                       int O) {
  RouteSmem s;
  s.u = base;
  base += r4((size_t)R * (jt * O + 4));
  s.c = base;
  base += r4((size_t)R * jt);
  s.v = base;
  base += r4((size_t)ns * jt * O);
  s.m = base;
  base += r4(R);
  s.zinv = base;
  base += r4(R);
  s.stage = base;
  return s;
}

// Dynamic routing of ns samples (R = ns * I rows) by the whole block.
// Votes come from `votes` [R, J*O] (device memory written by this block
// earlier in the kernel, so read without the read-only cache), or, where
// `votes` is null, are recomputed in every pass from the samples' x rows
// [R, L] and W. `logits` [R, J] is this group's device scratch; `out`
// [ns, J, O]. Ends with the block synchronised.
template <int O>
__device__ void route_group(const float* votes, const float* __restrict__ x,
                            const float* __restrict__ w, float* logits,
                            float* __restrict__ out, int ns, int I, int L,
                            int J, int iters, int jt, const RouteSmem& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = ns * I;
  const int ldu = jt * O + 4;  // padded: conflict-free float4 rows
  for (size_t p = tid; p < (size_t)R * J; p += kThreads) logits[p] = 0.f;
  __syncthreads();
  for (int r = 0; r < iters; ++r) {
    const bool last = (r == iters - 1);
    // softmax statistics of every row over the output capsules
    for (int row = warp; row < R; row += kWarps) {
      const float* lr = logits + (size_t)row * J;
      float mx = -INFINITY;
      for (int j = lane; j < J; j += 32) mx = fmaxf(mx, lr[j]);
      mx = warp_max(mx);
      float z = 0.f;
      for (int j = lane; j < J; j += 32) z += expf(lr[j] - mx);
      z = warp_sum(z);
      if (lane == 0) {
        sm.m[row] = mx;
        sm.zinv[row] = 1.f / z;
      }
    }
    __syncthreads();
    for (int j0 = 0; j0 < J; j0 += jt) {
      const int nj = min(jt, J - j0);
      const int n = nj * O;
      // the votes of output capsules j0 .. j0 + nj - 1: U [R][n]
      if (votes) {
        const int n4 = n / 4;
        for (int p = tid; p < R * n4; p += kThreads) {
          const int row = p / n4, q = p % n4;
          reinterpret_cast<float4*>(sm.u + (size_t)row * ldu)[q] =
              reinterpret_cast<const float4*>(
                  votes + (size_t)row * J * O + (size_t)j0 * O)[q];
        }
      } else {
        block_gemm_nt(x, w + (size_t)j0 * O * L, sm.u, ldu, R, n, L, sm.stage);
      }
      // their couplings c_ij = softmax_j(b_ij)
      for (int p = tid; p < R * nj; p += kThreads) {
        const int row = p / nj, jj = p % nj;
        sm.c[p] = expf(logits[(size_t)row * J + j0 + jj] - sm.m[row]) *
                  sm.zinv[row];
      }
      __syncthreads();
      // s_j = sum_i c_ij u_ij per sample, squashed over the O lanes of j
      const int items = ns * n;
      const int items32 = (items + 31) & ~31;
      for (int t = tid; t < items32; t += kThreads) {
        const bool valid = t < items;
        const int s = valid ? t / n : 0;
        const int col = valid ? t % n : 0;
        const int jj = col / O;
        float acc = 0.f;
        if (valid) {
          const float* up = sm.u + (size_t)s * I * ldu + col;
          const float* cp = sm.c + (size_t)s * I * nj + jj;
          for (int i = 0; i < I; ++i)
            acc = fmaf(cp[(size_t)i * nj], up[(size_t)i * ldu], acc);
        }
        float n2 = acc * acc;
#pragma unroll
        for (int off = O / 2; off > 0; off >>= 1)
          n2 += __shfl_xor_sync(kFull, n2, off);
        const float v = acc * (n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f));
        if (valid) {
          if (last)
            out[((size_t)s * J + j0 + jj) * O + (col % O)] = v;
          else
            sm.v[t] = v;
        }
      }
      __syncthreads();
      if (!last) {
        // b_ij += u_ij . v_j; rows fastest (conflict-free float4 rows)
        for (int p = tid; p < R * nj; p += kThreads) {
          const int jj = p / R, row = p % R;
          const float4* up =
              reinterpret_cast<const float4*>(sm.u + (size_t)row * ldu + jj * O);
          const float4* vp = reinterpret_cast<const float4*>(
              sm.v + (size_t)(row / I) * n + jj * O);
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < O / 4; ++q) {
            const float4 a = up[q];
            const float4 c = vp[q];
            acc = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z,
                                                     fmaf(a.w, c.w, acc))));
          }
          logits[(size_t)row * J + j0 + jj] += acc;
        }
        __syncthreads();
      }
    }
  }
}

// V-stored: the block computes the votes of its samples once into the
// scratch [B*I, J*O], then routes all of them together.
template <int O>
__global__ void __launch_bounds__(kThreads)
stored_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* votes, float* logits, float* __restrict__ out, int B,
              int I, int L, int J, int iters, int nb, int jt) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * nb;
  const int ns = min(nb, B - b0);
  const RouteSmem sm =
      route_smem(reinterpret_cast<float*>(smem4), nb * I, nb, jt, O);
  const size_t row0 = (size_t)b0 * I;
  float* vb = votes + row0 * J * O;
  block_gemm_nt(x + row0 * L, w, vb, (size_t)J * O, ns * I, J * O, L,
                sm.stage);
  __syncthreads();
  route_group<O>(vb, nullptr, w, logits + row0 * J, out + (size_t)b0 * J * O,
                 ns, I, L, J, iters, jt, sm);
}

// V-seq: one votes buffer [I, J*O] and one logits buffer [I, J] per block,
// reused by its samples in turn.
template <int O>
__global__ void __launch_bounds__(kThreads)
seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* votes, float* logits, float* __restrict__ out, int B, int I,
           int L, int J, int iters, int nb, int jt) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * nb;
  const int ns = min(nb, B - b0);
  const RouteSmem sm = route_smem(reinterpret_cast<float*>(smem4), I, 1, jt, O);
  float* vb = votes + (size_t)blockIdx.x * I * J * O;
  float* lb = logits + (size_t)blockIdx.x * I * J;
  for (int s = 0; s < ns; ++s) {
    const size_t row0 = (size_t)(b0 + s) * I;
    block_gemm_nt(x + row0 * L, w, vb, (size_t)J * O, I, J * O, L, sm.stage);
    __syncthreads();
    route_group<O>(vb, nullptr, w, lb, out + (size_t)(b0 + s) * J * O, 1, I,
                   L, J, iters, jt, sm);
  }
}

// V-recompute at in_length != 8: no votes kept; logits [B*I, J] in the
// scratch.
template <int O>
__global__ void __launch_bounds__(kThreads)
recompute_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* logits, float* __restrict__ out, int B, int I, int L,
                 int J, int iters, int nb, int jt) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * nb;
  const int ns = min(nb, B - b0);
  const RouteSmem sm =
      route_smem(reinterpret_cast<float*>(smem4), nb * I, nb, jt, O);
  const size_t row0 = (size_t)b0 * I;
  route_group<O>(nullptr, x + row0 * L, w, logits + row0 * J,
                 out + (size_t)b0 * J * O, ns, I, L, J, iters, jt, sm);
}

// ---- V-recompute at in_length 8: K1's factored algebra for NB samples --

// Shared memory: x [nb][I*8 + 4] (a sample's rows padded by one float4, so
// that the lanes of different samples read different banks) | max [nb*I] |
// 1/sum [nb*I].
__host__ __device__ inline size_t factored_floats(int I, int nb) {
  return (size_t)nb * (I * kL8 + 4) + 2 * r4((size_t)nb * I);
}

template <int O>
__global__ void __launch_bounds__(kThreads)
recompute_factored_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* a,
                          float* __restrict__ out, int B, int I, int J,
                          int iters, int nb) {
  extern __shared__ float4 smem4[];
  const int xstride = I * kL8 + 4;
  float* xs = reinterpret_cast<float*>(smem4);
  float* mx = xs + (size_t)nb * xstride;
  float* zinv = mx + r4((size_t)nb * I);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * nb;
  const int ns = min(nb, B - b0);
  const int R = ns * I;
  const float* xb = x + (size_t)b0 * I * kL8;
  for (int p = tid; p < R * kL8; p += kThreads)
    xs[(p / (I * kL8)) * xstride + p % (I * kL8)] = __ldg(xb + p);
  // a [ns][J][8]: sum over the passes so far of W_j^T v_j, per sample
  float* ab = a + (size_t)b0 * J * kL8;
  for (size_t p = tid; p < (size_t)ns * J * kL8; p += kThreads) ab[p] = 0.f;
  __syncthreads();

  for (int r = 0; r < iters; ++r) {
    const bool last = (r == iters - 1);
    // (1) per row (s, i), the max and the sum of exp of b_ij = x_i . a_j
    //     over j: a warp per row, its lanes over j
    for (int row = warp; row < R; row += kWarps) {
      const int s = row / I;
      float xi[kL8];
      load8(xs + (size_t)s * xstride + (row % I) * kL8, xi);
      const float* as = ab + (size_t)s * J * kL8;
      float m = -INFINITY;
      for (int j = lane; j < J; j += 32) {
        float aj[kL8];
        load8(as + (size_t)j * kL8, aj);
        m = fmaxf(m, dot8(xi, aj));
      }
      m = warp_max(m);
      float z = 0.f;
      for (int j = lane; j < J; j += 32) {
        float aj[kL8];
        load8(as + (size_t)j * kL8, aj);
        z += expf(dot8(xi, aj) - m);
      }
      z = warp_sum(z);
      if (lane == 0) {
        mx[row] = m;
        zinv[row] = 1.f / z;
      }
    }
    __syncthreads();
    // (2) per (sample, output capsule), samples fastest: y_j, s_j = W_j y_j,
    //     v_j = squash(s_j), then a_j += W_j^T v_j or write v_j
    for (int p = tid; p < ns * J; p += kThreads) {
      const int s = p % ns, j = p / ns;
      const float* xsm = xs + (size_t)s * xstride;
      float* ap = ab + ((size_t)s * J + j) * kL8;
      float aj[kL8];
      load8(ap, aj);
      float y[kL8];
#pragma unroll
      for (int l = 0; l < kL8; ++l) y[l] = 0.f;
      for (int i = 0; i < I; ++i) {
        float xi[kL8];
        load8(xsm + i * kL8, xi);
        const float c =
            expf(dot8(xi, aj) - mx[s * I + i]) * zinv[s * I + i];
#pragma unroll
        for (int l = 0; l < kL8; ++l) y[l] = fmaf(c, xi[l], y[l]);
      }
      const float* wj = w + (size_t)j * O * kL8;
      float sv[O];
      float t[kL8];
#pragma unroll
      for (int l = 0; l < kL8; ++l) t[l] = 0.f;
      float n2 = 0.f;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        float wo[kL8];
        load8_ro(wj + o * kL8, wo);
        const float so = dot8(wo, y);
        sv[o] = so;
        n2 = fmaf(so, so, n2);
#pragma unroll
        for (int l = 0; l < kL8; ++l) t[l] = fmaf(wo[l], so, t[l]);
      }
      const float scale = n2 / (1.f + n2) * rsqrtf(n2 + 1e-8f);
      if (last) {
        float4* ob =
            reinterpret_cast<float4*>(out + ((size_t)(b0 + s) * J + j) * O);
#pragma unroll
        for (int q = 0; q < O / 4; ++q)
          ob[q] = make_float4(sv[4 * q] * scale, sv[4 * q + 1] * scale,
                              sv[4 * q + 2] * scale, sv[4 * q + 3] * scale);
      } else {
#pragma unroll
        for (int l = 0; l < kL8; ++l) ap[l] = fmaf(scale, t[l], aj[l]);
      }
    }
    __syncthreads();
  }
}

// ---- host side -----------------------------------------------------------

struct Plan {
  int jt;         // output capsules per routing tile (0: factored kernel)
  size_t smem;    // bytes of dynamic shared memory
  size_t scratch; // floats of device scratch
};

Plan plan(int kind, int B, int I, int L, int J, int O, int nb) {
  Plan p{0, 0, 0};
  const size_t grid = (size_t)(B + nb - 1) / nb;
  if (kind == kRecompute && L == kL8) {
    p.smem = factored_floats(I, nb) * sizeof(float);
    p.scratch = (size_t)B * J * kL8;
    return p;
  }
  const int R = (kind == kSeq) ? I : nb * I;
  const int ns = (kind == kSeq) ? 1 : nb;
  p.jt = tile_j(kind, R, ns, J, O);
  p.smem = route_floats(R, ns, p.jt, O) * sizeof(float);
  switch (kind) {
    case kStored:  // votes [B*I, J*O] | logits [B*I, J]
      p.scratch = (size_t)B * I * J * O + (size_t)B * I * J;
      break;
    case kSeq:  // per block: votes [I, J*O] | logits [I, J]
      p.scratch = grid * I * J * O + grid * I * J;
      break;
    default:  // logits [B*I, J]
      p.scratch = (size_t)B * I * J;
  }
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int O>
cudaError_t launch(int kind, const float* x, const float* w, float* scratch,
                   float* out, int B, int I, int L, int J, int iters, int nb,
                   cudaStream_t st) {
  const Plan p = plan(kind, B, I, L, J, O, nb);
  const int grid = (B + nb - 1) / nb;
  cudaError_t e;
  if (kind == kStored) {
    e = allow_smem(stored_kernel<O>, p.smem);
    if (e != cudaSuccess) return e;
    stored_kernel<O><<<grid, kThreads, p.smem, st>>>(
        x, w, scratch, scratch + (size_t)B * I * J * O, out, B, I, L, J, iters,
        nb, p.jt);
  } else if (kind == kSeq) {
    e = allow_smem(seq_kernel<O>, p.smem);
    if (e != cudaSuccess) return e;
    seq_kernel<O><<<grid, kThreads, p.smem, st>>>(
        x, w, scratch, scratch + (size_t)grid * I * J * O, out, B, I, L, J,
        iters, nb, p.jt);
  } else if (L == kL8) {
    e = allow_smem(recompute_factored_kernel<O>, p.smem);
    if (e != cudaSuccess) return e;
    recompute_factored_kernel<O><<<grid, kThreads, p.smem, st>>>(
        x, w, scratch, out, B, I, J, iters, nb);
  } else {
    e = allow_smem(recompute_kernel<O>, p.smem);
    if (e != cudaSuccess) return e;
    recompute_kernel<O><<<grid, kThreads, p.smem, st>>>(
        x, w, scratch, out, B, I, L, J, iters, nb, p.jt);
  }
  return cudaGetLastError();
}

bool valid(int kind, int B, int I, int L, int J, int O, int nb) {
  return kind >= kStored && kind <= kRecompute && B > 0 && I > 0 && L > 0 &&
         J > 0 && nb > 0 && (O == 16 || O == 32);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of variant `kind` (0 stored,
// 1 seq, 2 recompute) needs; the wrapper checks it against the card's limit
// before launching. 0 for arguments the kernels do not take.
size_t capsule_variants_smem_bytes(int kind, int I, int L, int J, int O,
                                   int nb) {
  if (!valid(kind, 1, I, L, J, O, nb)) return 0;
  return plan(kind, 1, I, L, J, O, nb).smem;
}

// Floats of device scratch the variant needs for a batch of B.
size_t capsule_variants_scratch_floats(int kind, int B, int I, int L, int J,
                                       int O, int nb) {
  if (!valid(kind, B, I, L, J, O, nb)) return 0;
  return plan(kind, B, I, L, J, O, nb).scratch;
}

// x [B, I, L], w [J, O, L], scratch (capsule_variants_scratch_floats
// floats), out [B, J, O]; all float32, contiguous and 16-byte aligned, on
// `device`; `stream` is a cudaStream_t of that device. NB = nb samples per
// block. Returns the CUDA error code of the launch (0 = success).
int capsule_variants_fwd(int kind, const void* x, const void* w,
                         void* scratch, void* out, int B, int I, int L, int J,
                         int O, int iters, int nb, int device, void* stream) {
  if (!valid(kind, B, I, L, J, O, nb) || iters <= 0)
    return (int)cudaErrorInvalidValue;
  // This library links its own CUDA runtime, whose current device is
  // separate from PyTorch's.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* sf = static_cast<float*>(scratch);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 16)
    e = launch<16>(kind, xf, wf, sf, of, B, I, L, J, iters, nb, st);
  else
    e = launch<32>(kind, xf, wf, sf, of, B, I, L, J, iters, nb, st);
  return (int)e;
}

}  // extern "C"
