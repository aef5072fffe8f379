// Nearest-neighbour argmin for Hopper (sm_90a), kernel E.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   actionmesh_tpu/ops/nn_argmin.py:nn_argmin (pallas_call :148)
// and meets its contract: x (R, N, C), y (R, M, C) fp32, contiguous; out
// (R, N) int32 holds, for every x[r, i], the index j of the y[r, j] nearest
// to it in squared euclidean distance. Ties go to the smallest j. Inputs are
// taken to be finite (the ICP caller samples finite meshes only).
//
// The distance: with a = [-2x, 1, s_x] and b = [y, |y|^2, 1], a.b = |y|^2 -
// 2 x.y + s_x, the TPU kernel's |y|^2 - 2 x.y (nn_argmin.py:76-77) plus a
// row offset s_x = |x|^2 (1 + 2^-8) that changes no argmin and makes every
// distance positive (|x - y|^2 + |x|^2 / 256, far above the products'
// rounding). One matrix product of depth C + 2, on the TF32 tensor cores.
//
// What bounds it: at the ICP shape (R = 384, N = M = 10,000, C = 3) a call is
// 3.84e10 (x, y) pairs against ~92 MB of input, so operations, not memory:
// the distance at fp32 accuracy is 3 (C + 1) = 12 TF32 products a pair
// (0.92e12 flop, 1.86 ms at 495 TFLOP/s); the packing below runs 16 (2.48 ms)
// for its row offset and padding. The running minimum is at least one
// CUDA-core operation for two pairs. A CUDA-core design (three FFMAs and an
// fminf a pair, the same rescan of a recorded sub-tile, a grid sized to the
// SMs) was built and timed at 9.3-9.5 ms against this design's 7.2-7.3 ms in
// one call (PERF.md); its per-pair fminf looks like its limit (PERF.md §7).
//
// Accuracy: plain TF32 keeps 10 mantissa bits and would flip argmins between
// genuinely different neighbours, so every product is three TF32 products
// (3xTF32), the Hopper counterpart of the TPU kernel's compensated split
// (nn_argmin.py:70-75, three bf16 dots), with a smaller residual:
//   a.b ~ a_hi.b_lo + a_lo.b_hi + a_hi.b_hi,
// hi = v rounded to TF32 to nearest on the bit pattern (as
// ops/flash_attention.py:tf32_split for finite v), lo = v - hi exactly; the
// tensor core reads lo's top 19 bits. The three products are packed along
// the depth: column c of a row is, with C1 = C + 2, e = c % C1,
//   A: a_hi[e] (c < C1), a_lo[e] (c < 2 C1), a_hi[e] (c < 3 C1), 0 beyond;
//   B: b_lo[e],          b_hi[e],            b_hi[e],             0,
// padded to K = 16 at C = 3 (C = 8: K = 32), two k-steps of 8. The tensor
// core's truncating fp32 sums add 16 products into one fresh accumulator a
// tile and round each distance once at the scale of its own terms, a few
// fp32 ulps of |x|^2 + |y|^2, the scale NN_TIE_REL judges a near-tie by, so
// one packed product is enough (kernel A's fp32 path needs separate
// accumulators over thousands of keys; this one sums 16 products).
//
// Design:
//   * A pre-pass (pack_y_kernel) writes every point's packed B row once
//     into a workspace the wrapper allocates, (R, M rounded up to 128, K)
//     fp32; points beyond M get y = 0, |y|^2 = 1e30, so no mask is needed.
//   * A CTA of four warpgroups owns 256 queries of one problem r, one
//     64-row block a warpgroup. Each thread builds its A fragments (m64nNk8:
//     rows 16w + g and 16w + g + 8, columns t and t + 4 of each k-step) from
//     x once and keeps them in registers for the whole sweep.
//   * y is swept in tiles of 128 points through a ring of four tiles in
//     shared memory, 128 bytes a point with the 128-byte swizzle the wgmma
//     descriptor reads (K-major). Every thread copies its warpgroup's 16-byte
//     chunks of one point of a tile by cp.async, three tiles ahead, and
//     arrives on the slot's full mbarrier when they land; each warp arrives
//     on the slot's empty mbarrier once its products are done, and a slot is
//     refilled only after that. No block-wide barrier in the loop.
//   * Products: wgmma m64n128k8 TF32 with A from registers (as kernel A's
//     fp32 path) and B from shared memory; the first k-step overwrites the
//     accumulator (scale-d 0), so no accumulator is cleared. wgmma, not
//     mma.sync: it is the only way to the full TF32 rate, and an n128
//     accumulator gives each thread 32 distances of each of its two rows.
//   * Epilogue: the distances are positive, so their bits order as unsigned
//     integers do, and Hopper's three-way integer minimum (DPX,
//     __vimin3_u32) takes two distances an operation; then a quad shuffle
//     and one compare with the row's best. A row keeps only its best value
//     and the tile that holds it: strict <, so an equal minimum in a later
//     tile keeps the earlier one.
//   * After the sweep, the four lanes of a row recompute its winning tile's
//     128 distances on the CUDA cores (|y|^2 - 2 x.y as fp32 FMAs, the
//     earlier design's arithmetic) and take the first smallest: exact
//     duplicates give equal values either way, so ties still go to the
//     smallest index; a pick inside the tile can differ from the tensor
//     cores' only between near-ties. (Rescanning the tile's fragment on
//     every improvement instead would run in about a third of the tiles,
//     since a warp holds 16 rows, and cost more than the minimum itself.)
//   * The grid is (N / 256, R) CTAs of 512 threads, one CTA an SM: 15,360 at
//     the ICP shape, 116.4 waves over 132 SMs, so the tail is under 1%.
//   Measured on the card (PERF.md), the products and the CUDA-core work of
//   this loop add up rather than overlap, and the sweep takes ~4x its bound:
//   later work.
// C <= 3 runs as 3 channels and 3 < C <= 8 as 8 (the wrapper pads with
// zeros, which add nothing to a distance).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kQueries = 64 * kWarpgroups;  // one 64-row block a warpgroup
constexpr int kTile = 128;                  // y points a tile, the product's N
constexpr int kStages = 4;                  // tiles in the shared-memory ring
constexpr int kTileBytes = kTile * 128;     // one 128-byte swizzled row a point
constexpr int kSmemBytes = kStages * kTileBytes + 16 * kStages + 1024;  // + full/empty barriers, alignment
constexpr float kPadSq = 1e30f;             // |y|^2 of points beyond M
constexpr float kOffsetScale = 1.f + 1.f / 256;  // the row offset: |x|^2 of it

// The packed depth for CP channels: three segments of CP + 2, to 8.
template <int CP>
struct Packing {
  static constexpr int kC1 = CP + 2;
  static constexpr int kK = (3 * kC1 + 7) / 8 * 8;
  static constexpr int kSteps = kK / 8;
};

// The split of a finite v: hi = v rounded to TF32 to nearest (ties away from
// zero) on the bit pattern, lo = v - hi exactly.
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
  lo = v - hi;
}

// The row offset of query x: |x|^2 (1 + 2^-8), an FMA chain over the
// channels then one product, so that every distance is positive.
template <int CP>
__device__ __forceinline__ float row_offset(const float* xq) {
  float s = 0.f;
  if (xq != nullptr) {
#pragma unroll
    for (int c = 0; c < CP; ++c) s = fmaf(xq[c], xq[c], s);
  }
  return s * kOffsetScale;
}

// Column c of the packed A row of query xq (CP values; null: a row beyond N)
// whose row offset is sx.
template <int CP>
__device__ __forceinline__ uint32_t a_packed(const float* xq, float sx, int c) {
  constexpr int C1 = Packing<CP>::kC1;
  if (c >= 3 * C1) return 0u;
  const int seg = c / C1, e = c - seg * C1;
  const float v = e < CP ? (xq != nullptr ? -2.f * xq[e] : 0.f) : (e == CP ? 1.f : sx);
  float hi, lo;
  split(v, hi, lo);
  return __float_as_uint(seg == 1 ? lo : hi);
}

// Pre-pass: the packed B row of every point of y, padded to whole tiles
// (points beyond M: y = 0, |y|^2 = 1e30), into the workspace ws (R, Mp, K).
template <int CP>
__global__ void __launch_bounds__(256) pack_y_kernel(const float* __restrict__ y, float* __restrict__ ws,
                                                    int R, int M, int Mp) {
  constexpr int C1 = Packing<CP>::kC1, K = Packing<CP>::kK;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(R) * Mp) return;
  const int r = static_cast<int>(i / Mp), m = static_cast<int>(i % Mp);
  float v[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) v[c] = m < M ? y[(static_cast<long long>(r) * M + m) * CP + c] : 0.f;
  float hi[C1], lo[C1];
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    sq = fmaf(v[c], v[c], sq);
    split(v[c], hi[c], lo[c]);
  }
  split(m < M ? sq : kPadSq, hi[CP], lo[CP]);
  hi[CP + 1] = 1.f;  // meets the row offset
  lo[CP + 1] = 0.f;
  float4* row = reinterpret_cast<float4*>(ws + i * K);
#pragma unroll
  for (int chunk = 0; chunk < K / 4; ++chunk) {
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * chunk + k, seg = col / C1, e = col % C1;
      w[k] = col >= 3 * C1 ? 0.f : (seg == 0 ? lo[e] : hi[e]);
    }
    row[chunk] = make_float4(w[0], w[1], w[2], w[3]);
  }
}

// 16-byte chunks of a packed row that each warpgroup copies into a tile.
template <int CP>
constexpr int kChunksPerWarpgroup = Packing<CP>::kK / 4 / kWarpgroups;

// D (64 x 128) = A (this block's fragments) * B (the tile), over kSteps k-steps.
template <int CP>
__device__ __forceinline__ void product(float (&d)[64], uint32_t (&a)[Packing<CP>::kSteps][4],
                                        uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < Packing<CP>::kSteps; ++s) {
    wgmma_m64n128k8_tf32_rs(d, a[s], wgmma_desc(tile + s * 32, 16, 1024), s > 0);
  }
  wgmma_commit();
}

// The running minimum of this thread's two rows over one tile's distances d
// (accumulator layout: d[4j + 2h + e] is row g + 8h, column 8j + 2t + e),
// and the tile that holds it. Every distance is positive, so its bits order
// as unsigned integers do, and three-way integer minima (Hopper's DPX) take
// two distances an operation.
__device__ __forceinline__ void epilogue(const float (&d)[64], int tile, unsigned (&best)[2],
                                         int (&best_tile)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned m[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // chain c: j = c, c + 4, c + 8, c + 12
      const int k = 4 * c + 2 * h;
      m[c] = __vimin3_u32(__float_as_uint(d[k]), __float_as_uint(d[k + 1]), __float_as_uint(d[k + 16]));
      m[c] = __vimin3_u32(m[c], __float_as_uint(d[k + 17]), __float_as_uint(d[k + 32]));
      m[c] = __vimin3_u32(m[c], __float_as_uint(d[k + 33]), __float_as_uint(d[k + 48]));
      m[c] = min(m[c], __float_as_uint(d[k + 49]));
    }
    unsigned mn = min(__vimin3_u32(m[0], m[1], m[2]), m[3]);
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, 1));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, 2));
    if (mn < best[h]) {  // strict: an equal minimum keeps the earlier tile
      best[h] = mn;
      best_tile[h] = tile;
    }
  }
}

// The first point of the winning tile nearest to query xq on the CUDA cores
// (d = |y|^2 - 2 x.y as fp32 FMAs), over the
// quad's 128 columns: this lane's 32 (8j + 2t + e), then the quad's
// smallest (distance, index). Every lane calls it (the shuffles).
template <int CP>
__device__ __forceinline__ int argmin_in_tile(const float* xq, const float* yr, int tile, int M,
                                              int t) {
  float nx[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) nx[c] = xq != nullptr ? -2.f * xq[c] : 0.f;
  float bv = CUDART_INF_F;
  int bi = 0x7fffffff;
  if (xq != nullptr) {
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int m = tile * kTile + 8 * (k / 2) + 2 * t + (k % 2);
      if (m < M) {
        float yv[CP], dd = 0.f;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          yv[c] = yr[static_cast<size_t>(m) * CP + c];
          dd = fmaf(yv[c], yv[c], dd);
        }
#pragma unroll
        for (int c = 0; c < CP; ++c) dd = fmaf(nx[c], yv[c], dd);
        if (dd < bv) {
          bv = dd;
          bi = m;
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi;
}

template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
nn_argmin_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ ws, int* __restrict__ out, int N, int M) {
  using P = Packing<CP>;
  static_assert(P::kK % (4 * kWarpgroups) == 0, "a row's chunks split evenly over the warpgroups");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  const int r = blockIdx.y;
  const int n_tiles = (M + kTile - 1) / kTile;
  const float* xr = x + static_cast<size_t>(r) * N * CP;
  const float* yr = y + static_cast<size_t>(r) * M * CP;
  const float* wsr = ws + static_cast<size_t>(r) * n_tiles * kTile * P::kK;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kThreads);       // every thread's cp.async arrival
      mbar_init(&empty[s], kThreads / 32);  // every warp, done with the tile
    }
    mbar_fence_init();
  }
  __syncthreads();

  // A fragments of this thread's rows g, g + 8 of the warpgroup's block
  const int row = blockIdx.x * kQueries + wg * 64 + 16 * warp + g;
  const float* xq[2] = {row < N ? xr + static_cast<size_t>(row) * CP : nullptr,
                        row + 8 < N ? xr + static_cast<size_t>(row + 8) * CP : nullptr};
  uint32_t a[P::kSteps][4];
  {
    const float s0 = row_offset<CP>(xq[0]), s1 = row_offset<CP>(xq[1]);
#pragma unroll
    for (int s = 0; s < P::kSteps; ++s) {
      a[s][0] = a_packed<CP>(xq[0], s0, 8 * s + t);
      a[s][1] = a_packed<CP>(xq[1], s1, 8 * s + t);
      a[s][2] = a_packed<CP>(xq[0], s0, 8 * s + t + 4);
      a[s][3] = a_packed<CP>(xq[1], s1, 8 * s + t + 4);
    }
  }
  unsigned best[2] = {0xffffffffu, 0xffffffffu};
  int best_tile[2] = {0, 0};

  // Each thread copies its warpgroup's chunks of point sp of a tile
  // straight from the workspace into the ring by cp.async, kStages - 1
  // tiles ahead: full[s] completes when every thread's copies into slot s
  // have landed, empty[s] when every warp is done with the tile there.
  const int sp = tid % 128;
  const auto issue = [&](int jt) {
    const int s = jt % kStages;
    if (jt >= kStages) mbar_wait(&empty[s], (jt / kStages - 1) & 1);
    uint8_t* tile = smem + s * kTileBytes;
    const float* src = wsr + static_cast<size_t>(jt * kTile + sp) * P::kK;
#pragma unroll
    for (int q = 0; q < kChunksPerWarpgroup<CP>; ++q) {
      const int chunk = wg * kChunksPerWarpgroup<CP> + q;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(tile + sp * 128 + ((chunk ^ (sp & 7)) << 4))),
                   "l"(src + 4 * chunk)
                   : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(&full[s]))
                 : "memory");
  };
  for (int jt = 0; jt < kStages - 1 && jt < n_tiles; ++jt) issue(jt);

  float acc[64];
  for (int j = 0; j < n_tiles; ++j) {
    if (j + kStages - 1 < n_tiles) issue(j + kStages - 1);
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async's writes, to wgmma
    product<CP>(acc, a, smem_addr(smem + s * kTileBytes));
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    fence_regs(acc);
    fence_frags(a);
    epilogue(acc, j, best, best_tile);
  }

  // the nearest point inside each row's winning tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int arg = argmin_in_tile<CP>(xq[h], yr, best_tile[h], M, t);
    if (t == 0 && row + 8 * h < N) out[static_cast<size_t>(r) * N + row + 8 * h] = arg;
  }
}

template <int CP>
int launch(const float* x, const float* y, int* out, float* ws, int R, int N, int M,
           cudaStream_t s) {
  const int Mp = (M + kTile - 1) / kTile * kTile;
  const long long points = static_cast<long long>(R) * Mp;
  pack_y_kernel<CP><<<static_cast<unsigned>((points + 255) / 256), 256, 0, s>>>(y, ws, R, M, Mp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(nn_argmin_tf32x3_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kQueries - 1) / kQueries, R);
  nn_argmin_tf32x3_kernel<CP><<<grid, kThreads, kSmemBytes, s>>>(x, y, ws, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the workspace a call needs: (R, M rounded up to 128, K). The
// wrapper allocates it by this size.
extern "C" long long nn_argmin_workspace(int R, int M, int C) {
  const long long K = C == 3 ? Packing<3>::kK : Packing<8>::kK;
  return static_cast<long long>(R) * ((M + kTile - 1) / kTile * kTile) * K;
}

// x (R, N, C), y (R, M, C) fp32 contiguous with C in {3, 8}; out (R, N)
// int32; ws nn_argmin_workspace(R, M, C) floats. Launches the pre-pass and
// the kernel on `stream` and returns cudaGetLastError() as an int.
extern "C" int nn_argmin(const float* x, const float* y, int* out, float* ws, int R, int N,
                         int M, int C, void* stream) {
  if (R <= 0 || N <= 0 || M <= 0 || R > 65535 || ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) return launch<3>(x, y, out, ws, R, N, M, s);
  if (C == 8) return launch<8>(x, y, out, ws, R, N, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
