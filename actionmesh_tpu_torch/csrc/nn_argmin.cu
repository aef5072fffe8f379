// Nearest-neighbour argmin for Hopper (sm_90a), kernel E.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   actionmesh_tpu/ops/nn_argmin.py:nn_argmin (pallas_call :148)
// and meets its contract: x (R, N, C), y (R, M, C) fp32, contiguous; out
// (R, N) int32 holds, for every x[r, i], the index j of the y[r, j] nearest
// to it in squared euclidean distance. Ties go to the smallest j. Inputs are
// taken to be finite (the ICP caller samples finite meshes only).
//
// The distance is d = |y|^2 - 2 x.y; |x|^2 is the same for every j of a row
// and is left out, as in the TPU kernel. Each d is three fp32 FMAs on the
// CUDA cores. No tensor cores: the contraction is 3 wide, and TF32 would flip
// argmins between genuinely different neighbours (the TPU kernel splits its
// MXU product into a compensated bf16 sum for the same reason).
//
// What bounds it: at the ICP shapes (R = 384, N = M = 10,000) a call is
// 3.84e10 (x, y) pairs at ~5 FP32-pipe instructions each (3 FMAs, a compare,
// a select) against ~92 MB of input, so the FP32 pipe, not memory, is the
// limit. Nothing of size N x M is ever written: the plain version writes and
// reads back the whole distance matrix.
//
// Design (first, simple version): a block of 128 threads owns 1,024 queries
// of one problem r (8 per thread, strided by 128 so that the loads of x and
// the stores of out are coalesced). Each thread keeps -2x of its queries in
// registers with a running (min, argmin). y is staged through shared memory
// tile by tile as float4 (y0, y1, y2, |y|^2); every thread reads the same
// entry at once (a broadcast), so one 16-byte load feeds 8 distances. The
// sweep over j is ascending and the update is a strict `<`, which gives the
// smallest index on ties; every query is owned by one thread, so no combine
// across threads is needed. The ragged N and M edges are handled by bounds.
// C <= 3 runs as 3 channels and 3 < C <= 8 as 8 (the wrapper pads with
// zeros, which add nothing to a distance); a staged point is then three
// float4 (8 channels, |y|^2, 3 unused).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 8;
constexpr int kBlockN = kThreads * kQueriesPerThread;  // queries per block
constexpr int kStageFloat4 = 1024;                     // 16 KB of staged y

template <int CP>
__global__ void __launch_bounds__(kThreads)
nn_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int* __restrict__ out, int N, int M) {
  constexpr int NV = (CP + 4) / 4;          // float4 per staged point
  constexpr int kTile = kStageFloat4 / NV;  // y points per tile
  __shared__ float4 sy[kTile * NV];

  const int r = blockIdx.y;
  const float* xr = x + static_cast<size_t>(r) * N * CP;
  const float* yr = y + static_cast<size_t>(r) * M * CP;

  float nx[kQueriesPerThread][CP];  // -2 x
  float best[kQueriesPerThread];
  int arg[kQueriesPerThread];
#pragma unroll
  for (int q = 0; q < kQueriesPerThread; ++q) {
    const int i = blockIdx.x * kBlockN + q * kThreads + threadIdx.x;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      nx[q][c] = i < N ? -2.0f * xr[static_cast<size_t>(i) * CP + c] : 0.0f;
    }
    best[q] = CUDART_INF_F;
    arg[q] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int count = min(kTile, M - m0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < count; j += kThreads) {
      float v[4 * NV];
      float sq = 0.0f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = yr[static_cast<size_t>(m0 + j) * CP + c];
        sq = fmaf(v[c], v[c], sq);
      }
      v[CP] = sq;
#pragma unroll
      for (int c = CP + 1; c < 4 * NV; ++c) v[c] = 0.0f;
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        sy[j * NV + w] = make_float4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      float v[4 * NV];
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        const float4 t = sy[j * NV + w];
        v[4 * w] = t.x;
        v[4 * w + 1] = t.y;
        v[4 * w + 2] = t.z;
        v[4 * w + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < kQueriesPerThread; ++q) {
        float d = v[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) d = fmaf(nx[q][c], v[c], d);
        if (d < best[q]) {
          best[q] = d;
          arg[q] = m0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQueriesPerThread; ++q) {
    const int i = blockIdx.x * kBlockN + q * kThreads + threadIdx.x;
    if (i < N) out[static_cast<size_t>(r) * N + i] = arg[q];
  }
}

}  // namespace

// x (R, N, C), y (R, M, C) fp32 contiguous with C in {3, 8}; out (R, N)
// int32. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int nn_argmin(const float* x, const float* y, int* out, int R, int N,
                         int M, int C, void* stream) {
  if (R <= 0 || N <= 0 || M <= 0 || R > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kBlockN - 1) / kBlockN, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) {
    nn_argmin_kernel<3><<<grid, kThreads, 0, s>>>(x, y, out, N, M);
  } else if (C == 8) {
    nn_argmin_kernel<8><<<grid, kThreads, 0, s>>>(x, y, out, N, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
