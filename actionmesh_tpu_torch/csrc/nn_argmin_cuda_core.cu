// Nearest-neighbour argmin on the CUDA cores alone (sm_90a): a yardstick for
// kernel E (nn_argmin.cu), used nowhere in the port. chip_smoke.py builds it,
// checks its picks and times it beside kernel E at the evaluator's shape:
// kernel E's tensor-core design is worth its complexity only while it stays
// faster than this simpler one.
//
// Same contract as kernel E: x (R, N, C), y (R, M, C) fp32, contiguous, C in
// {3, 8}; out (R, N) int32, the index of the nearest y, ties to the smallest.
// d = |y|^2 - 2 x.y as an fmaf chain: |y|^2 over the channels, then one fmaf
// a channel; the pick is the first index of the smallest fp32 d, as the
// fp32-FMA design of kernel E before its redesign gave it. A pair costs four
// FP32-pipe instructions: three FMAs and one fminf.
//
// Design:
//   * A thread owns kQ = 8 queries of one problem r (strided by the block
//     size, so loads of x and stores of out are coalesced) and keeps -2x of
//     each in registers. y is staged through shared memory kTile points at
//     a time as float4 (y0, y1, y2, |y|^2) (C = 8: three float4); every
//     thread reads the same entry (a broadcast), so one load feeds kQ
//     distances. Points past M are staged as y = 0, |y|^2 = inf.
//   * The sweep keeps one running fminf a query: no index in the inner loop.
//     After each sub-tile of kSub points, a query whose minimum fell in it
//     (strictly below the minimum before it) records that sub-tile. The sweep
//     is ascending, so the recorded sub-tile is the first that holds the
//     query's smallest distance.
//   * After the sweep each thread recomputes its queries' distances over the
//     recorded sub-tile, with the same FMAs in the same order (bit-equal),
//     and takes the first point equal to the minimum: ties go to the
//     smallest index.
//   * The block size is chosen per call from 64 to 256 threads so that the
//     grid (N / (8 * threads), R) fills the SMs in whole waves as nearly as
//     the occupancy allows (cudaOccupancyMaxActiveBlocksPerMultiprocessor).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQ = 8;             // queries a thread
constexpr int kSub = 64;          // points a sub-tile: the unit of the recorded minimum
constexpr int kTile = 256;        // points staged in shared memory at once
constexpr int kMaxThreads = 256;  // block sizes 64, 96, ..., 256

// |v|^2 as an fmaf chain over the channels; the sweep and the rescan both
// form it so, bit for bit.
template <int CP>
__device__ __forceinline__ float sq_norm(const float (&v)[CP]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CP; ++c) s = fmaf(v[c], v[c], s);
  return s;
}

template <int CP>
__global__ void __launch_bounds__(kMaxThreads)
nn_argmin_cuda_core_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           int* __restrict__ out, int N, int M) {
  constexpr int NV = (CP + 4) / 4;  // float4 a staged point
  __shared__ float4 sy[kTile * NV];

  const int r = blockIdx.y, T = blockDim.x, tid = threadIdx.x;
  const float* xr = x + static_cast<size_t>(r) * N * CP;
  const float* yr = y + static_cast<size_t>(r) * M * CP;
  const int base = blockIdx.x * kQ * T + tid;

  float nx[kQ][CP];  // -2 x
  float best[kQ];
  int sub[kQ];  // the first sub-tile holding best
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = base + q * T;
#pragma unroll
    for (int c = 0; c < CP; ++c) nx[q][c] = i < N ? -2.f * xr[static_cast<size_t>(i) * CP + c] : 0.f;
    best[q] = CUDART_INF_F;
    sub[q] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int count = min(kTile, M - m0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = tid; j < kTile; j += T) {
      float v[4 * NV] = {};
      if (j < count) {
        float p[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) p[c] = yr[static_cast<size_t>(m0 + j) * CP + c];
#pragma unroll
        for (int c = 0; c < CP; ++c) v[c] = p[c];
        v[CP] = sq_norm<CP>(p);
      } else {
        v[CP] = CUDART_INF_F;
      }
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        sy[j * NV + w] = make_float4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
      }
    }
    __syncthreads();

    const int subs = (count + kSub - 1) / kSub;
    for (int s = 0; s < subs; ++s) {
      float before[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) before[q] = best[q];
#pragma unroll 4
      for (int j = s * kSub; j < (s + 1) * kSub; ++j) {
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
        for (int q = 0; q < kQ; ++q) {
          float d = v[CP];
#pragma unroll
          for (int c = 0; c < CP; ++c) d = fmaf(nx[q][c], v[c], d);
          best[q] = fminf(best[q], d);
        }
      }
      const int at = m0 / kSub + s;
#pragma unroll
      for (int q = 0; q < kQ; ++q) sub[q] = best[q] < before[q] ? at : sub[q];
    }
  }

  // the first point of the recorded sub-tile at the minimum
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    const int i = base + q * T;
    if (i >= N) continue;
    const int j1 = min((sub[q] + 1) * kSub, M);
    int arg = sub[q] * kSub;
    for (int j = arg; j < j1; ++j) {
      float p[CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) p[c] = yr[static_cast<size_t>(j) * CP + c];
      float d = sq_norm<CP>(p);
#pragma unroll
      for (int c = 0; c < CP; ++c) d = fmaf(nx[q][c], p[c], d);
      if (d == best[q]) {
        arg = j;
        break;
      }
    }
    out[static_cast<size_t>(r) * N + i] = arg;
  }
}

// The block size whose grid fills the SMs best: the least of rounds x
// (resident blocks an SM x threads a block), the time of the whole grid in
// units of one thread's sweep, over 64, 96, ..., 256 threads.
template <int CP>
int block_size(int R, int N, int& threads) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long best_cost = -1;
  for (int t = 64; t <= kMaxThreads; t += 32) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_argmin_cuda_core_kernel<CP>, t, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm == 0) continue;
    const long long blocks = static_cast<long long>(R) * ((N + kQ * t - 1) / (kQ * t));
    const long long resident = static_cast<long long>(per_sm) * sms;
    const long long cost = (blocks + resident - 1) / resident * per_sm * t;
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      threads = t;
    }
  }
  return best_cost < 0 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int CP>
int launch(const float* x, const float* y, int* out, int R, int N, int M, cudaStream_t s) {
  int threads = 0;
  const int err = block_size<CP>(R, N, threads);
  if (err != 0) return err;
  const dim3 grid((N + kQ * threads - 1) / (kQ * threads), R);
  nn_argmin_cuda_core_kernel<CP><<<grid, threads, 0, s>>>(x, y, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, N, C), y (R, M, C) fp32 contiguous with C in {3, 8}; out (R, N)
// int32. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int nn_argmin_cuda_core(const float* x, const float* y, int* out, int R, int N, int M,
                                   int C, void* stream) {
  if (R <= 0 || N <= 0 || M <= 0 || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) return launch<3>(x, y, out, R, N, M, s);
  if (C == 8) return launch<8>(x, y, out, R, N, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
