// Fused per-head qk rms-norm + half-layout RoPE for Hopper (sm_90a), kernel
// B: a forward and a backward kernel.
//
// Replaces the Pallas TPU kernel of the JAX package
//   actionmesh_tpu/ops/rope_norm.py:fused_rms_rope (pallas_call :94, body
//   _norm_rope_kernel),
// whose backward is the vjp of the plain composition (_fused_bwd); here the
// backward is a kernel too. Contract: x (B, H, S, D), D in {64, 128}, bf16,
// fp16 or fp32, element strides for batch, head and sequence with a
// contiguous last axis and 16-byte aligned rows; scale (D,) fp32 or none;
// cos and sin fp32 contiguous (cb, S, D), table b % cb serving batch entry b,
// or none. With halves 1 = [0, D/2) and 2 = [D/2, D), in fp32:
//   forward   r = rsqrt(mean(x^2) + eps), u = x r w  (no norm: u = x)
//             y1 = u1 c1 - u2 s1, y2 = u2 c2 + u1 s2  (no rope: y = u),
//             rounded once to x's dtype;
//   backward  from g = dL/dy: gu1 = g1 c1 + g2 s2, gu2 = g2 c2 - g1 s1 (no
//             rope: gu = g); dx = r (gu w) - x r^3 mean(gu w x) (no norm:
//             dx = gu), rounded to x's dtype; dscale = sum over every (b, h,
//             s) of gu x r; dcos = g u and dsin = g rot(u), rot(u) = (-u2,
//             u1), summed over the heads and the batch entries that share a
//             table.
//
// What bounds it: ~10 (forward) to ~30 (backward) fp32 operations an
// element against 2 bf16 elements of traffic (forward: x in, y out) or 3
// (backward: x and g in, dx out), far below the card's balance point:
// device-memory bandwidth. At the inference path's small rows (Stage 0's
// DiT q/k, (2, 16, 2049, 128) bf16, 33.6 MB in and out, 10 us at 3.35 TB/s)
// the host's launch path is of the same order, so the kernel is a plain C
// entry point called through ctypes by a wrapper that reads no device
// memory and never synchronises.
//
// Design: x is a (B, H, S, D) view of a (B, S, H*D) projection, so one (b, s)
// row of all heads is H*D contiguous values. One warp takes one (b, s) row
// (the backward: a grid-stride run of rows) and loops over its heads. Each
// lane holds V = 16 / sizeof(T) values of half 1 and the V values of half 2
// that the rotation pairs with them, so the rotation stays in registers;
// D/2/V lanes share a head and the sums over D (x^2 and, backward, gu w x)
// are xor shuffles among them; 32 / (D/2/V) heads go at once. Every access
// of x, g, y and dx is a 16-byte load or store. The fp32 cos/sin values of
// (b % cb, s) are read once a row, into registers, and serve every head. No
// shared memory, except for the backward's last reduction.
// The backward's reductions are deterministic, with no float atomics:
//   * dscale: each lane sums gu x r over its rows and heads; the warp's head
//     groups and the block's warps are combined in a fixed order into one
//     (D,) partial a block in a workspace, and sum_rows_kernel adds the
//     blocks' partials in block order;
//   * dcos, dsin (only when asked for): each row's sums over its heads go
//     to a (2, B, S, D) workspace, and sum_tables_kernel adds the batch
//     entries b = c, c + cb, ... of each table c in that order.
// The backward's grid is the number of blocks that fit on the card at once
// (at most kMaxBwdBlocks), so a second call gives bit-equal results.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBwdBlocks = 1024;  // rows of the dscale workspace
constexpr int kSumThreads = 1024;

struct Params {
  const void* x;
  const void* g;   // backward: dL/dy
  void* y;         // forward: the output; backward: dx
  const float* scale;
  const float* cos;
  const float* sin;
  float* dscale_ws;  // backward with norm: (gridDim.x, D) partial sums of dscale
  float* tab_ws;     // backward with table gradients: (2, B, S, D) per-row sums
  long long x_sb, x_sh, x_ss, g_sb, g_sh, g_ss, y_sb, y_sh, y_ss;
  int B, H, S, cb;
  float eps;
};

// 16-byte vectors of T, as fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __half* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p, const float (&v)[8]) {
    uint4 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// Sum over the `lanes` lanes that share a head (every lane of the warp calls it).
template <int lanes>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int off = lanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the warp's head groups of `lanes` lanes each (same columns).
template <int lanes>
__device__ __forceinline__ float across_heads(float v) {
#pragma unroll
  for (int off = lanes; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lane layout of a row: V values of each half a lane, LPH lanes a head,
// HPW heads at once.
template <typename T, int D>
struct Layout {
  static constexpr int V = Vec<T>::N;
  static constexpr int HALF = D / 2;
  static constexpr int LPH = HALF / V;
  static constexpr int HPW = 32 / LPH;
};

template <int V>
struct Tables {
  float c1[V], c2[V], s1[V], s2[V];
  __device__ __forceinline__ void load(const Params& p, int b, int s, int D, int c0) {
    const long long off = (static_cast<long long>(b % p.cb) * p.S + s) * D + c0;
    load_f32<V>(p.cos + off, c1);
    load_f32<V>(p.cos + off + D / 2, c2);
    load_f32<V>(p.sin + off, s1);
    load_f32<V>(p.sin + off + D / 2, s2);
  }
};

template <typename T, int D, bool NORM, bool ROPE>
__global__ void __launch_bounds__(kThreads) rms_rope_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int V = L::V;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(p.B) * p.S) return;  // the whole warp
  const int b = static_cast<int>(row / p.S), s = static_cast<int>(row % p.S);
  const int hg = lane / L::LPH, c0 = (lane % L::LPH) * V;
  float w1[V], w2[V];
  if (NORM) {
    load_f32<V>(p.scale + c0, w1);
    load_f32<V>(p.scale + L::HALF + c0, w2);
  }
  Tables<V> tab;
  if (ROPE) tab.load(p, b, s, D, c0);
  const T* xrow = static_cast<const T*>(p.x) + b * p.x_sb + s * p.x_ss + c0;
  T* yrow = static_cast<T*>(p.y) + b * p.y_sb + s * p.y_ss + c0;
#pragma unroll 2
  for (int h0 = 0; h0 < p.H; h0 += L::HPW) {
    const int h = h0 + hg;
    const bool on = h < p.H;
    float x1[V], x2[V];
    if (on) {
      Vec<T>::load(xrow + h * p.x_sh, x1);
      Vec<T>::load(xrow + h * p.x_sh + L::HALF, x2);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x1[i] = x2[i] = 0.f;
    }
    if (NORM) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) ss = fmaf(x2[i], x2[i], fmaf(x1[i], x1[i], ss));
      const float r = rsqrtf(head_sum<L::LPH>(ss) * (1.f / D) + p.eps);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x1[i] = x1[i] * r * w1[i];
        x2[i] = x2[i] * r * w2[i];
      }
    }
    if (ROPE) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u1 = x1[i], u2 = x2[i];
        x1[i] = u1 * tab.c1[i] - u2 * tab.s1[i];
        x2[i] = u2 * tab.c2[i] + u1 * tab.s2[i];
      }
    }
    if (on) {
      Vec<T>::store(yrow + h * p.y_sh, x1);
      Vec<T>::store(yrow + h * p.y_sh + L::HALF, x2);
    }
  }
}

template <typename T, int D, bool NORM, bool ROPE, bool TABLES>
__global__ void __launch_bounds__(kThreads) rms_rope_bwd_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int V = L::V;
  __shared__ float dw_warps[kWarps][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hg = lane / L::LPH, c0 = (lane % L::LPH) * V;
  float w1[V], w2[V], dw1[V], dw2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) dw1[i] = dw2[i] = 0.f;
  if (NORM) {
    load_f32<V>(p.scale + c0, w1);
    load_f32<V>(p.scale + L::HALF + c0, w2);
  }
  const long long rows = static_cast<long long>(p.B) * p.S;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(row / p.S), s = static_cast<int>(row % p.S);
    Tables<V> tab;
    if (ROPE) tab.load(p, b, s, D, c0);
    float dc1[V], dc2[V], ds1[V], ds2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) dc1[i] = dc2[i] = ds1[i] = ds2[i] = 0.f;
    const T* xrow = static_cast<const T*>(p.x) + b * p.x_sb + s * p.x_ss + c0;
    const T* grow = static_cast<const T*>(p.g) + b * p.g_sb + s * p.g_ss + c0;
    T* dxrow = static_cast<T*>(p.y) + b * p.y_sb + s * p.y_ss + c0;
    for (int h0 = 0; h0 < p.H; h0 += L::HPW) {
      const int h = h0 + hg;
      const bool on = h < p.H;
      float x1[V], x2[V], g1[V], g2[V];
      if (on) {
        Vec<T>::load(xrow + h * p.x_sh, x1);
        Vec<T>::load(xrow + h * p.x_sh + L::HALF, x2);
        Vec<T>::load(grow + h * p.g_sh, g1);
        Vec<T>::load(grow + h * p.g_sh + L::HALF, g2);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) x1[i] = x2[i] = g1[i] = g2[i] = 0.f;
      }
      float gu1[V], gu2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        gu1[i] = ROPE ? g1[i] * tab.c1[i] + g2[i] * tab.s2[i] : g1[i];
        gu2[i] = ROPE ? g2[i] * tab.c2[i] - g1[i] * tab.s1[i] : g2[i];
      }
      float dx1[V], dx2[V], u1[V], u2[V];
      if (NORM) {
        float ss = 0.f, dot = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ss = fmaf(x2[i], x2[i], fmaf(x1[i], x1[i], ss));
          dot = fmaf(gu2[i] * w2[i], x2[i], fmaf(gu1[i] * w1[i], x1[i], dot));
        }
        const float r = rsqrtf(head_sum<L::LPH>(ss) * (1.f / D) + p.eps);
        const float k = r * r * r * head_sum<L::LPH>(dot) * (1.f / D);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dx1[i] = r * (gu1[i] * w1[i]) - x1[i] * k;
          dx2[i] = r * (gu2[i] * w2[i]) - x2[i] * k;
          const float n1 = x1[i] * r, n2 = x2[i] * r;
          dw1[i] = fmaf(gu1[i], n1, dw1[i]);
          dw2[i] = fmaf(gu2[i], n2, dw2[i]);
          u1[i] = n1 * w1[i];
          u2[i] = n2 * w2[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dx1[i] = gu1[i];
          dx2[i] = gu2[i];
          u1[i] = x1[i];
          u2[i] = x2[i];
        }
      }
      if (TABLES) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dc1[i] = fmaf(g1[i], u1[i], dc1[i]);
          dc2[i] = fmaf(g2[i], u2[i], dc2[i]);
          ds1[i] = fmaf(-g1[i], u2[i], ds1[i]);
          ds2[i] = fmaf(g2[i], u1[i], ds2[i]);
        }
      }
      if (on) {
        Vec<T>::store(dxrow + h * p.y_sh, dx1);
        Vec<T>::store(dxrow + h * p.y_sh + L::HALF, dx2);
      }
    }
    if (TABLES) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dc1[i] = across_heads<L::LPH>(dc1[i]);
        dc2[i] = across_heads<L::LPH>(dc2[i]);
        ds1[i] = across_heads<L::LPH>(ds1[i]);
        ds2[i] = across_heads<L::LPH>(ds2[i]);
      }
      if (hg == 0) {
        float* dcos = p.tab_ws + row * D + c0;
        float* dsin = dcos + rows * D;
        store_f32<V>(dcos, dc1);
        store_f32<V>(dcos + L::HALF, dc2);
        store_f32<V>(dsin, ds1);
        store_f32<V>(dsin + L::HALF, ds2);
      }
    }
  }
  if (NORM) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dw1[i] = across_heads<L::LPH>(dw1[i]);
      dw2[i] = across_heads<L::LPH>(dw2[i]);
    }
    if (hg == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dw_warps[warp][c0 + i] = dw1[i];
        dw_warps[warp][L::HALF + c0 + i] = dw2[i];
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += dw_warps[w][d];
      p.dscale_ws[static_cast<long long>(blockIdx.x) * D + d] = sum;
    }
  }
}

// out[d] = sum over the n rows of ws (n, D) in row order, d < D.
__global__ void __launch_bounds__(kSumThreads) sum_rows_kernel(const float* __restrict__ ws,
                                                               float* __restrict__ out, int n, int D) {
  __shared__ float part[kSumThreads];
  const int groups = kSumThreads / D, d = threadIdx.x % D, grp = threadIdx.x / D;
  float sum = 0.f;
  // group grp sums rows [grp * per, (grp + 1) * per) in order
  const int per = (n + groups - 1) / groups;
  const int end = min(n, (grp + 1) * per);
  for (int i = grp * per; i < end; ++i) sum += ws[static_cast<long long>(i) * D + d];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (grp == 0) {
    for (int k = 1; k < groups; ++k) sum += part[k * D + d];
    out[d] = sum;
  }
}

// out (2, cb, S, D): table c, element e = sum over b = c, c + cb, ... < B of
// ws (2, B, S, D), in that order.
__global__ void sum_tables_kernel(const float* __restrict__ ws, float* __restrict__ dcos,
                                  float* __restrict__ dsin, int B, int cb, long long SD) {
  const long long n = static_cast<long long>(cb) * SD;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < 2 * n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int which = static_cast<int>(i / n);
    const long long e = i % n, c = e / SD, off = e % SD;
    const float* src = ws + which * static_cast<long long>(B) * SD;
    float sum = 0.f;
    for (long long b = c; b < B; b += cb) sum += src[b * SD + off];
    (which == 0 ? dcos : dsin)[e] = sum;
  }
}

template <typename T, int D, bool NORM, bool ROPE>
int launch_fwd(const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.S;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  rms_rope_fwd_kernel<T, D, NORM, ROPE><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool NORM, bool ROPE, bool TABLES>
int launch_bwd(const Params& p, float* dscale, float* dcos, float* dsin, cudaStream_t stream) {
  auto kernel = rms_rope_bwd_kernel<T, D, NORM, ROPE, TABLES>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(p.B) * p.S;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int fit = sms * per_sm < 1 ? 1 : (sms * per_sm > kMaxBwdBlocks ? kMaxBwdBlocks : sms * per_sm);
  const int grid = want < fit ? static_cast<int>(want) : fit;
  kernel<<<grid, kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (NORM) {
    sum_rows_kernel<<<1, kSumThreads, 0, stream>>>(p.dscale_ws, dscale, grid, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (TABLES) {
    const long long n = 2LL * p.cb * p.S * D;
    const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    sum_tables_kernel<<<blocks, 256, 0, stream>>>(p.tab_ws, dcos, dsin, p.B, p.cb,
                                                 static_cast<long long>(p.S) * D);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

// Picks the instantiation; dtype 0 bf16, 1 fp16, 2 fp32.
template <typename T, int D>
int dispatch_fwd(const Params& p, bool norm, bool rope, cudaStream_t s) {
  if (norm && rope) return launch_fwd<T, D, true, true>(p, s);
  if (norm) return launch_fwd<T, D, true, false>(p, s);
  if (rope) return launch_fwd<T, D, false, true>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int dispatch_bwd(const Params& p, bool norm, bool rope, bool tables, float* dscale, float* dcos,
                 float* dsin, cudaStream_t s) {
  if (norm && rope && tables) return launch_bwd<T, D, true, true, true>(p, dscale, dcos, dsin, s);
  if (norm && rope) return launch_bwd<T, D, true, true, false>(p, dscale, dcos, dsin, s);
  if (norm) return launch_bwd<T, D, true, false, false>(p, dscale, dcos, dsin, s);
  if (rope && tables) return launch_bwd<T, D, false, true, true>(p, dscale, dcos, dsin, s);
  if (rope) return launch_bwd<T, D, false, true, false>(p, dscale, dcos, dsin, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_dim_fwd(const Params& p, int D, bool norm, bool rope, cudaStream_t s) {
  if (D == 128) return dispatch_fwd<T, 128>(p, norm, rope, s);
  if (D == 64) return dispatch_fwd<T, 64>(p, norm, rope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_dim_bwd(const Params& p, int D, bool norm, bool rope, bool tables, float* dscale,
               float* dcos, float* dsin, cudaStream_t s) {
  if (D == 128) return dispatch_bwd<T, 128>(p, norm, rope, tables, dscale, dcos, dsin, s);
  if (D == 64) return dispatch_bwd<T, 64>(p, norm, rope, tables, dscale, dcos, dsin, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* x, const void* g, void* y, const float* scale, const float* cos,
                   const float* sin, const long long* strides, int B, int H, int S, int cb, float eps) {
  Params p = {};
  p.x = x; p.g = g; p.y = y; p.scale = scale; p.cos = cos; p.sin = sin;
  p.x_sb = strides[0]; p.x_sh = strides[1]; p.x_ss = strides[2];
  p.g_sb = strides[3]; p.g_sh = strides[4]; p.g_ss = strides[5];
  p.y_sb = strides[6]; p.y_sh = strides[7]; p.y_ss = strides[8];
  p.B = B; p.H = H; p.S = S; p.cb = cb; p.eps = eps;
  return p;
}

}  // namespace

// Forward: y = rope(rms_norm(x) * scale) of x (B, H, S, D); scale null skips
// the norm, cos/sin null the rotation. One parameter block p of 19 int64
// (one ctypes argument keeps the host's work per call small): pointers x, y,
// scale, cos, sin; x's strides (b, h, s), y's; B, H, S, D, cb, dtype; eps's
// fp32 bits; the stream.
extern "C" int rms_rope_fwd(const long long* p) {
  const int B = static_cast<int>(p[11]), H = static_cast<int>(p[12]), S = static_cast<int>(p[13]);
  const int D = static_cast<int>(p[14]), cb = static_cast<int>(p[15]), dtype = static_cast<int>(p[16]);
  if (B <= 0 || H <= 0 || S <= 0 || cb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int eps_bits = static_cast<int>(p[17]);
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  const long long strides[9] = {p[5], p[6], p[7], 0, 0, 0, p[8], p[9], p[10]};
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(p[i])); };
  const Params q = make_params(ptr(0), nullptr, ptr(1), static_cast<const float*>(ptr(2)),
                               static_cast<const float*>(ptr(3)), static_cast<const float*>(ptr(4)),
                               strides, B, H, S, cb, eps);
  const bool norm = q.scale != nullptr, rope = q.cos != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(ptr(18));
  if (dtype == 0) return by_dim_fwd<__nv_bfloat16>(q, D, norm, rope, s);
  if (dtype == 1) return by_dim_fwd<__half>(q, D, norm, rope, s);
  if (dtype == 2) return by_dim_fwd<float>(q, D, norm, rope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward from g: dx (x's dtype, its own strides); with the norm, dscale
// (D,) fp32 through ws (kMaxBwdBlocks rows of D); with dcos and dsin
// non-null, their (cb, S, D) sums through tab_ws (2, B, S, D). strides:
// x's, g's, dx's (b, h, s).
extern "C" int rms_rope_bwd(const void* x, const void* g, void* dx, const float* scale,
                            const float* cos, const float* sin, float* dscale, float* dcos,
                            float* dsin, float* ws, float* tab_ws, const long long* strides,
                            int B, int H, int S, int D, int cb, int dtype, float eps,
                            void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || cb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool norm = scale != nullptr, rope = cos != nullptr, tables = dcos != nullptr;
  if ((norm && (dscale == nullptr || ws == nullptr)) || (tables && (!rope || tab_ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(x, g, dx, scale, cos, sin, strides, B, H, S, cb, eps);
  p.dscale_ws = ws;
  p.tab_ws = tab_ws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim_bwd<__nv_bfloat16>(p, D, norm, rope, tables, dscale, dcos, dsin, s);
  if (dtype == 1) return by_dim_bwd<__half>(p, D, norm, rope, tables, dscale, dcos, dsin, s);
  if (dtype == 2) return by_dim_bwd<float>(p, D, norm, rope, tables, dscale, dcos, dsin, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows of the dscale workspace the backward needs at most.
extern "C" int rms_rope_bwd_ws_rows() { return kMaxBwdBlocks; }
