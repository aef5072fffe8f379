// Flash attention backward for Hopper (sm_90a): kernel C (dK, dV) and kernel D (dQ).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   actionmesh_tpu/ops/flash_attention_bwd.py:_bwd_dkv_kernel (pallas_call :261) -> kernel C
//   actionmesh_tpu/ops/flash_attention_bwd.py:_bwd_dq_kernel  (pallas_call :287) -> kernel D
// FA2 backward from the forward's residuals: q, k, v, dO (B,H,S,D) and the
// per-row log-sum-exp L = m + log l and delta = sum_d dO*O, (B,H,Sq) fp32,
// which the caller computes from kernel A's stats (as XLA does for the TPU):
//   P  = exp(scale * q.k - L)   recomputed per tile exactly as kernel A
//                               produced m and l (fp32 scores times scale)
//   dV = P^T dO                 P rounded to v's dtype first
//   dS = P * (dO.V^T - delta) * scale
//   dK = dS^T Q, dQ = dS K      dS rounded to q's dtype first
//
// The TPU kernels carry an accumulator in VMEM across a sequential grid axis.
// Here a loop inside the block takes that axis' place: a block of kernel C
// owns one (b, h, 64-key tile) and walks every query tile, keeping dK and dV
// in fp32 registers; a block of kernel D owns one (b, h, 64-query tile) and
// walks every key tile, keeping dQ in registers. Two kernels, no atomics: the
// gradients are deterministic. Rows past Sq and keys past Sk are masked by
// bounds (their probability is exactly 0; no padded copies of the inputs).
//
// What bounds it: 8 (C) and 6 (D) x B*H*Sq*Sk*D flops against O((Sq+Sk)*D)
// bytes per (b, h), far above the card's ~295 flop/byte balance point, so it
// is bound by tensor-core throughput and the exp work between the products. This
// first version uses mma.sync and synchronous tile loads; wgmma and TMA come
// later.
//
// Design:
//   * bf16: 4 warps, 16 rows of the block's tile per warp. Every tile lives
//     in shared memory (rows padded by 8 elements: fragment loads and
//     ldmatrix are free of bank conflicts). Products whose right operand is
//     stored [n][k] read B fragments directly; products whose right operand
//     is stored [k][n] (P^T dO, dS^T Q, dS K) read it with ldmatrix.trans.
//     The fp32 accumulator of P or dS, packed to bf16, is the A fragment of
//     the next product. Kernel C walks 32-query tiles (dK and dV take 128
//     registers at D = 128), kernel D 64-key tiles.
//   * fp32: plain FMA (no TF32). 128 threads, 32 rows of the block's tile;
//     each thread computes a 2x4 micro-tile of S and dP, the tile of P / dS
//     goes through shared memory, then each thread accumulates 2 rows x D/8
//     columns of its gradients.
// The caller passes element strides for batch, head and sequence of every
// tensor; the last axis must be contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kRowPad = 1e30f;  // L of rows past Sq: exp(s - L) is exactly 0

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, H, Sq, Sk;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, long long sb, long long sh,
                                             int b, int h) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_ptr_out(void* base, long long sb, long long sh, int b,
                                           int h) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 16 * kWarps;  // rows a block owns (keys in C, queries in D)
constexpr int kDkvBlockQ = 32;          // kernel C: queries per step
constexpr int kDqBlockK = 64;           // kernel D: keys per step

template <int D>
constexpr int dkv_bf16_smem_bytes() {
  return (2 * kTileRows + 2 * kDkvBlockQ) * (D + 8) * 2 + 2 * kDkvBlockQ * 4;
}

template <int D>
constexpr int dq_bf16_smem_bytes() {
  return (2 * kTileRows + 2 * kDqBlockK) * (D + 8) * 2;
}

// rows [row0, row0 + rows) of a (S, D) bf16 matrix -> smem [rows][D + 8];
// rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const __nv_bfloat16* src,
                                               long long ss, int row0, int rows, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ss + col);
    *reinterpret_cast<uint4*>(&dst[r * (D + 8) + col]) = val;
  }
}

// c = A Y^T for 16 rows of A (smem [.][D+8], from row r0) and the N rows of
// Y (smem [N][D+8]): c[j] is the 16 x 8 tile of columns 8j..8j+7.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const uint16_t* As, int r0,
                                        const uint16_t* Ys, int g, int t) {
  constexpr int S = D + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* a0 = As + (r0 + g) * S + kk * 16 + 2 * t;
    const uint16_t* a1 = a0 + 8 * S;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(a0);
    a[1] = *reinterpret_cast<const uint32_t*>(a1);
    a[2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(a1 + 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint16_t* y = Ys + (j * 8 + g) * S + kk * 16 + 2 * t;
      mma_bf16(c[j], a, *reinterpret_cast<const uint32_t*>(y),
               *reinterpret_cast<const uint32_t*>(y + 8));
    }
  }
}

// acc += X Y for X (16 x N) in accumulator layout, rounded to bf16, and Y
// (smem [N][D+8], row-major [k][n]) read with ldmatrix.trans.
template <int D, int N>
__device__ __forceinline__ void mma_xy(float (&acc)[D / 8][4], const float (&x)[N / 8][4],
                                       const uint16_t* Ys, int lane) {
  constexpr int S = D + 8;
  const int mat = lane / 8;  // ldmatrix.x4: (rows 0-7 | 8-15) x (cols jd | jd+1)
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int row = kk * 16 + (mat & 1) * 8 + (lane % 8);
#pragma unroll
    for (int jd = 0; jd < D / 8; jd += 2) {
      uint32_t yb[4];
      ldmatrix_x4_trans(yb, &Ys[row * S + (jd + (mat >> 1)) * 8]);
      mma_bf16(acc[jd], xa, yb[0], yb[1]);
      mma_bf16(acc[jd + 1], xa, yb[2], yb[3]);
    }
  }
}

// Rows r0 + g and r0 + g + 8 of a 16 x D fp32 accumulator -> bf16 in global.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, long long ss, int r0,
                                                int limit, const float (&acc)[D / 8][4],
                                                int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < limit)
      *reinterpret_cast<uint32_t*>(base + ra * ss + col) = pack_bf16(acc[j][0], acc[j][1]);
    if (rb < limit)
      *reinterpret_cast<uint32_t*>(base + rb * ss + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// Kernel C: dK and dV for one (b, h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int S = D + 8;
  constexpr int BQ = kDkvBlockQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Vs = Ks + kTileRows * S;
  uint16_t* Qs = Vs + kTileRows * S;
  uint16_t* dOs = Qs + BQ * S;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * S);
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTileRows;
  const int kr = warp * 16;  // this warp's rows of the key tile
  const bool key_a = k0 + kr + g < p.Sk, key_b = k0 + kr + g + 8 < p.Sk;

  const auto* qbase = head_ptr<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, b, h);
  const auto* kbase = head_ptr<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, b, h);
  const auto* vbase = head_ptr<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, b, h);
  const auto* dobase = head_ptr<__nv_bfloat16>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;

  load_tile_bf16<D>(Ks, kbase, p.k_ss, k0, kTileRows, p.Sk);
  load_tile_bf16<D>(Vs, vbase, p.v_ss, k0, kTileRows, p.Sk);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed
    load_tile_bf16<D>(Qs, qbase, p.q_ss, q0, BQ, p.Sq);
    load_tile_bf16<D>(dOs, dobase, p.do_ss, q0, BQ, p.Sq);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = q0 + i < p.Sq;
      lse_s[i] = in ? p.lse[stat0 + q0 + i] : kRowPad;
      delta_s[i] = in ? p.delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp(scale * K Q^T - L): 16 keys x BQ queries per warp
    float pt[BQ / 8][4];
    mma_abt<D, BQ>(pt, Ks, kr, Qs, g, t);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float l0 = lse_s[j * 8 + 2 * t], l1 = lse_s[j * 8 + 2 * t + 1];
      pt[j][0] = key_a ? __expf(pt[j][0] * p.scale - l0) : 0.f;
      pt[j][1] = key_a ? __expf(pt[j][1] * p.scale - l1) : 0.f;
      pt[j][2] = key_b ? __expf(pt[j][2] * p.scale - l0) : 0.f;
      pt[j][3] = key_b ? __expf(pt[j][3] * p.scale - l1) : 0.f;
    }
    mma_xy<D, BQ>(dv, pt, dOs, lane);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta) * scale
    float ds[BQ / 8][4];
    mma_abt<D, BQ>(ds, Vs, kr, dOs, g, t);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float d0 = delta_s[j * 8 + 2 * t], d1 = delta_s[j * 8 + 2 * t + 1];
      ds[j][0] = pt[j][0] * (ds[j][0] - d0) * p.scale;
      ds[j][1] = pt[j][1] * (ds[j][1] - d1) * p.scale;
      ds[j][2] = pt[j][2] * (ds[j][2] - d0) * p.scale;
      ds[j][3] = pt[j][3] * (ds[j][3] - d1) * p.scale;
    }
    mma_xy<D, BQ>(dk, ds, Qs, lane);  // dK += dS^T Q
  }

  store_rows_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dk, p.dk_sb, p.dk_sh, b, h), p.dk_ss,
                     k0 + kr, p.Sk, dk, g, t);
  store_rows_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dv, p.dv_sb, p.dv_sh, b, h), p.dv_ss,
                     k0 + kr, p.Sk, dv, g, t);
}

// Kernel D: dQ for one (b, h, 64-query tile).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int S = D + 8;
  constexpr int BK = kDqBlockK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* dOs = Qs + kTileRows * S;
  uint16_t* Ks = dOs + kTileRows * S;
  uint16_t* Vs = Ks + BK * S;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTileRows;
  const int qr = warp * 16;  // this warp's rows of the query tile
  const int ra = q0 + qr + g, rb = ra + 8;

  const auto* qbase = head_ptr<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, b, h);
  const auto* kbase = head_ptr<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, b, h);
  const auto* vbase = head_ptr<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, b, h);
  const auto* dobase = head_ptr<__nv_bfloat16>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;
  const float lse_a = ra < p.Sq ? p.lse[stat0 + ra] : kRowPad;
  const float lse_b = rb < p.Sq ? p.lse[stat0 + rb] : kRowPad;
  const float delta_a = ra < p.Sq ? p.delta[stat0 + ra] : 0.f;
  const float delta_b = rb < p.Sq ? p.delta[stat0 + rb] : 0.f;

  load_tile_bf16<D>(Qs, qbase, p.q_ss, q0, kTileRows, p.Sq);
  load_tile_bf16<D>(dOs, dobase, p.do_ss, q0, kTileRows, p.Sq);

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    __syncthreads();  // the previous key tile is consumed
    load_tile_bf16<D>(Ks, kbase, p.k_ss, k0, BK, p.Sk);
    load_tile_bf16<D>(Vs, vbase, p.v_ss, k0, BK, p.Sk);
    __syncthreads();

    // P = exp(scale * Q K^T - L): 16 queries x BK keys per warp
    float pm[BK / 8][4];
    mma_abt<D, BK>(pm, Qs, qr, Ks, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = k0 + j * 8 + 2 * t;
      pm[j][0] = col < p.Sk ? __expf(pm[j][0] * p.scale - lse_a) : 0.f;
      pm[j][1] = col + 1 < p.Sk ? __expf(pm[j][1] * p.scale - lse_a) : 0.f;
      pm[j][2] = col < p.Sk ? __expf(pm[j][2] * p.scale - lse_b) : 0.f;
      pm[j][3] = col + 1 < p.Sk ? __expf(pm[j][3] * p.scale - lse_b) : 0.f;
    }
    // dS = P * (dO V^T - delta) * scale
    float ds[BK / 8][4];
    mma_abt<D, BK>(ds, dOs, qr, Vs, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      ds[j][0] = pm[j][0] * (ds[j][0] - delta_a) * p.scale;
      ds[j][1] = pm[j][1] * (ds[j][1] - delta_a) * p.scale;
      ds[j][2] = pm[j][2] * (ds[j][2] - delta_b) * p.scale;
      ds[j][3] = pm[j][3] * (ds[j][3] - delta_b) * p.scale;
    }
    mma_xy<D, BK>(dq, ds, Ks, lane);  // dQ += dS K
  }

  store_rows_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dq, p.dq_sb, p.dq_sh, b, h), p.dq_ss,
                     q0 + qr, p.Sq, dq, g, t);
}

// ---------------------------------------------------------------------------
// fp32 path: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;  // rows a block owns, and rows per step of its loop

template <int D>
constexpr int f32_smem_bytes() {
  // four [32][D+1] tiles, two [32][33] tiles of P / dS, two stat rows
  return (4 * kF32Rows * (D + 1) + 2 * kF32Rows * (kF32Rows + 1) + 2 * kF32Rows) * 4;
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ss,
                                              int row0, int limit) {
  for (int i = threadIdx.x; i < kF32Rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (row0 + r < limit) ? src[(long long)(row0 + r) * ss + c] : 0.f;
  }
}

// Thread (rg, cg) = (tid / 8, tid % 8) computes x . y for rows 2rg, 2rg+1 of
// X and rows cg + 8j (j < 4) of Y, both smem [32][D+1].
template <int D>
__device__ __forceinline__ void dot_2x4(float (&s)[2][4], const float* Xs, const float* Ys,
                                        int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float xa = Xs[(2 * rg) * (D + 1) + d];
    const float xb = Xs[(2 * rg + 1) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = Ys[(cg + 8 * j) * (D + 1) + d];
      s[0][j] = fmaf(xa, y, s[0][j]);
      s[1][j] = fmaf(xb, y, s[1][j]);
    }
  }
}

// acc[i][jd] += sum_r W[2rg+i][r] * Y[r][cg + 8jd] for W smem [32][33], Y smem [32][D+1].
template <int D>
__device__ __forceinline__ void accum_rows(float (&acc)[2][D / 8], const float* Ws,
                                           const float* Ys, int rg, int cg) {
  for (int r = 0; r < kF32Rows; ++r) {
    const float wa = Ws[(2 * rg) * (kF32Rows + 1) + r];
    const float wb = Ws[(2 * rg + 1) * (kF32Rows + 1) + r];
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const float y = Ys[r * (D + 1) + cg + 8 * jd];
      acc[0][jd] = fmaf(wa, y, acc[0][jd]);
      acc[1][jd] = fmaf(wb, y, acc[1][jd]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* base, long long ss, int r0, int limit,
                                               const float (&acc)[2][D / 8], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 2 * rg + i;
    if (row < limit) {
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) base[(long long)row * ss + cg + 8 * jd] = acc[i][jd];
    }
  }
}

// Kernel C, fp32: dK and dV for one (b, h, 32-key tile).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // [32][D+1]
  float* Vs = Ks + kF32Rows * (D + 1);    // [32][D+1]
  float* Qs = Vs + kF32Rows * (D + 1);    // [32][D+1]
  float* dOs = Qs + kF32Rows * (D + 1);   // [32][D+1]
  float* Ps = dOs + kF32Rows * (D + 1);   // P^T  [key][query], [32][33]
  float* dSs = Ps + kF32Rows * (kF32Rows + 1);  // dS^T [key][query]
  float* lse_s = dSs + kF32Rows * (kF32Rows + 1);
  float* delta_s = lse_s + kF32Rows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int k0 = blockIdx.x * kF32Rows;
  const float* qbase = head_ptr<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* kbase = head_ptr<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* vbase = head_ptr<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dobase = head_ptr<float>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;

  load_tile_f32<D>(Ks, kbase, p.k_ss, k0, p.Sk);
  load_tile_f32<D>(Vs, vbase, p.v_ss, k0, p.Sk);

  float dk[2][D / 8], dv[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += kF32Rows) {
    __syncthreads();
    load_tile_f32<D>(Qs, qbase, p.q_ss, q0, p.Sq);
    load_tile_f32<D>(dOs, dobase, p.do_ss, q0, p.Sq);
    if (tid < kF32Rows) {
      const bool in = q0 + tid < p.Sq;
      lse_s[tid] = in ? p.lse[stat0 + q0 + tid] : kRowPad;
      delta_s[tid] = in ? p.delta[stat0 + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[2][4], dp[2][4];
    dot_2x4<D>(s, Ks, Qs, rg, cg);   // K Q^T
    dot_2x4<D>(dp, Vs, dOs, rg, cg);  // V dO^T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool key_in = k0 + 2 * rg + i < p.Sk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cg + 8 * j;
        const float pv = key_in ? expf(s[i][j] * p.scale - lse_s[qc]) : 0.f;
        Ps[(2 * rg + i) * (kF32Rows + 1) + qc] = pv;
        dSs[(2 * rg + i) * (kF32Rows + 1) + qc] = pv * (dp[i][j] - delta_s[qc]) * p.scale;
      }
    }
    __syncthreads();
    accum_rows<D>(dv, Ps, dOs, rg, cg);  // dV += P^T dO
    accum_rows<D>(dk, dSs, Qs, rg, cg);  // dK += dS^T Q
  }

  store_rows_f32<D>(head_ptr_out<float>(p.dk, p.dk_sb, p.dk_sh, b, h), p.dk_ss, k0, p.Sk, dk,
                    rg, cg);
  store_rows_f32<D>(head_ptr_out<float>(p.dv, p.dv_sb, p.dv_sh, b, h), p.dv_ss, k0, p.Sk, dv,
                    rg, cg);
}

// Kernel D, fp32: dQ for one (b, h, 32-query tile).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [32][D+1]
  float* dOs = Qs + kF32Rows * (D + 1);   // [32][D+1]
  float* Ks = dOs + kF32Rows * (D + 1);   // [32][D+1]
  float* Vs = Ks + kF32Rows * (D + 1);    // [32][D+1]
  float* dSs = Vs + kF32Rows * (D + 1);   // dS [query][key], [32][33]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int q0 = blockIdx.x * kF32Rows;
  const float* qbase = head_ptr<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* kbase = head_ptr<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* vbase = head_ptr<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dobase = head_ptr<float>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * rg + i;
    lse_r[i] = row < p.Sq ? p.lse[stat0 + row] : kRowPad;
    delta_r[i] = row < p.Sq ? p.delta[stat0 + row] : 0.f;
  }

  load_tile_f32<D>(Qs, qbase, p.q_ss, q0, p.Sq);
  load_tile_f32<D>(dOs, dobase, p.do_ss, q0, p.Sq);

  float dq[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += kF32Rows) {
    __syncthreads();
    load_tile_f32<D>(Ks, kbase, p.k_ss, k0, p.Sk);
    load_tile_f32<D>(Vs, vbase, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[2][4], dp[2][4];
    dot_2x4<D>(s, Qs, Ks, rg, cg);   // Q K^T
    dot_2x4<D>(dp, dOs, Vs, rg, cg);  // dO V^T
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = cg + 8 * j;
        const float pv = k0 + kc < p.Sk ? expf(s[i][j] * p.scale - lse_r[i]) : 0.f;
        dSs[(2 * rg + i) * (kF32Rows + 1) + kc] = pv * (dp[i][j] - delta_r[i]) * p.scale;
      }
    __syncthreads();
    accum_rows<D>(dq, dSs, Ks, rg, cg);  // dQ += dS K
  }

  store_rows_f32<D>(head_ptr_out<float>(p.dq, p.dq_sb, p.dq_sh, b, h), p.dq_ss, q0, p.Sq, dq,
                    rg, cg);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int rows_total, int tile_rows, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows_total + tile_rows - 1) / tile_rows, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const long long* st, int B, int H, int Sq, int Sk, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = st[0];   p.q_sh = st[1];   p.q_ss = st[2];
  p.k_sb = st[3];   p.k_sh = st[4];   p.k_ss = st[5];
  p.v_sb = st[6];   p.v_sh = st[7];   p.v_ss = st[8];
  p.do_sb = st[9];  p.do_sh = st[10]; p.do_ss = st[11];
  p.dq_sb = st[12]; p.dq_sh = st[13]; p.dq_ss = st[14];
  p.dk_sb = st[15]; p.dk_sh = st[16]; p.dk_ss = st[17];
  p.dv_sb = st[18]; p.dv_sh = st[19]; p.dv_ss = st[20];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.scale = scale;
  return p;
}

}  // namespace

// C entry points, loaded with ctypes. `strides` holds 21 element strides:
// (batch, head, seq) for q, k, v, dO, dq, dk, dv in that order. dtype:
// 0 = bf16, 1 = fp32. Each returns the cudaError_t of its launch (0 = success).

// Kernel C: writes dk and dv (dq is not touched and may be null).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Sq, int Sk, int D,
                             int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, strides, B, H, Sq,
                               Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dkv_bf16_kernel<128>, dkv_bf16_smem_bytes<128>(), Sk, kTileRows, p, s);
  if (dtype == 0 && D == 64)
    return launch(flash_bwd_dkv_bf16_kernel<64>, dkv_bf16_smem_bytes<64>(), Sk, kTileRows, p, s);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dkv_f32_kernel<128>, f32_smem_bytes<128>(), Sk, kF32Rows, p, s);
  if (dtype == 1 && D == 64)
    return launch(flash_bwd_dkv_f32_kernel<64>, f32_smem_bytes<64>(), Sk, kF32Rows, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D: writes dq (dk and dv are not touched and may be null).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            const long long* strides, int B, int H, int Sq, int Sk, int D,
                            int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, strides, B, H,
                               Sq, Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dq_bf16_kernel<128>, dq_bf16_smem_bytes<128>(), Sq, kTileRows, p, s);
  if (dtype == 0 && D == 64)
    return launch(flash_bwd_dq_bf16_kernel<64>, dq_bf16_smem_bytes<64>(), Sq, kTileRows, p, s);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dq_f32_kernel<128>, f32_smem_bytes<128>(), Sq, kF32Rows, p, s);
  if (dtype == 1 && D == 64)
    return launch(flash_bwd_dq_f32_kernel<64>, f32_smem_bytes<64>(), Sq, kF32Rows, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
