// Flash attention forward for Hopper (sm_90a): online softmax, fp32 statistics.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   actionmesh_tpu/ops/flash_attention.py:flash_attention_pipelined (pallas_call :302)
//   actionmesh_tpu/ops/flash_attention.py:flash_attention           (pallas_call :612)
// and meets their shared contract: q (B,H,Sq,D), k/v (B,H,Sk,D), optional
// kv_mask (B,Sk) (nonzero = valid), optional per-row stats (m, l) as (B,H,Sq)
// fp32. Scores are fp32 dot products times `scale`; masked scores are -1e30;
// the output is acc / max(l, 1e-30), so a row with every key masked gives a
// finite mean of v, never NaN. Keys at or beyond Sk are out of bounds and take
// no part (probability exactly 0): the ragged edge is masked here, with no
// padded copies of the inputs.
//
// What bounds it: at the main path's shapes (Sq = Sk = 32,784, D = 128) the
// work is 4*Sq*Sk*D flops per (batch, head) against O((Sq+Sk)*D) bytes, far
// above the card's ~295 flop/byte balance point, so it is bound by tensor-core
// issue and by the exp/max/sum work of the softmax between the two products.
//
// Design (first, simple version; wgmma, TMA and warp specialisation wait for
// a later change):
//   * bf16: FA2 layout. A block of 4 warps owns 64 query rows, one warp per 16
//     rows; Q stays in registers as mma A-fragments. K and V tiles of 64 keys
//     are staged in shared memory (rows padded by 8 elements, so fragment
//     loads are free of bank conflicts). QK^T and PV run on mma.sync
//     m16n8k16 bf16 -> fp32; V's B-fragments come from ldmatrix.trans. P is
//     rounded to bf16 before PV (as the TPU kernel does), l sums fp32 P.
//   * fp32: plain FMA (no TF32, which flips results at this precision). A
//     block of 128 threads owns 32 query rows; each thread computes a 2x4
//     score micro-tile and accumulates 2 rows x D/8 output columns.
// The caller passes element strides for batch, head and sequence of every
// tensor; the last axis must be contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kMaskedScore = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* kv_mask;  // (B, Sk) or null
  float* m_out;            // (B, H, Sq) or null
  float* l_out;            // (B, H, Sq) or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Sq, Sk;
  float scale;
};

// Score of key `col` after scaling and masking; -inf for out-of-bounds keys.
__device__ __forceinline__ float mask_score(float s, int col, const Params& p,
                                            const int32_t* mask_row) {
  if (col >= p.Sk) return -INFINITY;
  if (mask_row != nullptr && mask_row[col] == 0) return kMaskedScore;
  return s * p.scale;
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBf16Warps = 4;
constexpr int kBf16BlockM = 16 * kBf16Warps;  // query rows per block
constexpr int kBf16BlockN = 64;               // keys per tile

template <int D>
__global__ void __launch_bounds__(kBf16Warps * 32)
flash_fwd_bf16_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded smem row, in elements
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) uint16_t Ks[kBf16BlockN * kStride];  // bf16 bits
  __shared__ __align__(16) uint16_t Vs[kBf16BlockN * kStride];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int row0 = blockIdx.x * kBf16BlockM + warp * 16;

  const __nv_bfloat16* qbase = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kbase = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vbase = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask_row = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;

  // Q A-fragments for the 16 rows of this warp: rows g and g+8.
  uint32_t qf[D / 16][4];
  {
    const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      qf[kk][0] = ra < p.Sq ? *reinterpret_cast<const uint32_t*>(qbase + ra * p.q_ss + c0) : 0u;
      qf[kk][1] = rb < p.Sq ? *reinterpret_cast<const uint32_t*>(qbase + rb * p.q_ss + c0) : 0u;
      qf[kk][2] = ra < p.Sq ? *reinterpret_cast<const uint32_t*>(qbase + ra * p.q_ss + c0 + 8) : 0u;
      qf[kk][3] = rb < p.Sq ? *reinterpret_cast<const uint32_t*>(qbase + rb * p.q_ss + c0 + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;                    // this thread's partial row sums

  for (int n0 = 0; n0 < p.Sk; n0 += kBf16BlockN) {
    __syncthreads();  // previous tile fully consumed
    for (int c = tid; c < kBf16BlockN * kChunks; c += kBf16Warps * 32) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (n0 + r < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kbase + (long long)(n0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(vbase + (long long)(n0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(&Ks[r * kStride + col]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * kStride + col]) = vv;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBf16BlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBf16BlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint16_t* krow = &Ks[(j * 8 + g) * kStride + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // Scale, mask, and the online-softmax update.
    float mx0 = kMaskedScore, mx1 = kMaskedScore;
#pragma unroll
    for (int j = 0; j < kBf16BlockN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      s[j][0] = mask_score(s[j][0], col, p, mask_row);
      s[j][1] = mask_score(s[j][1], col + 1, p, mask_row);
      s[j][2] = mask_score(s[j][2], col, p, mask_row);
      s[j][3] = mask_score(s[j][3], col + 1, p, mask_row);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBf16BlockN / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // O += P V: P's accumulator layout is the A-fragment layout of the next mma.
#pragma unroll
    for (int kk = 0; kk < kBf16BlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // ldmatrix.x4.trans: matrices (keys 0-7 | 8-15) x (cols jd | jd+1)
      const int mat = lane / 8;
      const int key = kk * 16 + (mat & 1) * 8 + (lane % 8);
#pragma unroll
      for (int jd = 0; jd < D / 8; jd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[key * kStride + (jd + (mat >> 1)) * 8]);
        mma_bf16(acc[jd], pa, vb[0], vb[1]);
        mma_bf16(acc[jd + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < p.Sq)
      *reinterpret_cast<uint32_t*>(obase + ra * p.o_ss + col) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (rb < p.Sq)
      *reinterpret_cast<uint32_t*>(obase + rb * p.o_ss + col) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (p.m_out != nullptr && t == 0) {
    const long long base = ((long long)b * p.H + h) * p.Sq;
    if (ra < p.Sq) { p.m_out[base + ra] = m0; p.l_out[base + ra] = l0; }
    if (rb < p.Sq) { p.m_out[base + rb] = m1; p.l_out[base + rb] = l1; }
  }
}

// ---------------------------------------------------------------------------
// fp32 path: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32BlockM = 32;
constexpr int kF32BlockN = 32;

template <int D>
constexpr int f32_smem_bytes() {
  return (2 * kF32BlockM * (D + 1) + kF32BlockN * D + kF32BlockM * (kF32BlockN + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                              // [BM][D+1]
  float* Ks = Qs + kF32BlockM * (D + 1);         // [BN][D+1]
  float* Vs = Ks + kF32BlockN * (D + 1);         // [BN][D]
  float* Ps = Vs + kF32BlockN * D;               // [BM][BN+1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;  // rows 2rg, 2rg+1; columns cg + 8j
  const int q0 = blockIdx.x * kF32BlockM;

  const float* qbase = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kbase = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask_row = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;

  for (int i = tid; i < kF32BlockM * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] = (q0 + r < p.Sq) ? qbase[(long long)(q0 + r) * p.q_ss + c] : 0.f;
  }

  float acc[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < p.Sk; n0 += kF32BlockN) {
    __syncthreads();
    for (int i = tid; i < kF32BlockN * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < p.Sk;
      Ks[r * (D + 1) + c] = in ? kbase[(long long)(n0 + r) * p.k_ss + c] : 0.f;
      Vs[r * D + c] = in ? vbase[(long long)(n0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qa = Qs[(2 * rg) * (D + 1) + d];
      const float qb = Qs[(2 * rg + 1) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[(cg + 8 * j) * (D + 1) + d];
        s[0][j] = fmaf(qa, kv, s[0][j]);
        s[1][j] = fmaf(qb, kv, s[1][j]);
      }
    }

    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kMaskedScore;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask_score(s[i][j], n0 + cg + 8 * j, p, mask_row);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
        Ps[(2 * rg + i) * (kF32BlockN + 1) + cg + 8 * j] = s[i][j];
      }
      l[i] = l[i] * alpha[i] + ps;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= alpha[i];
    for (int kk = 0; kk < kF32BlockN; ++kk) {
      const float pa = Ps[(2 * rg) * (kF32BlockN + 1) + kk];
      const float pb = Ps[(2 * rg + 1) * (kF32BlockN + 1) + kk];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float vv = Vs[kk * D + cg + 8 * j];
        acc[0][j] = fmaf(pa, vv, acc[0][j]);
        acc[1][j] = fmaf(pb, vv, acc[1][j]);
      }
    }
  }

  float* obase = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + 2 * rg + i;
    if (row < p.Sq) {
      const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) obase[(long long)row * p.o_ss + cg + 8 * j] = acc[i][j] * inv;
      if (p.m_out != nullptr && cg == 0) {
        const long long idx = ((long long)b * p.H + h) * p.Sq + row;
        p.m_out[idx] = m[i];
        p.l_out[idx] = li;
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kF32BlockM - 1) / kF32BlockM, p.H, p.B);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Sq + kBf16BlockM - 1) / kBf16BlockM, p.H, p.B);
  flash_fwd_bf16_kernel<D><<<grid, kBf16Warps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. `strides` holds 12 element strides:
// (batch, head, seq) for q, k, v, o in that order. dtype: 0 = bf16, 1 = fp32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         const int32_t* kv_mask, float* m_out, float* l_out,
                         const long long* strides, int B, int H, int Sq, int Sk,
                         int D, int dtype, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.kv_mask = kv_mask; p.m_out = m_out; p.l_out = l_out;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_bf16<128>(p, s);
  if (dtype == 0 && D == 64) return launch_bf16<64>(p, s);
  if (dtype == 1 && D == 128) return launch_f32<128>(p, s);
  if (dtype == 1 && D == 64) return launch_f32<64>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
