// Flash attention forward for Hopper (sm_90a): online softmax, fp32 statistics.
// Two entry points share one mainloop: flash_fwd (kernel A) and flash_fused
// (kernel F, the same loop with qk-norm + RoPE applied as Q and K are staged).
//
// Kernel A replaces two Pallas TPU kernels of the JAX package:
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
//
// Kernel F replaces the Pallas TPU kernel
//   actionmesh_tpu/ops/flash_attention.py:flash_attention_fused (pallas_call :492,
//   body _flash_fused_kernel / _norm_rope :361-436)
// and computes exactly what it does, for self-attention q, k, v (B,H,S,D):
//   q^ = rope(rms_norm(q) * q_scale), k^ = rope(rms_norm(k) * k_scale), each in
//   fp32 (mean of x^2 over D, rsqrt(var + 1e-6)), rotated pairwise with channels
//   (2i, 2i+1) as the pair: x*cos + rot(x)*sin, rot(x0, x1) = (-x1, x0), with
//   per-batch tables cos/sin (B,S,D) fp32; then rounded to the input dtype.
//   Scores, softmax and output as kernel A's with no kv_mask and no stats;
//   the scale multiplies the product of the rounded q^ and k^.
// What bounds it: the same products as kernel A, 4*B*H*S^2*D flops; at the
// Stage-I self shape (2,16,32784,128) bf16 that is 1.76e13 flop, 17.8 ms at
// the card's 989 TFLOP/s bf16 peak. The fused staging adds the K-side norm +
// rotation, recomputed once per Q block as on the TPU: about 4e11 fp32
// operations there (2% of the products' flop count, but on the CUDA cores),
// plus 8 bytes of fp32 cos/sin read per K element per Q block, mostly from L2.
// Design: the template flag kNormRope selects how Q and K tiles are staged;
// the rest of the loop is kernel A's. A warp owns whole rows when it stages
// them: each lane holds D/32 adjacent channels, so every rotating pair
// (2i, 2i+1) lies in one lane's registers (the swap is free) and the rms
// reduction over D is a 5-step shuffle across the warp. bf16: each warp
// stages its own 16 Q rows once through its slice of the K buffer and keeps
// them as mma A-fragments; each K tile is normalised by the 4 warps, 16 rows
// each. fp32: each warp stages 8 Q rows and 8 K rows per tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kMaskedScore = -1e30f;
constexpr float kNormEps = 1e-6f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* kv_mask;  // (B, Sk) or null
  float* m_out;            // (B, H, Sq) or null
  float* l_out;            // (B, H, Sq) or null
  const float* cos;        // kernel F: (B, Sq, D) fp32, Sq = Sk
  const float* sin;        // kernel F: (B, Sq, D) fp32
  const float* q_scale;    // kernel F: (D,) fp32
  const float* k_scale;    // kernel F: (D,) fp32
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

// rms-norm and pairwise rotation of one row held by a warp: this lane's
// P = D/32 channels start at lane * P. Every lane of the warp must call it.
template <int D>
__device__ __forceinline__ void norm_rope(float (&x)[D / 32], const float* cos_row,
                                          const float* sin_row, const float* w, int lane) {
  constexpr int P = D / 32;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) ss = fmaf(x[i], x[i], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss * (1.f / D) + kNormEps);
  const int c0 = lane * P;
#pragma unroll
  for (int i = 0; i < P; i += 2) {
    const float2 cs = *reinterpret_cast<const float2*>(cos_row + c0 + i);
    const float2 sn = *reinterpret_cast<const float2*>(sin_row + c0 + i);
    const float x0 = x[i] * r * w[c0 + i];
    const float x1 = x[i + 1] * r * w[c0 + i + 1];
    x[i] = x0 * cs.x - x1 * sn.x;
    x[i + 1] = x1 * cs.y + x0 * sn.y;
  }
}

// A warp normalises, rotates and rounds `nrows` rows starting at sequence row
// `row0` into bf16 shared memory (row stride `dst_stride` elements); rows at
// or beyond S are written as zeros.
template <int D>
__device__ __forceinline__ void stage_rows_bf16(uint16_t* dst, int dst_stride,
                                                const __nv_bfloat16* src, long long src_ss,
                                                const float* cos_b, const float* sin_b,
                                                const float* w, int row0, int nrows, int S,
                                                int lane) {
  constexpr int P = D / 32;
#pragma unroll 4
  for (int r = 0; r < nrows; ++r) {
    const int row = row0 + r;  // the same for the whole warp
    uint16_t* d = dst + r * dst_stride + lane * P;
    if (row < S) {
      float x[P];
      const __nv_bfloat16* s = src + (long long)row * src_ss + lane * P;
#pragma unroll
      for (int i = 0; i < P; i += 2) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(s + i);
        x[i] = __low2float(v);
        x[i + 1] = __high2float(v);
      }
      norm_rope<D>(x, cos_b + (long long)row * D, sin_b + (long long)row * D, w, lane);
#pragma unroll
      for (int i = 0; i < P; i += 2) *reinterpret_cast<uint32_t*>(d + i) = pack_bf16(x[i], x[i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < P; i += 2) *reinterpret_cast<uint32_t*>(d + i) = 0u;
    }
  }
}

// fp32 counterpart of stage_rows_bf16 (no rounding).
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, int dst_stride, const float* src,
                                               long long src_ss, const float* cos_b,
                                               const float* sin_b, const float* w, int row0,
                                               int nrows, int S, int lane) {
  constexpr int P = D / 32;
  for (int r = 0; r < nrows; ++r) {
    const int row = row0 + r;
    float* d = dst + r * dst_stride + lane * P;
    if (row < S) {
      float x[P];
      const float* s = src + (long long)row * src_ss + lane * P;
#pragma unroll
      for (int i = 0; i < P; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(s + i);
        x[i] = v.x;
        x[i + 1] = v.y;
      }
      norm_rope<D>(x, cos_b + (long long)row * D, sin_b + (long long)row * D, w, lane);
#pragma unroll
      for (int i = 0; i < P; ++i) d[i] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) d[i] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBf16Warps = 4;
constexpr int kBf16BlockM = 16 * kBf16Warps;  // query rows per block
constexpr int kBf16BlockN = 64;               // keys per tile

template <int D, bool kNormRope>
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
  // kernel F takes no mask: a constant null lets the compiler drop the check
  const int32_t* mask_row = !kNormRope && p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const float* cos_b = kNormRope ? p.cos + (long long)b * p.Sq * D : nullptr;
  const float* sin_b = kNormRope ? p.sin + (long long)b * p.Sq * D : nullptr;

  // Q A-fragments for the 16 rows of this warp: rows g and g+8.
  uint32_t qf[D / 16][4];
  if constexpr (kNormRope) {
    // normalised, rotated and rounded once, staged through the warp's slice
    // of Ks (the loop's first barrier orders it before the first K tile)
    uint16_t* qstage = Ks + warp * 16 * kStride;
    stage_rows_bf16<D>(qstage, kStride, qbase, p.q_ss, cos_b, sin_b, p.q_scale, row0, 16, p.Sq, lane);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint16_t* qa = qstage + g * kStride + kk * 16 + 2 * t;
      const uint16_t* qb = qa + 8 * kStride;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(qa);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(qb);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(qb + 8);
    }
  } else {
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
    __syncthreads();  // previous tile (or the Q staging) fully consumed
    if constexpr (kNormRope)
      stage_rows_bf16<D>(Ks + warp * 16 * kStride, kStride, kbase, p.k_ss, cos_b, sin_b,
                         p.k_scale, n0 + warp * 16, 16, p.Sk, lane);
    for (int c = tid; c < kBf16BlockN * kChunks; c += kBf16Warps * 32) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (n0 + r < p.Sk) {
        if constexpr (!kNormRope)
          kv = *reinterpret_cast<const uint4*>(kbase + (long long)(n0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(vbase + (long long)(n0 + r) * p.v_ss + col);
      }
      if constexpr (!kNormRope) *reinterpret_cast<uint4*>(&Ks[r * kStride + col]) = kv;
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

template <int D, bool kNormRope>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                              // [BM][D+1]
  float* Ks = Qs + kF32BlockM * (D + 1);         // [BN][D+1]
  float* Vs = Ks + kF32BlockN * (D + 1);         // [BN][D]
  float* Ps = Vs + kF32BlockN * D;               // [BM][BN+1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid >> 3, cg = tid & 7;  // rows 2rg, 2rg+1; columns cg + 8j
  const int q0 = blockIdx.x * kF32BlockM;

  const float* qbase = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kbase = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  // kernel F takes no mask: a constant null lets the compiler drop the check
  const int32_t* mask_row = !kNormRope && p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
  const float* cos_b = kNormRope ? p.cos + (long long)b * p.Sq * D : nullptr;
  const float* sin_b = kNormRope ? p.sin + (long long)b * p.Sq * D : nullptr;
  constexpr int kRowsPerWarpQ = kF32BlockM / (kF32Threads / 32);
  constexpr int kRowsPerWarpK = kF32BlockN / (kF32Threads / 32);

  if constexpr (kNormRope) {
    stage_rows_f32<D>(Qs + warp * kRowsPerWarpQ * (D + 1), D + 1, qbase, p.q_ss, cos_b, sin_b,
                      p.q_scale, q0 + warp * kRowsPerWarpQ, kRowsPerWarpQ, p.Sq, lane);
  } else {
    for (int i = tid; i < kF32BlockM * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      Qs[r * (D + 1) + c] = (q0 + r < p.Sq) ? qbase[(long long)(q0 + r) * p.q_ss + c] : 0.f;
    }
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
    if constexpr (kNormRope)
      stage_rows_f32<D>(Ks + warp * kRowsPerWarpK * (D + 1), D + 1, kbase, p.k_ss, cos_b, sin_b,
                        p.k_scale, n0 + warp * kRowsPerWarpK, kRowsPerWarpK, p.Sk, lane);
    for (int i = tid; i < kF32BlockN * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool in = n0 + r < p.Sk;
      if constexpr (!kNormRope) Ks[r * (D + 1) + c] = in ? kbase[(long long)(n0 + r) * p.k_ss + c] : 0.f;
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

template <int D, bool kNormRope>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, kNormRope>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kF32BlockM - 1) / kF32BlockM, p.H, p.B);
  flash_fwd_f32_kernel<D, kNormRope><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kNormRope>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Sq + kBf16BlockM - 1) / kBf16BlockM, p.H, p.B);
  flash_fwd_bf16_kernel<D, kNormRope><<<grid, kBf16Warps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kNormRope>
int launch(const Params& p, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_bf16<128, kNormRope>(p, s);
  if (dtype == 0 && D == 64) return launch_bf16<64, kNormRope>(p, s);
  if (dtype == 1 && D == 128) return launch_f32<128, kNormRope>(p, s);
  if (dtype == 1 && D == 64) return launch_f32<64, kNormRope>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params strided_params(const void* q, const void* k, const void* v, void* o,
                      const long long* strides) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  return p;
}

}  // namespace

// C entry point, loaded with ctypes. `strides` holds 12 element strides:
// (batch, head, seq) for q, k, v, o in that order. dtype: 0 = bf16, 1 = fp32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         const int32_t* kv_mask, float* m_out, float* l_out,
                         const long long* strides, int B, int H, int Sq, int Sk,
                         int D, int dtype, float scale, void* stream) {
  Params p = strided_params(q, k, v, o, strides);
  p.kv_mask = kv_mask; p.m_out = m_out; p.l_out = l_out;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.scale = scale;
  return launch<false>(p, D, dtype, stream);
}

// Kernel F's C entry point: self-attention (Sq = Sk = S) of pre-norm q, k, v
// with fp32 qk-norm + interleaved RoPE applied as Q and K are staged. cos/sin
// contiguous (B,S,D) fp32, the norm scales contiguous (D,) fp32; `strides`,
// dtype and the return value as flash_fwd's.
extern "C" int flash_fused(const void* q, const void* k, const void* v, void* o,
                           const float* cos, const float* sin, const float* q_scale,
                           const float* k_scale, const long long* strides, int B, int H,
                           int S, int D, int dtype, float scale, void* stream) {
  Params p = strided_params(q, k, v, o, strides);
  p.cos = cos; p.sin = sin; p.q_scale = q_scale; p.k_scale = k_scale;
  p.B = B; p.H = H; p.Sq = S; p.Sk = S; p.scale = scale;
  return launch<true>(p, D, dtype, stream);
}
