// Flash attention forward for Hopper (sm_90a): online softmax, fp32 statistics.
// Two entry points: flash_fwd (kernel A) and flash_fused (kernel F, a qk-norm
// + RoPE pre-pass followed by kernel A's mainloop).
//
// Kernel A replaces two Pallas TPU kernels of the JAX package:
//   actionmesh_tpu/ops/flash_attention.py:flash_attention_pipelined (pallas_call :302)
//   actionmesh_tpu/ops/flash_attention.py:flash_attention           (pallas_call :612)
// and meets their shared contract: q (B,H,Sq,D), k/v (B,H,Sk,D), optional
// kv_mask (B,Sk) (nonzero = valid), optional per-row stats (m, l) as (B,H,Sq)
// fp32, m the running max of the scaled scores and l the sum of the fp32
// probabilities. Scores are fp32 dot products times `scale`; masked scores
// are -1e30; P is rounded to the input dtype before PV; the output is
// acc / max(l, 1e-30), rounded once, so a row with every key masked gives a
// finite mean of v, never NaN. Keys at or beyond Sk are out of bounds and
// take no part (probability exactly 0): the ragged edge is masked here, with
// no padded copies of the inputs.
//
// What bounds it: at the main path's shapes (Sq = Sk = 32,784, D = 128) the
// work is 4*Sq*Sk*D flops per (batch, head) against O((Sq+Sk)*D) bytes, far
// above the card's ~295 flop/byte balance point, so it is bound by tensor-core
// issue and by the exp/max/sum work of the softmax between the two products.
//
// bf16 and fp16 design: TMA + wgmma, warp-specialised, with the softmax
// hidden under the tensor cores (FA3's schedule); one kernel template over
// the 16-bit element type T, whose products, tensor maps and packing of P and
// O take T's PTX type (fp16 and bf16 products run at the same rate).
//   * One CTA per (128-query tile, head, batch), 3 warpgroups. Warpgroup 0 is
//     the producer (setmaxnreg down to 24): one thread loads the Q tile once,
//     then K_0, then K_{j+1} and V_j by turns (the order the consumers read
//     them), by TMA into two rings (K and V) of kStages = 2 slots, each slot
//     guarded by a full/empty mbarrier pair. Warpgroups 1 and 2 are consumers
//     (setmaxnreg up to 240), each owning 64 query rows.
//   * Tiles (Tiles16, fixed by D at compile time): kBlockN = 160 keys at D =
//     128, 128 at D = 64. Shared memory at D = 128: Q 32 KB + 2 x 2 x 40 KB =
//     192 KB. On an H100 SXM (700 W) 160 keys beat 128, 144 and 176 at the
//     Stage-I and Stage-II self shapes (176 is FA3's choice; here it was no
//     faster), and a third ring slot at 128 keys gained nothing.
//   * Tensor maps are rank 4 (D, S, H, B) with the caller's strides, so
//     strided head views are read in place; boxes are 64 columns x 128 (Q) or
//     kBlockN (K, V) rows with the 128-byte swizzle (a D = 128 row is two such
//     atoms). TMA fills rows beyond Sq or Sk with zeros; keys >= Sk are masked
//     by bounds in the last tile only.
//   * S = Q K^T: wgmma m64n{kBlockN}k16, Q and K both from shared memory,
//     K-major. O += P V: wgmma m64nDk16 with P from registers (the S
//     accumulator packed pairwise to T is the A fragment) and V from shared
//     memory, MN-major (the transpose bit).
//   * The schedule (FA3's intra-warpgroup overlap): a consumer issues S_0
//     alone; then in each turn it issues S_{j+1} = Q K_{j+1}^T and P_j V_j as
//     two commit groups. wgmma_wait<1> retires S_{j+1} alone, whose softmax
//     then runs on the CUDA cores while P_j V_j is in flight; wgmma_wait<0>
//     retires P_j V_j, and only then is S_{j+1} packed into P and, before the
//     next turn, O rescaled by exp(m_j - m_{j+1}): registers that a product
//     owns are touched only after the wait that covers it. K_{j+1}'s slot is
//     freed after the first wait, V_j's after the second. The last P V stands
//     alone.
//   * Pingpong: the consumers take turns at the tensor cores through named
//     barriers 1 and 2 (bar.sync / bar.arrive over their 256 threads).
//     Consumer c waits on its own barrier, issues its two products and
//     arrives on the other's; consumer 0 has the first turn. So one
//     warpgroup's softmax runs while the other's products hold the tensor
//     cores. On the H100 the pingpong and the overlap took the Stage-I self
//     shape from 28.7 ms with neither to 27.4 with the pingpong alone and
//     26.2 with both.
//   * Softmax (softmax_tile): a full tile of a call without kv_mask takes the
//     row max on the raw scores (scaled once; rounding is monotonic, so that
//     is the max of the scaled scores to the bit), then one FFMA and one ex2
//     a score, exp2(s * scale*log2 e - m*log2 e). The ragged last tile and
//     masked calls take the contract's scaled and masked scores. The two run
//     in separate loops, so that the hot loop carries no branch of the other
//     (with the branches inside one loop, register moves at their join cost
//     about 3.5 ms at the Stage-I self shape and the wider tiles spilled).
//   * Registers (a consumer thread, of 240): O 64 fp32, S 80 fp32, P 40
//     packed pairs, the stats and the addresses; the Q tile's descriptors sit
//     in uniform registers (the warpgroup index is read from lane 0, so the
//     compiler knows it is warp-uniform). ptxas reports 0 spilled.
//   * The epilogue rescales by 1/max(l, 1e-30) and stores O from registers.
//   Not in this version (later work): a persistent tile scheduler and a TMA
//   store of O (at Sk = 32,784 a CTA walks 205 key tiles, so its epilogue is
//   under 0.5% of its time); a smaller last key tile for short Sk (at Sk =
//   257 the last of two tiles holds 97 keys); the fp32 path below keeps the
//   sequential schedule.
//
// fp32 design: split precision ("3xTF32") on the tensor cores, TMA + wgmma,
// warp-specialised as the bf16 path. It serves the fp32 islands of the
// main path: Stage II's vertex cross-attention, (5,8,19153,32784,128),
// 1.29e13 flop, and Stage 0's SDF query, (1,8,262144,2048,128), 2.2e12
// flop. Both are bound by the products: their inputs and outputs are ~2.2
// GB, 0.7 ms at 3.35 TB/s, against 78 ms and 13 ms of products at
// 495/3 TFLOP/s. Plain TF32 keeps 10 mantissa bits and flips SDF signs near
// zero, so every product is three TF32 products:
//   a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the small terms first),
// dropping a_lo*b_lo (~2^-22 of the product).
//   * The split (tf32_split in sm90.cuh; ops/flash_attention.py:tf32_split is
//     the same to the bit): hi = x rounded to nearest TF32 (ties away from
//     zero) on the bit pattern, lo = x - hi exactly. lo is handed to the
//     tensor core as it is, which reads its top 19 bits (truncation).
//   * TF32 wgmma takes K-major operands only (no transpose bit). Q and K
//     are K-major along D; V is not, so a pre-pass (split_kv_kernel, one
//     launch before the mainloop) reads k and v once through their strides
//     and writes four contiguous fp32 workspaces that the caller allocates:
//     k_hi, k_lo (B,H,Sk,D) and v^T's hi and lo (B,H,D,Skp), Skp = Sk
//     rounded up to 8. Within each group of 8 keys v^T stores key
//     (p % 4) * 2 + p / 4 at position p, so the S accumulator's columns
//     (2t, 2t+1) are the A-fragment's columns (t, t+4) of the P V product
//     and P goes in with no shuffles. At the vertex-cross shape the
//     workspaces are 2.7 GB, written once per call; every query tile
//     reuses them.
//   * Shared memory (D = 128): Q raw fp32, 128 rows, 64 KB, loaded once by
//     TMA; a ring of two 64 KB slots that alternate K_j (hi, lo: 64 keys)
//     and V^T_j (hi, lo), so the producer loads V_j while the consumers
//     compute S_j and K_{j+1} while they compute P_j V_j. 192 KB in all; D
//     = 64 halves every tile.
//   * S = Q K^T: wgmma m64n64k8 RS. The consumers read Q's A-fragments
//     from the swizzled tile (conflict-free), split them in registers, 64
//     columns (8 k-steps, 64 registers) at a time, K_hi and K_lo from
//     shared memory. O += P V: m64nDk8 RS, P split in registers, V^T_hi
//     and V^T_lo from shared memory. Softmax (online_softmax, after each
//     tile's products), masking, stats and epilogue as the contract states
//     them, with fp32 output.
//   * Accumulation: the tensor core's own fp32 sums truncate, so a chain of
//     products over every key drifts (one accumulator for O over the 32,784
//     keys of the vertex cross missed the 2e-5 bar of the output's range).
//     Each 64 columns of S and each tile's P V therefore go into a fresh
//     accumulator, the small products first, and are added to S and O in
//     IEEE fp32 (at most 24 products in one chain).
//   Not in this version: pingpong of the consumers, overlap of softmax
//   and products, a persistent scheduler, TMA multicast of K/V tiles.
//
// The caller passes element strides for batch, head and sequence of every
// tensor; the last axis must be contiguous, strides and addresses 16-byte
// aligned.
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
// the card's 989 TFLOP/s bf16 peak. Normalising and rotating is a pass over
// q, k and the tables, a few hundred MB there.
// Design: one call launches two device kernels. A pre-pass normalises and
// rotates every row of q and k once (one warp per row, each lane holding D/32
// adjacent channels, so every rotating pair sits in one lane's registers and
// the rms sum over D is a 5-step shuffle) into two contiguous (B,H,S,D)
// workspaces the caller allocates; kernel A's mainloop then attends over
// q^, k^ and v (bf16, fp16 the TMA + wgmma kernel; fp32 its split pre-pass on k^
// and v, then the 3xTF32 kernel). The TPU kernel instead re-normalised each
// K block once per Q block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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

// The fp32 path's softmax: scale and mask one tile's scores, then the
// online-softmax update of a consumer thread's two rows and the rescaling of
// its output accumulator.
// sc[4j + e] is key key0 + 8j + 2t + (e & 1) of row g (e < 2) or g+8
// (e >= 2); on return it holds the fp32 probabilities. m0/m1 are the running
// maxima, l0/l1 this thread's partial row sums.
template <int N, int D>
__device__ __forceinline__ void online_softmax(float (&sc)[N / 2], float (&o)[D / 2], int key0,
                                               int t, const Params& p, const int32_t* mask_row,
                                               float& m0, float& m1, float& l0, float& l1) {
  if (mask_row != nullptr || key0 + N > p.Sk) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = key0 + j * 8 + 2 * t;
      sc[4 * j + 0] = mask_score(sc[4 * j + 0], col, p, mask_row);
      sc[4 * j + 1] = mask_score(sc[4 * j + 1], col + 1, p, mask_row);
      sc[4 * j + 2] = mask_score(sc[4 * j + 2], col, p, mask_row);
      sc[4 * j + 3] = mask_score(sc[4 * j + 3], col + 1, p, mask_row);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sc[i] *= p.scale;
  }
  float mx0 = kMaskedScore, mx1 = kMaskedScore;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
  for (int j = 0; j < N / 8; ++j) {
    sc[4 * j + 0] = __expf(sc[4 * j + 0] - mn0);
    sc[4 * j + 1] = __expf(sc[4 * j + 1] - mn0);
    sc[4 * j + 2] = __expf(sc[4 * j + 2] - mn1);
    sc[4 * j + 3] = __expf(sc[4 * j + 3] - mn1);
    ps0 += sc[4 * j + 0] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// Sum a consumer thread's partial row sums over the 4 lanes of each row.
__device__ __forceinline__ void reduce_row_sums(float& l0, float& l1) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
}

// Write the stats (m, l) of rows ra and rb, from the thread of t == 0.
__device__ __forceinline__ void store_stats(const Params& p, int b, int h, int ra, int rb, int t,
                                            float m0, float m1, float l0, float l1) {
  if (p.m_out == nullptr || t != 0) return;
  const long long base = ((long long)b * p.H + h) * p.Sq;
  if (ra < p.Sq) { p.m_out[base + ra] = m0; p.l_out[base + ra] = l0; }
  if (rb < p.Sq) { p.m_out[base + rb] = m1; p.l_out[base + rb] = l1; }
}

// ---------------------------------------------------------------------------
// bf16 and fp16 path: TMA + wgmma, warp-specialised, the softmax under the
// tensor cores
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;           // query rows per CTA, 64 per consumer warpgroup
constexpr int kThreads = 3 * 128;      // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;      // arrivals that free a stage
constexpr int kConsumerThreads = 256;  // both consumer warpgroups: a turn barrier's count
constexpr uint32_t kTurnBarrier = 1;   // named barriers 1, 2: consumer 0's, 1's turn
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (what __expf runs after its multiply by
// log2 e); a result below the normal range flushes to zero.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-bit kernel's tiles at head dim D, fixed at compile time: K and V
// tiles of kBlockN keys in two rings of kStages slots each.
template <int D>
struct Tiles16 {
  static constexpr int kBlockN = D == 128 ? 160 : 128;
  static constexpr int kStages = 2;
  static constexpr int kQAtom = kBlockM * 128;         // 128 rows x 64 16-bit values
  static constexpr int kKVAtom = kBlockN * 128;        // kBlockN rows x 64 16-bit values
  static constexpr int kKVBytes = (D / 64) * kKVAtom;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + (D / 64) * kQAtom;      // + slot * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;     // + slot * kKVBytes
  static constexpr int kBars = kV + kStages * kKVBytes;  // q_full, full_k[], full_v[], empty_k[], empty_v[]
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base to 1024 bytes
  static_assert(kKVAtom % 1024 == 0, "a tile's atoms start on the swizzle's 1024-byte grid");
  static_assert(kAlloc <= 232448, "shared memory above the 227 KB a block may use");
};

// The max of each of a consumer thread's two rows of s (a tile's
// accumulator: row g at s[4j], s[4j + 1], row g+8 at s[4j + 2], s[4j + 3])
// over the tile, in four partial maxima a row (short chains of dependent
// operations), then over the 4 lanes that hold the same rows.
template <int N>
__device__ __forceinline__ void row_max(const float (&s)[N / 2], float& r0, float& r1) {
  float a[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = fmaxf(s[4 * j + 0], s[4 * j + 1]);
    c[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int j = 4; j < N / 8; ++j) {
    a[j % 4] = fmaxf(a[j % 4], fmaxf(s[4 * j + 0], s[4 * j + 1]));
    c[j % 4] = fmaxf(c[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  r0 = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  r1 = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
  }
}

// One tile's online-softmax update on the 16-bit path. s[4j + e] is the raw
// fp32 score (q.k) of key key0 + 8j + 2t + (e & 1), row g (e < 2) or g+8
// (e >= 2); on return it holds the fp32 probabilities exp(s*scale - m).
// m0/m1, the running maxima of the scaled scores, and l0/l1, this thread's
// partial row sums, are updated; alpha0/alpha1 get exp(m_old - m), the
// factor the output accumulator still owes (applied when no product owns
// it).
// kFull: a tile of N keys inside Sk, in a call without kv_mask and with a
// positive scale. It takes the row's largest raw score and scales it once:
// rounding is monotonic, so that is the max of the scaled scores to the bit;
// each probability is then one FFMA and one ex2, exp2(s * scale*log2 e -
// m*log2 e). Otherwise (the ragged last tile, every tile of a masked call)
// the scores are scaled and masked as the contract states them (-1e30
// masked, -inf beyond Sk) and each probability is exp2((s - m) * log2 e),
// exactly 1 for a masked key of a row that has seen no valid key, so that
// such a row averages v.
template <int N, bool kFull>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], int key0, int t, const Params& p,
                                             const int32_t* mask_row, float scale_log2,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  float mx0, mx1;
  if constexpr (kFull) {
    row_max<N>(s, mx0, mx1);
    mx0 *= p.scale;
    mx1 *= p.scale;
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = key0 + j * 8 + 2 * t;
      s[4 * j + 0] = mask_score(s[4 * j + 0], col, p, mask_row);
      s[4 * j + 1] = mask_score(s[4 * j + 1], col + 1, p, mask_row);
      s[4 * j + 2] = mask_score(s[4 * j + 2], col, p, mask_row);
      s[4 * j + 3] = mask_score(s[4 * j + 3], col + 1, p, mask_row);
    }
    row_max<N>(s, mx0, mx1);
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = exp2_approx((m0 - mn0) * kLog2e);
  alpha1 = exp2_approx((m1 - mn1) * kLog2e);
  m0 = mn0;
  m1 = mn1;
  if constexpr (kFull) {
    const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[4 * j + 0] = exp2_approx(fmaf(s[4 * j + 0], scale_log2, -b0));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -b0));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -b1));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -b1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[4 * j + 0] = exp2_approx((s[4 * j + 0] - mn0) * kLog2e);
      s[4 * j + 1] = exp2_approx((s[4 * j + 1] - mn0) * kLog2e);
      s[4 * j + 2] = exp2_approx((s[4 * j + 2] - mn1) * kLog2e);
      s[4 * j + 3] = exp2_approx((s[4 * j + 3] - mn1) * kLog2e);
    }
  }
  // the row sums in four partial sums a row, which shortens the chain of
  // dependent adds
  float ps0[4] = {0.f, 0.f, 0.f, 0.f}, ps1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    ps0[j % 4] += s[4 * j + 0] + s[4 * j + 1];
    ps1[j % 4] += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + ((ps0[0] + ps0[1]) + (ps0[2] + ps0[3]));
  l1 = l1 * alpha1 + ((ps1[0] + ps1[1]) + (ps1[2] + ps1[3]));
}

// S (+)= Q K^T for a consumer's 64 rows and one tile's N keys, over D in
// steps of 16 (the first step overwrites S); Q and K both K-major in shared
// memory.
template <int D, typename T>
__device__ __forceinline__ void qk_product(float (&s)[Tiles16<D>::kBlockN / 2], uint32_t q_addr,
                                           uint32_t k_addr) {
  using L = Tiles16<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<L::kBlockN, T>(s, wgmma_desc(q_addr + (kk / 4) * L::kQAtom + (kk % 4) * 32, 16, 1024),
                            wgmma_desc(k_addr + (kk / 4) * L::kKVAtom + (kk % 4) * 32, 16, 1024),
                            kk > 0);
  }
}

// O += P V: P (the probabilities rounded to T, the S accumulator packed
// pairwise) as register A fragments, 16 keys a product, V from shared
// memory, MN-major (the transpose bit).
template <int D, typename T>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[Tiles16<D>::kBlockN / 16][4],
                                           uint32_t v_addr) {
  using L = Tiles16<D>;
#pragma unroll
  for (int kk = 0; kk < L::kBlockN / 16; ++kk)
    wgmma_rs<D, T>(o, pa[kk], wgmma_desc(v_addr + kk * 16 * 128, L::kKVAtom, 1024), 1);
}

template <int N, typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale_rows(float (&o)[D / 2], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_16bit_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Tiles16<D>;
  constexpr int N = L::kBlockN, S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: atoms start on that grid
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int n_tiles = (p.Sk + N - 1) / N;
  // read from lane 0, so that the compiler knows it is the same across the
  // warp: the Q tile's descriptors, which depend on it, then live in uniform
  // registers, beside those of K and V, and not in the consumers' own
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumerWarps);
      mbar_init(&empty_v[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread loads Q, K_0, then K_{j+1} and V_j by turns,
    // the order in which the consumers read them ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      mbar_arrive_expect_tx(q_full, (D / 64) * L::kQAtom);
#pragma unroll
      for (int a = 0; a < D / 64; ++a)
        tma_load_4d(smem + L::kQ + a * L::kQAtom, &tm_q, q_full, a * 64, q0, h, b);
      auto load = [&](const CUtensorMap* tm, int base, uint64_t* full, uint64_t* empty, int n) {
        const int s = n % S;
        mbar_wait(&empty[s], ((n / S) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], L::kKVBytes);
#pragma unroll
        for (int a = 0; a < D / 64; ++a)
          tma_load_4d(smem + base + s * L::kKVBytes + a * L::kKVAtom, tm, &full[s], a * 64, n * N, h, b);
      };
      load(&tm_k, L::kK, full_k, empty_k, 0);
      for (int n = 0; n < n_tiles; ++n) {
        if (n + 1 < n_tiles) load(&tm_k, L::kK, full_k, empty_k, n + 1);
        load(&tm_v, L::kV, full_v, empty_v, n);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    setmaxnreg_inc<240>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group / column pair
    const int ra = q0 + 64 * c + 16 * warp + g, rb = ra + 8;
    const int32_t* mask_row = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
    const uint32_t q_addr = smem_addr(smem + L::kQ) + c * 64 * 128;
    const uint32_t k_addr = smem_addr(smem + L::kK), v_addr = smem_addr(smem + L::kV);
    const float scale_log2 = p.scale * kLog2e;
    // The consumers take turns at issuing their products: consumer c waits
    // on barrier kTurnBarrier + c, then arrives on the other's. Consumer 0
    // has the first turn; consumer 1 passes on all but its last, so every
    // arrival is waited for.
    const uint32_t my_turn = kTurnBarrier + c, next_turn = kTurnBarrier + (c ^ 1);
    if (c == 0) named_barrier_arrive(my_turn, kConsumerThreads);

    float o[D / 2], s[N / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
    uint32_t pa[N / 16][4];
    float m0 = kMaskedScore, m1 = kMaskedScore;  // running max, rows g and g+8
    float l0 = 0.f, l1 = 0.f;                    // this thread's partial row sums
    float alpha0, alpha1;                        // what O owes for the last max update

    // Full tiles of a call without kv_mask and with a positive scale take
    // softmax_tile's short arithmetic; the ragged last tile and every tile of
    // any other call the contract's (a loop of each, so that neither carries
    // the other's branches).
    const bool plain = mask_row == nullptr && p.scale > 0.f;
    const int n_full = plain ? p.Sk / N : 0;  // tiles 0 .. n_full - 1 are full

    // tile 0: S_0 alone
    mbar_wait(q_full, 0);
    mbar_wait(&full_k[0], 0);
    named_barrier_sync(my_turn, kConsumerThreads);
    fence_regs(s);
    wgmma_fence();
    qk_product<D, T>(s, q_addr, k_addr);
    wgmma_commit();
    if (c == 0 || n_tiles > 1) named_barrier_arrive(next_turn, kConsumerThreads);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_k[0]);
    if (n_full > 0)
      softmax_tile<N, true>(s, 0, t, p, mask_row, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    else
      softmax_tile<N, false>(s, 0, t, p, mask_row, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    pack_p<N, T>(pa, s);

    // tile n: S_n and P_{n-1} V_{n-1} in one turn; S_n's softmax runs while
    // P_{n-1} V_{n-1} is in flight
    auto step = [&](int n, auto full) {
      const int sk = n % S, sv = (n - 1) % S;
      mbar_wait(&full_k[sk], (n / S) & 1);
      mbar_wait(&full_v[sv], ((n - 1) / S) & 1);
      rescale_rows<D>(o, alpha0, alpha1);
      named_barrier_sync(my_turn, kConsumerThreads);
      fence_regs(s);
      fence_regs(o);
      fence_frags(pa);
      wgmma_fence();
      qk_product<D, T>(s, q_addr, k_addr + sk * L::kKVBytes);
      wgmma_commit();
      pv_product<D, T>(o, pa, v_addr + sv * L::kKVBytes);
      wgmma_commit();
      if (c == 0 || n + 1 < n_tiles) named_barrier_arrive(next_turn, kConsumerThreads);
      wgmma_wait<1>();  // S_n
      fence_regs(s);
      if (lane == 0) mbar_arrive(&empty_k[sk]);  // this warp is done with K_n
      softmax_tile<N, decltype(full)::value>(s, n * N, t, p, mask_row, scale_log2, m0, m1, l0, l1,
                                             alpha0, alpha1);
      wgmma_wait<0>();  // P_{n-1} V_{n-1}
      fence_regs(o);
      fence_frags(pa);
      if (lane == 0) mbar_arrive(&empty_v[sv]);  // this warp is done with V_{n-1}
      pack_p<N, T>(pa, s);
    };
    int n = 1;
    for (; n < n_full; ++n) step(n, std::true_type{});
    for (; n < n_tiles; ++n) step(n, std::false_type{});

    // the last tile's P V alone
    const int sv = (n_tiles - 1) % S;
    mbar_wait(&full_v[sv], ((n_tiles - 1) / S) & 1);
    rescale_rows<D>(o, alpha0, alpha1);
    fence_regs(o);
    fence_frags(pa);
    wgmma_fence();
    pv_product<D, T>(o, pa, v_addr + sv * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    reduce_row_sums(l0, l1);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    T* obase = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (ra < p.Sq)
        *reinterpret_cast<uint32_t*>(obase + ra * p.o_ss + col) =
            pack2<T>(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      if (rb < p.Sq)
        *reinterpret_cast<uint32_t*>(obase + rb * p.o_ss + col) =
            pack2<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    store_stats(p, b, h, ra, rb, t, m0, m1, l0, l1);
  }
}

template <int D, typename T>
int launch_16bit(const Params& p, cudaStream_t stream) {
  using L = Tiles16<D>;
  CUtensorMap tq, tk, tv;
  int err = make_tensor_map<T>(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBlockM);
  if (err == 0) err = make_tensor_map<T>(&tk, p.k, D, p.Sk, p.H, p.B, p.k_ss, p.k_sh, p.k_sb, L::kBlockN);
  if (err == 0) err = make_tensor_map<T>(&tv, p.v, D, p.Sk, p.H, p.B, p.v_ss, p.v_sh, p.v_sb, L::kBlockN);
  if (err != 0) return err;
  constexpr int smem = L::kAlloc;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_16bit_kernel<D, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  flash_fwd_16bit_kernel<D, T><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 path: split-precision (3xTF32) TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kF32BlockN = 64;   // keys per tile
constexpr int kF32AtomCols = 32;  // fp32 columns of one 128-byte swizzle row
constexpr int kF32QAtom = kBlockM * 128;  // one Q atom: 128 rows x 32 fp32
constexpr int kSplitKeys = 32;   // keys per block of the split pre-pass
constexpr int kSplitThreads = 256;

// Workspaces of one call, fp32, contiguous: k_hi and k_lo (B,H,Sk,D), then
// v^T's hi and lo (B,H,D,Skp) with Skp = Sk rounded up to a multiple of 8.
struct SplitKV {
  float *kh, *kl, *vth, *vtl;
  int Skp;
};

inline SplitKV split_views(float* ws, int B, int H, int Sk, int D) {
  SplitKV w;
  w.Skp = (Sk + 7) & ~7;
  const long long nk = (long long)B * H * Sk * D, nv = (long long)B * H * D * w.Skp;
  w.kh = ws;
  w.kl = ws + nk;
  w.vth = ws + 2 * nk;
  w.vtl = w.vth + nv;
  return w;
}

// Pre-pass: one block per (32 keys, head, batch) splits those keys' rows of
// k (strided, read once) into k_hi, k_lo and writes the same keys of v,
// transposed through shared memory and split, into v^T's hi and lo (zeros
// for keys Sk..Skp-1).
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
split_kv_kernel(const Params p, const SplitKV w) {
  __shared__ float vs[kSplitKeys][D + 1];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kSplitKeys;
  const long long head = (long long)b * p.H + h;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int i = threadIdx.x; i < kSplitKeys * D / 4; i += kSplitThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, key = k0 + r;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < p.Sk) {
      const float4 kv = *reinterpret_cast<const float4*>(kb + key * p.k_ss + c);
      float4 hi, lo;
      tf32_split(kv.x, hi.x, lo.x);
      tf32_split(kv.y, hi.y, lo.y);
      tf32_split(kv.z, hi.z, lo.z);
      tf32_split(kv.w, hi.w, lo.w);
      const long long o = (head * p.Sk + key) * D + c;
      *reinterpret_cast<float4*>(w.kh + o) = hi;
      *reinterpret_cast<float4*>(w.kl + o) = lo;
      vv = *reinterpret_cast<const float4*>(vb + key * p.v_ss + c);
    }
    vs[r][c] = vv.x;
    vs[r][c + 1] = vv.y;
    vs[r][c + 2] = vv.z;
    vs[r][c + 3] = vv.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * kSplitKeys; i += kSplitThreads) {
    const int d = i / kSplitKeys, pos = i % kSplitKeys;
    if (k0 + pos >= w.Skp) continue;
    float hi, lo;
    tf32_split(vs[vt_key(pos)][d], hi, lo);
    const long long o = (head * D + d) * w.Skp + k0 + pos;
    w.vth[o] = hi;
    w.vtl[o] = lo;
  }
}

template <int D>
int launch_split_kv(const Params& p, const SplitKV& w, cudaStream_t stream) {
  dim3 grid((w.Skp + kSplitKeys - 1) / kSplitKeys, p.H, p.B);
  split_kv_kernel<D><<<grid, kSplitThreads, 0, stream>>>(p, w);
  return cudaGetLastError();
}

// Shared memory of the fp32 kernel: the Q tile (128 rows, D/32 atoms of 16
// KB), then a ring of two slots that alternate K_j (hi atoms, then lo) and
// V^T_j (hi atoms, then lo).
template <int D>
struct F32Layout {
  static constexpr int kKAtom = kF32BlockN * 128;    // 64 keys x 32 fp32
  static constexpr int kVAtom = D * 128;             // D rows x 32 keys
  static constexpr int kHalf = kF32BlockN * D * 4;   // hi (or lo) of one K or V^T tile
  static constexpr int kSlot = 2 * kHalf;
  static constexpr int kQ = 0;
  static constexpr int kSlots = kQ + kBlockM * D * 4;  // + slot * kSlot
  static constexpr int kBars = kSlots + 2 * kSlot;     // q_full, full[2], empty[2]
  static constexpr int kBytes = kBars + 8 * 5;
  static constexpr int kAlloc = kBytes + 1024;
};
static_assert(F32Layout<128>::kAlloc <= 232448, "shared memory above the 227 KB a block may use");

// Q[row][col] of the swizzled fp32 Q tile in shared memory.
__device__ __forceinline__ float q_at(const uint8_t* q, int row, int col) {
  const int chunk = ((col % kF32AtomCols) >> 2) ^ (row & 7);
  return *reinterpret_cast<const float*>(q + (col / kF32AtomCols) * kF32QAtom +
                                         row * 128 + chunk * 16 + (col & 3) * 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_kh,
                     const __grid_constant__ CUtensorMap tm_kl,
                     const __grid_constant__ CUtensorMap tm_vh,
                     const __grid_constant__ CUtensorMap tm_vl, const Params p) {
  using L = F32Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;   // [0]: K slot, [1]: V^T slot
  uint64_t* empty = full + 2;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int n_tiles = (p.Sk + kF32BlockN - 1) / kF32BlockN;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: K_0, V^T_0, K_1, V^T_1, ... into the two slots ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_kh);
      tma_prefetch_desc(&tm_kl);
      tma_prefetch_desc(&tm_vh);
      tma_prefetch_desc(&tm_vl);
      mbar_arrive_expect_tx(q_full, kBlockM * D * 4);
#pragma unroll
      for (int a = 0; a < D / kF32AtomCols; ++a)
        tma_load_4d(smem + L::kQ + a * kF32QAtom, &tm_q, q_full, a * kF32AtomCols, q0, h, b);
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i & 1, j = i >> 1;
        mbar_wait(&empty[s], (j & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], L::kSlot);
        uint8_t* slot = smem + L::kSlots + s * L::kSlot;
        if (s == 0) {
#pragma unroll
          for (int a = 0; a < D / kF32AtomCols; ++a) {
            tma_load_4d(slot + a * L::kKAtom, &tm_kh, &full[0], a * kF32AtomCols, j * kF32BlockN, h, b);
            tma_load_4d(slot + L::kHalf + a * L::kKAtom, &tm_kl, &full[0], a * kF32AtomCols,
                        j * kF32BlockN, h, b);
          }
        } else {
#pragma unroll
          for (int a = 0; a < kF32BlockN / kF32AtomCols; ++a) {
            tma_load_4d(slot + a * L::kVAtom, &tm_vh, &full[1], j * kF32BlockN + a * kF32AtomCols, 0, h, b);
            tma_load_4d(slot + L::kHalf + a * L::kVAtom, &tm_vl, &full[1],
                        j * kF32BlockN + a * kF32AtomCols, 0, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    setmaxnreg_inc<240>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 64 * c + 16 * warp + g;  // this thread's rows in the tile: r0, r0 + 8
    const int ra = q0 + r0, rb = ra + 8;
    const int32_t* mask_row = p.kv_mask ? p.kv_mask + (long long)b * p.Sk : nullptr;
    const uint8_t* qs = smem + L::kQ;
    const uint32_t k_addr = smem_addr(smem + L::kSlots);
    const uint32_t v_addr = k_addr + L::kSlot;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kMaskedScore, m1 = kMaskedScore;
    float l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      // S = Q K^T over D in k-steps of 8, 64 columns (8 k-steps) at a
      // time: Q's fragments are read from shared memory and split here; each
      // 64 columns go into a fresh accumulator, the small products first,
      // then hi x hi, and are added to S in fp32.
      mbar_wait(&full[0], n & 1);
      float sc[kF32BlockN / 2];
#pragma unroll
      for (int c64 = 0; c64 < D / 64; ++c64) {
        uint32_t qh[8][4], ql[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int col = c64 * 64 + kk * 8 + t;
          tf32_split(q_at(qs, r0, col), qh[kk][0], ql[kk][0]);
          tf32_split(q_at(qs, r0 + 8, col), qh[kk][1], ql[kk][1]);
          tf32_split(q_at(qs, r0, col + 4), qh[kk][2], ql[kk][2]);
          tf32_split(q_at(qs, r0 + 8, col + 4), qh[kk][3], ql[kk][3]);
        }
        float part[kF32BlockN / 2];
#pragma unroll
        for (int i = 0; i < kF32BlockN / 2; ++i) part[i] = 0.f;
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int ks = c64 * 8 + kk;
          const uint32_t off = (ks / 4) * L::kKAtom + (ks % 4) * 32;
          wgmma_tf32_rs<kF32BlockN>(part, ql[kk], wgmma_desc(k_addr + off, 16, 1024));
          wgmma_tf32_rs<kF32BlockN>(part, qh[kk], wgmma_desc(k_addr + L::kHalf + off, 16, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int ks = c64 * 8 + kk;
          const uint32_t off = (ks / 4) * L::kKAtom + (ks % 4) * 32;
          wgmma_tf32_rs<kF32BlockN>(part, qh[kk], wgmma_desc(k_addr + off, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < kF32BlockN / 2; ++i) sc[i] = c64 == 0 ? part[i] : sc[i] + part[i];
      }
      if (lane == 0) mbar_arrive(&empty[0]);  // this warp is done with K_n

      online_softmax<kF32BlockN, D>(sc, o, n * kF32BlockN, t, p, mask_row, m0, m1, l0, l1);

      // O += P V: P split in registers as the A operand, V^T_n (keys
      // permuted within each 8, vt_key) as the K-major B operand.
      uint32_t ph[kF32BlockN / 8][4], pl[kF32BlockN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kF32BlockN / 8; ++kk) {
        tf32_split(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
        tf32_split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
        tf32_split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
        tf32_split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      // This tile's P V goes into a fresh accumulator (the small products
      // first), added to O in fp32: the tensor core's own fp32 sums round
      // toward zero, and a chain over every key of Sk would drift.
      float pv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
      fence_regs(pv);
      mbar_wait(&full[1], n & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kF32BlockN / 8; ++kk) {
        const uint32_t off = (kk / 4) * L::kVAtom + (kk % 4) * 32;
        wgmma_tf32_rs<D>(pv, pl[kk], wgmma_desc(v_addr + off, 16, 1024));
        wgmma_tf32_rs<D>(pv, ph[kk], wgmma_desc(v_addr + L::kHalf + off, 16, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < kF32BlockN / 8; ++kk) {
        const uint32_t off = (kk / 4) * L::kVAtom + (kk % 4) * 32;
        wgmma_tf32_rs<D>(pv, ph[kk], wgmma_desc(v_addr + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      if (lane == 0) mbar_arrive(&empty[1]);  // this warp is done with V^T_n
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
    }

    reduce_row_sums(l0, l1);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    float* obase = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (ra < p.Sq)
        *reinterpret_cast<float2*>(obase + ra * p.o_ss + col) =
            make_float2(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      if (rb < p.Sq)
        *reinterpret_cast<float2*>(obase + rb * p.o_ss + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    store_stats(p, b, h, ra, rb, t, m0, m1, l0, l1);
  }
}

// The pre-pass, then the mainloop, on the caller's workspace `ws`.
template <int D>
int launch_f32(const Params& p, float* ws, cudaStream_t stream) {
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const SplitKV w = split_views(ws, p.B, p.H, p.Sk, D);
  int err = launch_split_kv<D>(p, w, stream);
  if (err != 0) return err;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  const long long ks = D, kh = (long long)p.Sk * D, kb = (long long)p.H * kh;
  const long long vs = w.Skp, vh = (long long)D * w.Skp, vb = (long long)p.H * vh;
  err = make_tensor_map_f32(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, kBlockM);
  if (err == 0) err = make_tensor_map_f32(&tkh, w.kh, D, p.Sk, p.H, p.B, ks, kh, kb, kF32BlockN);
  if (err == 0) err = make_tensor_map_f32(&tkl, w.kl, D, p.Sk, p.H, p.B, ks, kh, kb, kF32BlockN);
  if (err == 0) err = make_tensor_map_f32(&tvh, w.vth, w.Skp, D, p.H, p.B, vs, vh, vb, D);
  if (err == 0) err = make_tensor_map_f32(&tvl, w.vtl, w.Skp, D, p.H, p.B, vs, vh, vb, D);
  if (err != 0) return err;
  constexpr int smem = F32Layout<D>::kAlloc;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tkh, tkl, tvh, tvl, p);
  return cudaGetLastError();
}

// dtype: 0 bf16, 1 fp32, 2 fp16.
int launch(const Params& p, int D, int dtype, float* ws, cudaStream_t stream) {
  if (dtype == 0 && D == 128) return launch_16bit<128, __nv_bfloat16>(p, stream);
  if (dtype == 0 && D == 64) return launch_16bit<64, __nv_bfloat16>(p, stream);
  if (dtype == 1 && D == 128) return launch_f32<128>(p, ws, stream);
  if (dtype == 1 && D == 64) return launch_f32<64>(p, ws, stream);
  if (dtype == 2 && D == 128) return launch_16bit<128, __half>(p, stream);
  if (dtype == 2 && D == 64) return launch_16bit<64, __half>(p, stream);
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

// ---------------------------------------------------------------------------
// Kernel F's pre-pass: q^, k^ = rope(rms_norm(x) * scale), rounded to T
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* src) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src);
  return make_float2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ float2 load_pair(const __half* src) {
  return __half22float2(*reinterpret_cast<const __half2*>(src));
}
__device__ __forceinline__ float2 load_pair(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(__half* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_f16(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

constexpr int kPrepassWarps = 8;

// One warp per row of q or k; q^ and k^ are written contiguously as
// (B, H, S, D). Rows run in (b, s, q or k, h) order, h fastest, so the 2H
// rows that rotate by one table row run together and the tables (larger
// than L2 at the Stage-I shape) are read from memory about once.
template <int D, typename T>
__global__ void __launch_bounds__(kPrepassWarps * 32)
norm_rope_kernel(const Params p, T* qn, T* kn, const float* cos, const float* sin,
                 const float* q_scale, const float* k_scale) {
  constexpr int P = D / 32;
  const long long row = (long long)blockIdx.x * kPrepassWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= 2LL * p.B * p.H * p.Sq) return;  // the same for the whole warp
  const int h = static_cast<int>(row % p.H);
  const bool is_k = (row / p.H) % 2;
  const long long bs = row / (2 * p.H);
  const int s = static_cast<int>(bs % p.Sq), b = static_cast<int>(bs / p.Sq);
  const T* src = is_k ? static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + s * p.k_ss
                      : static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + s * p.q_ss;
  src += lane * P;
  float x[P];
#pragma unroll
  for (int i = 0; i < P; i += 2) {
    const float2 v = load_pair(src + i);
    x[i] = v.x;
    x[i + 1] = v.y;
  }
  norm_rope<D>(x, cos + bs * D, sin + bs * D, is_k ? k_scale : q_scale, lane);
  T* dst = (is_k ? kn : qn) + (((long long)b * p.H + h) * p.Sq + s) * D + lane * P;
#pragma unroll
  for (int i = 0; i < P; i += 2) store_pair(dst + i, x[i], x[i + 1]);
}

template <int D, typename T>
int launch_prepass(const Params& p, void* qn, void* kn, const float* cos, const float* sin,
                   const float* q_scale, const float* k_scale, cudaStream_t stream) {
  const long long rows = 2LL * p.B * p.H * p.Sq;
  const long long blocks = (rows + kPrepassWarps - 1) / kPrepassWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  norm_rope_kernel<D, T><<<static_cast<unsigned>(blocks), kPrepassWarps * 32, 0, stream>>>(
      p, static_cast<T*>(qn), static_cast<T*>(kn), cos, sin, q_scale, k_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. `strides` holds 12 element strides:
// (batch, head, seq) for q, k, v, o in that order. dtype: 0 = bf16, 1 = fp32,
// 2 = fp16.
// `ws`: fp32 only (null for bf16 and fp16), the caller's workspace of
// 2*B*H*Sk*D + 2*B*H*D*Skp floats, Skp = Sk rounded up to a multiple of 8,
// for the split pre-pass (k_hi, k_lo, v^T_hi, v^T_lo). Returns 0 on
// success, else the cudaError_t of the launch, or 10000 when no tensor-map
// encoder was found, or 20000 + the CUresult of a refused tensor map.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         const int32_t* kv_mask, float* m_out, float* l_out, float* ws,
                         const long long* strides, int B, int H, int Sq, int Sk,
                         int D, int dtype, float scale, void* stream) {
  Params p = strided_params(q, k, v, o, strides);
  p.kv_mask = kv_mask; p.m_out = m_out; p.l_out = l_out;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.scale = scale;
  return launch(p, D, dtype, ws, static_cast<cudaStream_t>(stream));
}

// The fp32 path's split pre-pass alone (flash_fwd launches it itself), for
// checking its workspaces: k, v fp32 (B,H,Sk,D) with `strides` (batch,
// head, seq) of k then v; `ws` as flash_fwd's.
extern "C" int flash_split_kv(const void* k, const void* v, float* ws, const long long* strides,
                              int B, int H, int Sk, int D, void* stream) {
  Params p = {};
  p.k = k; p.v = v;
  p.k_sb = strides[0]; p.k_sh = strides[1]; p.k_ss = strides[2];
  p.v_sb = strides[3]; p.v_sh = strides[4]; p.v_ss = strides[5];
  p.B = B; p.H = H; p.Sk = Sk;
  const SplitKV w = split_views(ws, B, H, Sk, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_split_kv<128>(p, w, st);
  if (D == 64) return launch_split_kv<64>(p, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel F's C entry point: self-attention (Sq = Sk = S) of pre-norm q, k, v
// with fp32 qk-norm + interleaved RoPE. Launches the pre-pass, which writes
// q^ and k^ into the caller's contiguous (B,H,S,D) workspaces qn, kn (the
// dtype of q), then kernel A's mainloop on q^, k^ and v (fp32: its split
// pre-pass on k^ and v into `ws`, then the mainloop). cos/sin contiguous
// (B,S,D) fp32, the norm scales contiguous (D,) fp32; `strides`, dtype, `ws`
// and the return value as flash_fwd's.
extern "C" int flash_fused(const void* q, const void* k, const void* v, void* o, void* qn,
                           void* kn, const float* cos, const float* sin, const float* q_scale,
                           const float* k_scale, float* ws, const long long* strides, int B,
                           int H, int S, int D, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = strided_params(q, k, v, o, strides);
  p.B = B; p.H = H; p.Sq = S; p.Sk = S; p.scale = scale;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128) err = launch_prepass<128, __nv_bfloat16>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (dtype == 0 && D == 64) err = launch_prepass<64, __nv_bfloat16>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (dtype == 1 && D == 128) err = launch_prepass<128, float>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (dtype == 1 && D == 64) err = launch_prepass<64, float>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (dtype == 2 && D == 128) err = launch_prepass<128, __half>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (dtype == 2 && D == 64) err = launch_prepass<64, __half>(p, qn, kn, cos, sin, q_scale, k_scale, st);
  if (err != 0) return err;
  // the mainloop reads the dense workspaces in place of q and k
  const long long dense[3] = {(long long)H * S * D, (long long)S * D, D};
  p.q = qn; p.q_sb = dense[0]; p.q_sh = dense[1]; p.q_ss = dense[2];
  p.k = kn; p.k_sb = dense[0]; p.k_sh = dense[1]; p.k_ss = dense[2];
  return launch(p, D, dtype, ws, st);
}
