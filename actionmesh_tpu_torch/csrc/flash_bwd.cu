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
// owns one (b, h, key tile) and walks every query tile, keeping dK and dV in
// fp32 registers; a block of kernel D owns one (b, h, query tile) and walks
// every key tile, keeping dQ in registers. Two kernels, no atomics: the
// gradients are deterministic, bit for bit from call to call.
//
// What bounds it: with U = B*H*Sq*Sk*D, the least work of the backward is
// 10U flops (S and dP once, then dV, dK and dQ; chip_smoke.py counts 6U to C
// and 4U to D), against O((Sq+Sk)*D) bytes per (b, h): far above the card's
// ~295 flop/byte balance point, so it is bound by tensor-core issue and the
// exp work between the products. Two kernels without atomics recompute S and
// dP in both: C does 8U (S^T, dP^T, dV, dK) and D 6U (S, dP, dQ), 14U in all,
// 1.4x the least work, the price of determinism.
//
// bf16 design: TMA + wgmma, warp-specialised, on kernel A's skeleton.
//   * One CTA of 3 warpgroups. Warpgroup 0 is the producer (setmaxnreg down
//     to 24): one thread TMA-loads the CTA's own tiles once and then a ring
//     of tiles of the walked axis, each stage guarded by a full/empty mbarrier
//     pair. Warpgroups 1 and 2 are consumers (setmaxnreg up to 240), each
//     owning 64 rows of the CTA's tile. Tensor maps are rank 4 (D, S, H, B)
//     with the caller's strides and the 128-byte swizzle (sm90.cuh); TMA
//     fills rows beyond Sq or Sk with zeros.
//   * Kernel C: a CTA owns 128 keys (K and V loaded once) and walks the
//     queries in steps of 64 (Q, dO and the step's L and delta in a
//     3-stage ring; warp 0 of the producer stages L and delta, rows past Sq
//     as L = 1e30, so their P is exactly 0). Per step each consumer
//     computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands
//     from shared memory, K-major), P^T = exp(scale S^T - L) per query
//     column, dV += P^T dO (P^T packed to bf16 in registers as the A
//     fragment, dO MN-major with the transpose bit), dS^T = P^T (dP^T -
//     delta) scale and dK += dS^T Q the same way. dK and dV stay in fp32
//     registers for the whole walk (64 + 64 a thread at D = 128, with 32 for
//     S^T and 32 for dP^T). Keys past Sk read zero rows and are never stored.
//   * Kernel D: a CTA owns 128 queries (Q and dO loaded once, L and delta of
//     its two rows read once per thread) and walks 128-key tiles of K and V
//     in a 2-stage ring. Per tile: S = Q K^T and dP = dO V^T (wgmma
//     m64n128k16, shared memory), P = exp(scale S - L) with keys >= Sk set
//     to exactly 0 (the last tile only), dS = P (dP - delta) scale and
//     dQ += dS K (dS from registers, K MN-major). dQ 64 + S 64 + dP 64
//     registers a thread at D = 128.
//   * Each product is waited for before its result is read; the products of
//     a step are issued back to back (S^T then dP^T; dV runs while dS^T is
//     computed), and a consumer warp frees a stage after the last product
//     that reads it has completed (8 arrivals).
//   Not in this version (later work): overlap of one step's exp work with the
//   next step's products inside a warpgroup, pingpong scheduling of the two
//   consumers, a persistent tile scheduler, TMA stores.
// fp32 design: split precision ("3xTF32") on TF32 wgmma, TMA, warp-specialised,
// on kernel A's fp32 path and the bf16 skeleton above. Every product is three
// TF32 products of split operands, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the
// small terms first (tf32_split in sm90.cuh, bit-identical to kernel A's and
// to ops/flash_attention.py:tf32_split). Both kernels are bound by the
// products: at the Stage-I self shape (2,16,32784,32784,128) C does 6U and D
// 4U of least work (U = B*H*Sq*Sk*D = 4.4e12), 160 and 107 ms at 495/3
// TFLOP/s, against ~3 GB of inputs and outputs (~1 ms at 3.35 TB/s).
//   * TF32 wgmma takes K-major operands only (no transpose bit), so each
//     product reduces along a contiguous axis:
//       C: S^T = K Q^T and dP^T = V dO^T over D (B: q, dO as they are);
//          dV += P^T dO and dK += dS^T Q over the queries (B: dO^T, q^T);
//       D: S = Q K^T and dP = dO V^T over D (B: k, v as they are);
//          dQ += dS K over the keys (B: k^T).
//     A pre-pass (split_bwd_kernel, one launch before each kernel) reads the
//     walked inputs once through their strides and writes the B operands
//     split into hi and lo into one fp32 workspace the caller allocates: C's
//     q, dO (B,H,Sq,D) and q^T, dO^T (B,H,D,Sqp); D's k, v (B,H,Sk,D) and
//     k^T (B,H,D,Skp); Sqp, Skp rounded up to 8. Within each group of 8 the
//     transposed tensors store row vt_key(p) at position p, so an
//     accumulator's columns (2t, 2t+1) are the A-fragment's columns (t, t+4)
//     of the next product: P^T, dS^T and dS go from accumulator to register
//     operand with no shuffles. At Stage-I self one (B,H,S,D) fp32 tensor is
//     537 MB: C's workspace 4.3 GB, D's 3.2 GB, allocated one after the other.
//   * The A operands (C: k, v; D: q, dO) are the CTA's own rows: loaded
//     once by TMA as raw fp32 and split in registers when a step reads them
//     (kernel A's way with Q), 16 (C) or 32 (D) columns at a time, D into
//     two buffers so that it splits the next columns while the products
//     run. That split is the kernels' largest ALU cost (128 values a thread
//     a step), so it takes tf32_split_finite: three operations, the same
//     bits for every finite input below 2^128 (1 - 2^-12); an inf or NaN
//     input gives NaN where tf32_split gives inf or NaN. (With tf32_split
//     there C took about a quarter and D a third longer at Stage-I self on
//     an H100.) P, dS and the pre-pass keep tf32_split.
//   * Shared memory is the binding limit (227 KB). A CTA owns 128 rows (64
//     a consumer warpgroup) of its two resident inputs, 2 x 64 KB at D = 128,
//     and walks the other axis in steps of 32 rows through a ring of three
//     32 KB slots, each holding one split tile (hi, lo) of a step: C reads
//     q, dO^T, dO, q^T per step, D k, v, k^T. 224 KB, plus C's L and delta
//     of three steps (768 bytes, staged by the producer with the step's first
//     tile; rows past Sq as L = 1e30, so their P is exactly 0). D = 64
//     halves every tile.
//   * The tensor core's own fp32 sums truncate, so a chain of products over
//     the walked axis drifts: every step's share of dV and dK (64 columns
//     at a time) or dQ (all of D) goes into a fresh accumulator (12
//     products) that is added in IEEE fp32. S (S^T) and dP (dP^T) end with their step: one chain of 3 D / 8
//     products (48 at D = 128).
//   * Registers (setmaxnreg 240 for the consumers): C holds dK and dV (64 +
//     64 a thread at D = 128), and at its peak P's split fragments (32),
//     dP^T (16) and the A fragments of V being split. A step of C runs S^T,
//     dV, dP^T, dK in that order, so P's fragments and dP^T are never live
//     beside a fresh 32-register accumulator; the fragments of P become
//     dS's in place (P = hi + lo exactly). The resident tiles are read with
//     32-bit shared addresses: with generic 64-bit ones kernel C spilled.
//     Spills move non-monotonically with these choices: ptxas decides.
//   * Keys past Sk: D sets their P to exactly 0; C never stores their rows.
//     Two kernels, no atomics: bit-for-bit deterministic.
//   Not in this version: pingpong of the consumers, overlap of the exp work
//   with the next products, the finite split for P and dS (faster, but
//   kernel C spilled), a persistent scheduler, multicast of the walked
//   tiles.
// The caller passes element strides for batch, head and sequence of every
// tensor; the last axis must be contiguous, strides and addresses 16-byte
// aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
__device__ __forceinline__ T* head_ptr_out(void* base, long long sb, long long sh, int b,
                                           int h) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kThreads = 3 * 128;  // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;  // arrivals that free a stage
constexpr int kRowBytes = 128;     // a row of a swizzle atom: 64 bf16

constexpr int kDkvBlockN = 128;  // kernel C: keys per CTA, 64 per consumer
constexpr int kDkvBlockM = 64;   // kernel C: queries per step
constexpr int kDkvStages = 3;
constexpr int kDqBlockM = 128;   // kernel D: queries per CTA, 64 per consumer
constexpr int kDqBlockN = 128;   // kernel D: keys per step
constexpr int kDqStages = 2;

// Bytes of a rows x D bf16 tile as TMA writes it: D / 64 atoms of rows x 128 bytes.
template <int D>
constexpr int tile_bytes(int rows) {
  return (D / 64) * rows * kRowBytes;
}

// K-major descriptor of the 16 columns kk*16.. of a tile whose atoms hold
// `rows` rows, from `addr` (the tile's base, or a 64-row offset into it).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk, int rows) {
  return wgmma_desc(addr + (kk / 4) * rows * kRowBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor of the 16 rows kk*16.. of a tile whose atoms hold `rows`
// rows (the B operand of a product over those rows, D wide).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk, int rows) {
  return wgmma_desc(addr + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

// Accumulator columns 16kk..16kk+15 packed pairwise to bf16: the register A
// fragment of the next product (layout note in sm90.cuh).
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Rows ra and ra + 8 of a 64 x D fp32 accumulator -> bf16 in global, rows at
// or past `limit` skipped.
template <int D>
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* base, long long ss, int ra,
                                               int limit, const float (&acc)[D / 2], int t) {
  const int rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < limit)
      *reinterpret_cast<uint32_t*>(base + ra * ss + col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (rb < limit)
      *reinterpret_cast<uint32_t*>(base + rb * ss + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int D>
struct DkvSmem {
  static constexpr int kKV = tile_bytes<D>(kDkvBlockN);  // the K or V tile
  static constexpr int kQ = tile_bytes<D>(kDkvBlockM);   // a Q or dO stage
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQs = kV + kKV;                   // + stage * kQ
  static constexpr int kDOs = kQs + kDkvStages * kQ;     // + stage * kQ
  static constexpr int kStats = kDOs + kDkvStages * kQ;  // per stage: L, then delta
  static constexpr int kBars = kStats + kDkvStages * 2 * kDkvBlockM * 4;  // kv_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkvStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base to 1024 bytes
};
static_assert(DkvSmem<128>::kAlloc <= 232448, "shared memory above the 227 KB a block may use");

template <int D>
struct DqSmem {
  static constexpr int kQ = tile_bytes<D>(kDqBlockM);   // the Q or dO tile
  static constexpr int kKV = tile_bytes<D>(kDqBlockN);  // a K or V stage
  static constexpr int kQo = 0;
  static constexpr int kDO = kQ;
  static constexpr int kKs = 2 * kQ;                    // + stage * kKV
  static constexpr int kVs = kKs + kDqStages * kKV;     // + stage * kKV
  static constexpr int kBars = kVs + kDqStages * kKV;   // q_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDqStages);
  static constexpr int kAlloc = kBytes + 1024;
};
static_assert(DqSmem<128>::kAlloc <= 232448, "shared memory above the 227 KB a block may use");

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  // the 128-byte swizzle repeats every 1024 bytes: atoms start on that grid
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Kernel C: dK and dV for one (128-key tile, head, batch).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = DkvSmem<D>;
  constexpr int BM = kDkvBlockM, BN = kDkvBlockN, kStages = kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);  // stage s: L at 2*s*BM, delta at (2s+1)*BM

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BN;
  const int n_tiles = (p.Sq + BM - 1) / BM;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the 32 lanes of the producer's warp 0
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: warp 0 keeps the ring of Q, dO, L and delta filled ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_desc(&tm_q);
        tma_prefetch_desc(&tm_k);
        tma_prefetch_desc(&tm_v);
        tma_prefetch_desc(&tm_do);
        mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          tma_load_4d(smem + L::kK + a * BN * kRowBytes, &tm_k, kv_full, a * 64, k0, h, b);
          tma_load_4d(smem + L::kV + a * BN * kRowBytes, &tm_v, kv_full, a * 64, k0, h, b);
        }
      }
      const long long stat0 = ((long long)b * p.H + h) * p.Sq;
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);  // the first round passes at once
        float* st = stats + 2 * s * BM;
        for (int i = lane; i < BM; i += 32) {
          const int q = n * BM + i;
          st[i] = q < p.Sq ? p.lse[stat0 + q] : kRowPad;
          st[BM + i] = q < p.Sq ? p.delta[stat0 + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            tma_load_4d(smem + L::kQs + s * L::kQ + a * BM * kRowBytes, &tm_q, &full[s], a * 64,
                        n * BM, h, b);
            tma_load_4d(smem + L::kDOs + s * L::kQ + a * BM * kRowBytes, &tm_do, &full[s],
                        a * 64, n * BM, h, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    setmaxnreg_inc<240>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;  // accumulator column pair; rows are 16 * warp + lane / 4 (+ 8)
    const uint32_t k_addr = smem_addr(smem + L::kK) + c * 64 * kRowBytes;
    const uint32_t v_addr = smem_addr(smem + L::kV) + c * 64 * kRowBytes;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      mbar_wait(&full[s], (n / kStages) & 1);
      const uint32_t q_addr = smem_addr(smem + L::kQs + s * L::kQ);
      const uint32_t do_addr = smem_addr(smem + L::kDOs + s * L::kQ);
      const float* lse_s = stats + 2 * s * BM;
      const float* delta_s = lse_s + BM;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, over D
      float st[BM / 2], dpt[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(st, kmajor_desc(k_addr, kk, BN), kmajor_desc(q_addr, kk, BM), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(dpt, kmajor_desc(v_addr, kk, BN), kmajor_desc(do_addr, kk, BM), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done
      fence_regs(st);

      // P^T = exp(scale S^T - L): st[4j + e] is query column 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        st[4 * j + 0] = __expf(st[4 * j + 0] * p.scale - l.x);
        st[4 * j + 1] = __expf(st[4 * j + 1] * p.scale - l.y);
        st[4 * j + 2] = __expf(st[4 * j + 2] * p.scale - l.x);
        st[4 * j + 3] = __expf(st[4 * j + 3] * p.scale - l.y);
      }

      // dV += P^T dO: P^T (bf16) as register A fragments, 16 queries per product
      uint32_t pa[BM / 16][4];
      pack_frags<BM>(pa, st);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs<D>(dv, pa[kk], mnmajor_desc(do_addr, kk, BM), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; dV may still run
      fence_regs(dpt);

      // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - d.x) * p.scale;
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y) * p.scale;
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x) * p.scale;
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y) * p.scale;
      }
      uint32_t dsa[BM / 16][4];
      pack_frags<BM>(dsa, dpt);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs<D>(dk, dsa[kk], mnmajor_desc(q_addr, kk, BM), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_frags(pa);  // the fragments were read until here
      fence_frags(dsa);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    const int ra = k0 + 64 * c + 16 * warp + lane / 4;
    store_acc_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dk, p.dk_sb, p.dk_sh, b, h), p.dk_ss, ra,
                      p.Sk, dk, t);
    store_acc_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dv, p.dv_sb, p.dv_sh, b, h), p.dv_ss, ra,
                      p.Sk, dv, t);
  }
}

// Kernel D: dQ for one (128-query tile, head, batch).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = DqSmem<D>;
  constexpr int BM = kDqBlockM, BN = kDqBlockN, kStages = kDqStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int n_tiles = (p.Sk + BN - 1) / BN;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread keeps the ring of K/V tiles filled ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      tma_prefetch_desc(&tm_do);
      mbar_arrive_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
      for (int a = 0; a < D / 64; ++a) {
        tma_load_4d(smem + L::kQo + a * BM * kRowBytes, &tm_q, q_full, a * 64, q0, h, b);
        tma_load_4d(smem + L::kDO + a * BM * kRowBytes, &tm_do, q_full, a * 64, q0, h, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          tma_load_4d(smem + L::kKs + s * L::kKV + a * BN * kRowBytes, &tm_k, &full[s], a * 64,
                      n * BN, h, b);
          tma_load_4d(smem + L::kVs + s * L::kKV + a * BN * kRowBytes, &tm_v, &full[s], a * 64,
                      n * BN, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 queries per warpgroup ----
    setmaxnreg_inc<240>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int ra = q0 + 64 * c + 16 * warp + lane / 4, rb = ra + 8;
    const long long stat0 = ((long long)b * p.H + h) * p.Sq;
    const float lse_a = ra < p.Sq ? p.lse[stat0 + ra] : kRowPad;
    const float lse_b = rb < p.Sq ? p.lse[stat0 + rb] : kRowPad;
    const float delta_a = ra < p.Sq ? p.delta[stat0 + ra] : 0.f;
    const float delta_b = rb < p.Sq ? p.delta[stat0 + rb] : 0.f;
    const uint32_t q_addr = smem_addr(smem + L::kQo) + c * 64 * kRowBytes;
    const uint32_t do_addr = smem_addr(smem + L::kDO) + c * 64 * kRowBytes;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      mbar_wait(&full[s], (n / kStages) & 1);
      const uint32_t k_addr = smem_addr(smem + L::kKs + s * L::kKV);
      const uint32_t v_addr = smem_addr(smem + L::kVs + s * L::kKV);

      // S = Q K^T and dP = dO V^T: 64 queries x 128 keys each, over D
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, kmajor_desc(q_addr, kk, BM), kmajor_desc(k_addr, kk, BN), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(dp, kmajor_desc(do_addr, kk, BM), kmajor_desc(v_addr, kk, BN), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S is done
      fence_regs(sc);

      // P = exp(scale S - L): sc[4j + e] is key 8j + 2t + (e & 1) of row ra
      // (e < 2) or rb; keys >= Sk are exactly 0 (the last tile only)
      const int key0 = n * BN;
      if (key0 + BN > p.Sk) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = key0 + 8 * j + 2 * t;
          sc[4 * j + 0] = col < p.Sk ? __expf(sc[4 * j + 0] * p.scale - lse_a) : 0.f;
          sc[4 * j + 1] = col + 1 < p.Sk ? __expf(sc[4 * j + 1] * p.scale - lse_a) : 0.f;
          sc[4 * j + 2] = col < p.Sk ? __expf(sc[4 * j + 2] * p.scale - lse_b) : 0.f;
          sc[4 * j + 3] = col + 1 < p.Sk ? __expf(sc[4 * j + 3] * p.scale - lse_b) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          sc[4 * j + 0] = __expf(sc[4 * j + 0] * p.scale - lse_a);
          sc[4 * j + 1] = __expf(sc[4 * j + 1] * p.scale - lse_a);
          sc[4 * j + 2] = __expf(sc[4 * j + 2] * p.scale - lse_b);
          sc[4 * j + 3] = __expf(sc[4 * j + 3] * p.scale - lse_b);
        }
      }
      wgmma_wait<0>();  // dP is done
      fence_regs(dp);

      // dS = P (dP - delta) scale, then dQ += dS K (K MN-major)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        dp[4 * j + 0] = sc[4 * j + 0] * (dp[4 * j + 0] - delta_a) * p.scale;
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - delta_a) * p.scale;
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - delta_b) * p.scale;
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - delta_b) * p.scale;
      }
      uint32_t dsa[BN / 16][4];
      pack_frags<BN>(dsa, dp);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(dq, dsa[kk], mnmajor_desc(k_addr, kk, BN), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_frags(dsa);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    store_acc_bf16<D>(head_ptr_out<__nv_bfloat16>(p.dq, p.dq_sb, p.dq_sh, b, h), p.dq_ss, ra,
                      p.Sq, dq, t);
  }
}

// ---------------------------------------------------------------------------
// fp32 path: split precision (3xTF32) on TF32 wgmma, TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 128;     // rows a CTA owns (C: keys, D: queries), 64 per consumer
constexpr int kF32Step = 32;      // rows of the walked axis a step reads (C: queries, D: keys)
constexpr int kF32Slots = 3;      // depth of the ring, in tiles
constexpr int kF32AtomCols = 32;  // fp32 columns of one 128-byte swizzle row
constexpr int kSplitRows = 32;    // rows per block of the split pre-pass
constexpr int kSplitThreads = 256;

// One source of the split pre-pass: x (B,H,S,D) read through its strides,
// written as hi and lo (B,H,S,D), contiguous, and, where th is not null, as
// x^T's hi and lo (B,H,D,Sp), Sp = S rounded up to 8, the rows of each group
// of 8 permuted (vt_key) and zero past S.
struct SplitJob {
  const float* x;
  long long sb, sh, ss;
  float *hi, *lo, *th, *tl;
};

struct SplitArgs {
  SplitJob job[2];
  int B, H, S, Sp;
};

// The workspace of one kernel's call, fp32, contiguous: hi, lo of job 0,
// hi, lo of job 1 (B,H,S,D each), then the transposed hi, lo of job 0 and,
// with n_transposed = 2, of job 1 (B,H,D,Sp each). Kernel C: job 0 q, job 1
// dO, both transposed, S = Sq. Kernel D: job 0 k (transposed), job 1 v,
// S = Sk.
SplitArgs split_args(const void* x0, const long long* st0, const void* x1, const long long* st1,
                     float* ws, int B, int H, int S, int D, int n_transposed) {
  SplitArgs a = {};
  a.B = B; a.H = H; a.S = S; a.Sp = (S + 7) & ~7;
  const long long n = (long long)B * H * S * D, tn = (long long)B * H * D * a.Sp;
  const void* x[2] = {x0, x1};
  const long long* st[2] = {st0, st1};
  float* t = ws + 4 * n;
  for (int j = 0; j < 2; ++j) {
    a.job[j].x = static_cast<const float*>(x[j]);
    a.job[j].sb = st[j][0]; a.job[j].sh = st[j][1]; a.job[j].ss = st[j][2];
    a.job[j].hi = ws + 2 * j * n;
    a.job[j].lo = ws + (2 * j + 1) * n;
    if (j < n_transposed) {
      a.job[j].th = t + 2 * j * tn;
      a.job[j].tl = t + (2 * j + 1) * tn;
    }
  }
  return a;
}

// Pre-pass: one block per (32 rows, head, batch, job) splits those rows of
// the job's x (read once) into hi and lo and, for a transposed job, writes
// the same rows through shared memory, transposed and split.
template <int D>
__global__ void __launch_bounds__(kSplitThreads) split_bwd_kernel(const SplitArgs a) {
  __shared__ float xs[kSplitRows][D + 1];
  const int z = blockIdx.z, b = z % a.B, h = blockIdx.y, r0 = blockIdx.x * kSplitRows;
  const SplitJob w = z < a.B ? a.job[0] : a.job[1];
  const long long head = (long long)b * a.H + h;
  const float* xb = w.x + b * w.sb + h * w.sh;
  for (int i = threadIdx.x; i < kSplitRows * D / 4; i += kSplitThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.S) {
      x = *reinterpret_cast<const float4*>(xb + row * w.ss + c);
      float4 hi, lo;
      tf32_split(x.x, hi.x, lo.x);
      tf32_split(x.y, hi.y, lo.y);
      tf32_split(x.z, hi.z, lo.z);
      tf32_split(x.w, hi.w, lo.w);
      const long long o = (head * a.S + row) * D + c;
      *reinterpret_cast<float4*>(w.hi + o) = hi;
      *reinterpret_cast<float4*>(w.lo + o) = lo;
    }
    xs[r][c] = x.x;
    xs[r][c + 1] = x.y;
    xs[r][c + 2] = x.z;
    xs[r][c + 3] = x.w;
  }
  if (w.th == nullptr) return;  // the same for every thread of the block
  __syncthreads();
  for (int i = threadIdx.x; i < D * kSplitRows; i += kSplitThreads) {
    const int d = i / kSplitRows, pos = i % kSplitRows;
    if (r0 + pos >= a.Sp) continue;
    float hi, lo;
    tf32_split(xs[vt_key(pos)][d], hi, lo);
    const long long o = (head * D + d) * a.Sp + r0 + pos;
    w.th[o] = hi;
    w.tl[o] = lo;
  }
}

template <int D>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  dim3 grid((a.Sp + kSplitRows - 1) / kSplitRows, a.H, 2 * a.B);
  split_bwd_kernel<D><<<grid, kSplitThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Tensor maps of one fp32 launch: the CTA's own rows of its two resident
// inputs (C: k, v; D: q, dO; raw fp32 through the caller's strides), the
// walked inputs' split tiles (C: q, dO; D: k, v; hi, then lo) and the
// transposed split tiles in the order a step reads them (C: dO^T, then q^T;
// D: k^T).
struct F32Maps {
  CUtensorMap x[2];
  CUtensorMap nat_hi[2], nat_lo[2];
  CUtensorMap t_hi[2], t_lo[2];
};

// Shared memory of the fp32 kernels: the two resident tiles (128 rows, D/32
// atoms of 16 KB each), a ring of three slots of one walked tile each (hi,
// then lo: a natural tile is D/32 atoms of 32 rows, a transposed one D rows
// of 32 positions), and for kernel C three steps' L and delta (a step's
// stats ride with its first tile). D = 128: 128 + 96 KB + 768 bytes.
template <int D>
struct F32Smem {
  static constexpr int kAtom = kF32Rows * 128;     // 128 rows x 32 fp32 of a resident tile
  static constexpr int kNatAtom = kF32Step * 128;  // 32 rows x 32 fp32 of a natural tile
  static constexpr int kX = kF32Rows * D * 4;      // one resident tile
  static constexpr int kHalf = kF32Step * D * 4;   // hi (or lo) of a walked tile
  static constexpr int kSlot = 2 * kHalf;
  static constexpr int kSlots = 2 * kX;                     // + slot * kSlot
  static constexpr int kStats = kSlots + kF32Slots * kSlot;  // + (step % 3) * 2 * kF32Step floats
  static constexpr int kBars = kStats + kF32Slots * 2 * kF32Step * 4;  // x_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kF32Slots);
  static constexpr int kAlloc = kBytes + 1024;
};
static_assert(F32Smem<128>::kAlloc <= 232448, "shared memory above the 227 KB a block may use");

// X[row][col] of a resident swizzled fp32 tile at shared address x: a
// 32-bit shared-memory load (a generic pointer would hold each address in
// two registers, which kernel C at D = 128 does not have).
__device__ __forceinline__ float x_at(uint32_t x, int row, int col) {
  const int chunk = ((col % kF32AtomCols) >> 2) ^ (row & 7);
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(x + (col / kF32AtomCols) * (kF32Rows * 128) + row * 128 + chunk * 16 + (col & 3) * 4));
  return v;
}

// The descriptor of the K-major operand at `off` bytes past the one that
// `d` describes: the start address is the low 14 bits, in 16-byte units, and
// no offset into a CTA's shared memory (< 256 KB) carries out of them.
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t off) { return d + (off >> 4); }

// Split A fragments of k-steps ks0 .. ks0 + kKs - 1 (8 columns each) of a
// resident tile's rows r0 and r0 + 8.
template <int kKs>
__device__ __forceinline__ void split_x_frags(uint32_t (&ah)[kKs][4], uint32_t (&al)[kKs][4],
                                              uint32_t x, int r0, int t, int ks0) {
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    const int col = (ks0 + kk) * 8 + t;
    tf32_split_finite(x_at(x, r0, col), ah[kk][0], al[kk][0]);
    tf32_split_finite(x_at(x, r0 + 8, col), ah[kk][1], al[kk][1]);
    tf32_split_finite(x_at(x, r0, col + 4), ah[kk][2], al[kk][2]);
    tf32_split_finite(x_at(x, r0 + 8, col + 4), ah[kk][3], al[kk][3]);
  }
}

// acc (the consumer's 64 rows x 32 walked rows) = X Y^T over D: X's A
// fragments are read from the resident tile (rows r0, r0 + 8) and split in
// registers kKs k-steps (8 columns each) at a time, into kBufs buffers:
// with two, the next k-steps are split while the tensor core runs the
// current ones. Y is a natural split tile of the ring at y (hi atoms, then
// lo). The small products of each kKs k-steps go first, all into acc: a
// chain of 3 D / 8 products (48 at D = 128) that ends with the step (a
// fresh accumulator every 32 columns, as kernel A's, would cost kernel C 16
// registers it does not have); the sums that run over the walked axis are
// product_over_step's.
template <int D, int kKs, int kBufs>
__device__ __forceinline__ void product_over_d(float (&acc)[kF32Step / 2], uint32_t x, int r0,
                                               int t, uint32_t y) {
  using L = F32Smem<D>;
  constexpr int kChunks = D / (8 * kKs);
  const uint64_t dy = wgmma_desc(y, 16, 1024);
#pragma unroll
  for (int i = 0; i < kF32Step / 2; ++i) acc[i] = 0.f;
  uint32_t ah[kBufs][kKs][4], al[kBufs][kKs][4];
  split_x_frags<kKs>(ah[0], al[0], x, r0, t, 0);
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const int cur = ch % kBufs, next = (ch + 1) % kBufs;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const int ks = ch * kKs + kk;
      const uint32_t off = (ks / 4) * L::kNatAtom + (ks % 4) * 32;
      wgmma_tf32_rs<kF32Step>(acc, al[cur][kk], desc_at(dy, off));
      wgmma_tf32_rs<kF32Step>(acc, ah[cur][kk], desc_at(dy, L::kHalf + off));
    }
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const int ks = ch * kKs + kk;
      wgmma_tf32_rs<kF32Step>(acc, ah[cur][kk], desc_at(dy, (ks / 4) * L::kNatAtom + (ks % 4) * 32));
    }
    wgmma_commit();
    if (ch + 1 < kChunks) {
      // the next buffer's products (chunk ch + 1 - kBufs) are done once at
      // most kBufs - 1 groups are pending
      wgmma_wait<kBufs - 1>();
      fence_frags(ah[next]);
      fence_frags(al[next]);
      split_x_frags<kKs>(ah[next], al[next], x, r0, t, (ch + 1) * kKs);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int bf = 0; bf < kBufs; ++bf) {
    fence_frags(ah[bf]);
    fence_frags(al[bf]);
  }
}

// out (the consumer's 64 rows x D) += F W: F the step's P or dS as split A
// fragments (fh, fl: 4 k-steps of 8 walked rows, in vt_key order), W a
// transposed split tile of the ring at w (D rows x 32 walked positions, hi
// then lo). Each kN columns of D go into a fresh accumulator, the small
// products first, and are added to out in fp32 (12 products in a chain).
// The caller keeps fh and fl alive to here (fence_frags).
template <int D, int kN>
__device__ __forceinline__ void product_over_step(float (&out)[D / 2], const uint32_t (&fh)[4][4],
                                                  const uint32_t (&fl)[4][4], uint32_t w) {
  using L = F32Smem<D>;
  const uint64_t dw = wgmma_desc(w, 16, 1024);
#pragma unroll
  for (int cn = 0; cn < D / kN; ++cn) {
    float part[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) part[i] = 0.f;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = cn * kN * 128 + kk * 32;
      wgmma_tf32_rs<kN>(part, fl[kk], desc_at(dw, off));
      wgmma_tf32_rs<kN>(part, fh[kk], desc_at(dw, L::kHalf + off));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_rs<kN>(part, fh[kk], desc_at(dw, cn * kN * 128 + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) out[cn * kN / 2 + i] += part[i];
  }
}

// The accumulator of a 64 x 32 product (v[4j + e]: column 8j + 2t + (e & 1)
// of row g (e < 2) or g + 8) as split A fragments of the next product over
// those 32 columns, in a transposed tile's order (vt_key): position t holds
// column 2t, position t + 4 column 2t + 1: fragment register r holds
// accumulator element frag_elem(r).
__device__ __forceinline__ constexpr int frag_elem(int r) { return r == 1 ? 2 : r == 2 ? 1 : r; }

__device__ __forceinline__ void split_frags(const float (&v)[kF32Step / 2], uint32_t (&fh)[4][4],
                                            uint32_t (&fl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) tf32_split(v[4 * kk + frag_elem(r)], fh[kk][r], fl[kk][r]);
}

// Rows ra and ra + 8 of a 64 x D fp32 accumulator to global, rows at or past
// `limit` skipped.
template <int D>
__device__ __forceinline__ void store_acc_f32(float* base, long long ss, int ra, int limit,
                                              const float (&acc)[D / 2], int t) {
  const int rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < limit)
      *reinterpret_cast<float2*>(base + ra * ss + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (rb < limit)
      *reinterpret_cast<float2*>(base + rb * ss + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Kernel C (kDkv: dK and dV of 128 keys, walking the queries) or kernel D
// (dQ of 128 queries, walking the keys), fp32, for one (row tile, head,
// batch). A step reads kTiles tiles of the ring, in the order of its
// products: C q (S^T), dO^T (dV), dO (dP^T), q^T (dK); D k (S), v (dP),
// k^T (dQ). C takes dV before dP^T, so that P's fragments and dP^T are
// never live beside a fresh accumulator.
template <int D, bool kDkv>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32x3_kernel(const __grid_constant__ F32Maps maps, const Params p) {
  using L = F32Smem<D>;
  constexpr int kTiles = kDkv ? 4 : 3;
  // registers (240 a consumer thread): kernel C holds dK and dV, so it
  // splits its A fragments 2 k-steps at a time into one buffer and takes dV
  // and dK 64 columns at a time; kernel D, holding dQ alone, 4 k-steps into
  // two buffers (split while the products run) and all of D at once. Each
  // choice is the fastest of those that spill nothing, as compiled and timed
  // on an H100 (PERF.md).
  constexpr int kFragKs = kDkv ? 2 : 4, kFragBufs = kDkv ? 1 : 2, kOutN = kDkv ? 64 : D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = x_full + 1;
  uint64_t* empty = full + kF32Slots;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);  // step n: L at (n % 3) * 64, delta + 32

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kF32Rows;
  const int n_steps = ((kDkv ? p.Sq : p.Sk) + kF32Step - 1) / kF32Step;
  const int warpgroup = threadIdx.x / 128;
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
#pragma unroll
    for (int s = 0; s < kF32Slots; ++s) {
      mbar_init(&full[s], 32);  // the 32 lanes of the producer's warp 0
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: warp 0 keeps the ring filled (kernel C: with L, delta) ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tma_prefetch_desc(&maps.x[j]);
          tma_prefetch_desc(&maps.nat_hi[j]);
          tma_prefetch_desc(&maps.nat_lo[j]);
        }
        mbar_arrive_expect_tx(x_full, 2 * L::kX);
#pragma unroll
        for (int a = 0; a < D / kF32AtomCols; ++a) {
          tma_load_4d(smem + a * L::kAtom, &maps.x[0], x_full, a * kF32AtomCols, row0, h, b);
          tma_load_4d(smem + L::kX + a * L::kAtom, &maps.x[1], x_full, a * kF32AtomCols, row0, h, b);
        }
      }
      for (int i = 0; i < n_steps * kTiles; ++i) {
        const int n = i / kTiles, u = i % kTiles, s = i % kF32Slots;
        mbar_wait(&empty[s], ((i / kF32Slots) & 1) ^ 1);  // the first round passes at once
        if (kDkv && u == 0) {
          // rows past Sq: L = 1e30, so their P is exactly 0
          float* st = stats + (n % kF32Slots) * 2 * kF32Step;
          const int q = n * kF32Step + lane;
          st[lane] = q < p.Sq ? p.lse[stat0 + q] : kRowPad;
          st[kF32Step + lane] = q < p.Sq ? p.delta[stat0 + q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], L::kSlot);
          uint8_t* slot = smem + L::kSlots + s * L::kSlot;
          // the walked input (job) of a natural tile, the read order of a transposed one
          const bool natural = kDkv ? u % 2 == 0 : u < 2;
          const int which = kDkv ? u / 2 : u % 2;
          if (natural) {
#pragma unroll
            for (int a = 0; a < D / kF32AtomCols; ++a) {
              tma_load_4d(slot + a * L::kNatAtom, &maps.nat_hi[which], &full[s], a * kF32AtomCols,
                          n * kF32Step, h, b);
              tma_load_4d(slot + L::kHalf + a * L::kNatAtom, &maps.nat_lo[which], &full[s],
                          a * kF32AtomCols, n * kF32Step, h, b);
            }
          } else {
            tma_load_4d(slot, &maps.t_hi[which], &full[s], n * kF32Step, 0, h, b);
            tma_load_4d(slot + L::kHalf, &maps.t_lo[which], &full[s], n * kF32Step, 0, h, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the CTA's tile per warpgroup ----
    setmaxnreg_inc<240>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows in the tile: r0, r0 + 8
    const int ra = row0 + r0;
    // kernel D: L and delta of this thread's two query rows
    float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if constexpr (!kDkv) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = ra + 8 * e;
        lse_r[e] = q < p.Sq ? p.lse[stat0 + q] : kRowPad;
        delta_r[e] = q < p.Sq ? p.delta[stat0 + q] : 0.f;
      }
    }
    const uint32_t x1 = smem_addr(smem), x2 = x1 + L::kX;
    const uint32_t ring = x1 + L::kSlots;

    float out0[D / 2], out1[kDkv ? D / 2 : 1];  // C: dK, dV; D: dQ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) out0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kDkv ? D / 2 : 1); ++i) out1[i] = 0.f;

    mbar_wait(x_full, 0);
    int i = 0;  // tiles of the ring read so far
    for (int n = 0; n < n_steps; ++n) {
      // S^T = K Q^T (C) or S = Q K^T (D)
      float sc[kF32Step / 2], dp[kF32Step / 2];
      mbar_wait(&full[i % kF32Slots], (i / kF32Slots) & 1);
      product_over_d<D, kFragKs, kFragBufs>(sc, x1, r0, t, ring + (i % kF32Slots) * L::kSlot);
      if (lane == 0) mbar_arrive(&empty[i % kF32Slots]);  // this warp is done with the tile
      ++i;

      // P = exp(scale S - L): sc[4j + e] is walked row 8j + 2t + (e & 1) of
      // the thread's row r0 (e < 2) or r0 + 8
      const float* lse_s = stats + (n % kF32Slots) * 2 * kF32Step;
      const int col0 = n * kF32Step;
#pragma unroll
      for (int j = 0; j < kF32Step / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          if constexpr (kDkv) {
            sc[4 * j + e] = __expf(sc[4 * j + e] * p.scale - lse_s[col]);
          } else {  // keys >= Sk are exactly 0
            sc[4 * j + e] = col0 + col < p.Sk ? __expf(sc[4 * j + e] * p.scale - lse_r[e >> 1]) : 0.f;
          }
        }
      }
      uint32_t fh[4][4], fl[4][4];
      split_frags(sc, fh, fl);
      if constexpr (kDkv) {
        // dV += P^T dO
        mbar_wait(&full[i % kF32Slots], (i / kF32Slots) & 1);
        product_over_step<D, kOutN>(out1, fh, fl, ring + (i % kF32Slots) * L::kSlot);
        fence_frags(fh);
        fence_frags(fl);
        if (lane == 0) mbar_arrive(&empty[i % kF32Slots]);
        ++i;
      }
      // dP^T = V dO^T (C) or dP = dO V^T (D)
      mbar_wait(&full[i % kF32Slots], (i / kF32Slots) & 1);
      product_over_d<D, kFragKs, kFragBufs>(dp, x2, r0, t, ring + (i % kF32Slots) * L::kSlot);
      if (lane == 0) mbar_arrive(&empty[i % kF32Slots]);
      ++i;
      // dS = P (dP - delta) scale, P = hi + lo exactly, split in place
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = frag_elem(r);
          const float pv = __uint_as_float(fh[kk][r]) + __uint_as_float(fl[kk][r]);
          const float dl = kDkv ? lse_s[kF32Step + 8 * kk + 2 * t + (e & 1)] : delta_r[e >> 1];
          tf32_split(pv * (dp[4 * kk + e] - dl) * p.scale, fh[kk][r], fl[kk][r]);
        }
      }
      // dK += dS^T Q (C) or dQ += dS K (D)
      mbar_wait(&full[i % kF32Slots], (i / kF32Slots) & 1);
      product_over_step<D, kOutN>(out0, fh, fl, ring + (i % kF32Slots) * L::kSlot);
      fence_frags(fh);
      fence_frags(fl);
      if (lane == 0) mbar_arrive(&empty[i % kF32Slots]);
      ++i;
    }

    if constexpr (kDkv) {
      store_acc_f32<D>(head_ptr_out<float>(p.dk, p.dk_sb, p.dk_sh, b, h), p.dk_ss, ra, p.Sk, out0, t);
      store_acc_f32<D>(head_ptr_out<float>(p.dv, p.dv_sb, p.dv_sh, b, h), p.dv_ss, ra, p.Sk, out1, t);
    } else {
      store_acc_f32<D>(head_ptr_out<float>(p.dq, p.dq_sb, p.dq_sh, b, h), p.dq_ss, ra, p.Sq, out0, t);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Kernel C (dkv) or D on bf16 inputs: the four tensor maps (boxes of the
// kernel's query and key tile rows), then the launch.
template <typename Kernel>
int launch_bf16(Kernel kernel, int D, int smem, bool dkv, const Params& p, cudaStream_t stream) {
  const int q_rows = dkv ? kDkvBlockM : kDqBlockM;
  const int k_rows = dkv ? kDkvBlockN : kDqBlockN;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tensor_map(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, q_rows);
  if (err == 0)
    err = make_tensor_map(&tdo, p.dout, D, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb, q_rows);
  if (err == 0) err = make_tensor_map(&tk, p.k, D, p.Sk, p.H, p.B, p.k_ss, p.k_sh, p.k_sb, k_rows);
  if (err == 0) err = make_tensor_map(&tv, p.v, D, p.Sk, p.H, p.B, p.v_ss, p.v_sh, p.v_sb, k_rows);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int rows = dkv ? p.Sk : p.Sq, tile = dkv ? kDkvBlockN : kDqBlockM;
  dim3 grid((rows + tile - 1) / tile, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// The split pre-pass, then kernel C (kDkv) or D on the caller's workspace
// `ws` (split_args' layout).
template <int D, bool kDkv>
int launch_f32(const Params& p, float* ws, cudaStream_t stream) {
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long sq[3] = {p.q_sb, p.q_sh, p.q_ss}, sdo[3] = {p.do_sb, p.do_sh, p.do_ss};
  const long long sk[3] = {p.k_sb, p.k_sh, p.k_ss}, sv[3] = {p.v_sb, p.v_sh, p.v_ss};
  const int S = kDkv ? p.Sq : p.Sk, rows = kDkv ? p.Sk : p.Sq;
  const SplitArgs a = kDkv ? split_args(p.q, sq, p.dout, sdo, ws, p.B, p.H, S, D, 2)
                           : split_args(p.k, sk, p.v, sv, ws, p.B, p.H, S, D, 1);
  int err = launch_split<D>(a, stream);
  if (err != 0) return err;
  F32Maps m = {};
  const long long* sx0 = kDkv ? sk : sq;
  const long long* sx1 = kDkv ? sv : sdo;
  err = make_tensor_map_f32(&m.x[0], kDkv ? p.k : p.q, D, rows, p.H, p.B, sx0[2], sx0[1], sx0[0],
                            kF32Rows);
  if (err == 0)
    err = make_tensor_map_f32(&m.x[1], kDkv ? p.v : p.dout, D, rows, p.H, p.B, sx1[2], sx1[1],
                              sx1[0], kF32Rows);
  const long long ns = D, nh = (long long)S * D, nb = p.H * nh;
  const long long ts = a.Sp, th = (long long)D * a.Sp, tb = p.H * th;
  for (int j = 0; j < 2 && err == 0; ++j) {
    err = make_tensor_map_f32(&m.nat_hi[j], a.job[j].hi, D, S, p.H, p.B, ns, nh, nb, kF32Step);
    if (err == 0)
      err = make_tensor_map_f32(&m.nat_lo[j], a.job[j].lo, D, S, p.H, p.B, ns, nh, nb, kF32Step);
  }
  // the transposed tiles in the order a step reads them: C dO^T, q^T; D k^T
  for (int u = 0; u < (kDkv ? 2 : 1) && err == 0; ++u) {
    const SplitJob& j = a.job[kDkv ? 1 - u : 0];
    err = make_tensor_map_f32(&m.t_hi[u], j.th, a.Sp, D, p.H, p.B, ts, th, tb, D);
    if (err == 0) err = make_tensor_map_f32(&m.t_lo[u], j.tl, a.Sp, D, p.H, p.B, ts, th, tb, D);
  }
  if (err != 0) return err;
  constexpr int smem = F32Smem<D>::kAlloc;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_tf32x3_kernel<D, kDkv>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((rows + kF32Rows - 1) / kF32Rows, p.H, p.B);
  flash_bwd_tf32x3_kernel<D, kDkv><<<grid, kThreads, smem, stream>>>(m, p);
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
// 0 = bf16, 1 = fp32. `ws`: fp32 only (null for bf16), the caller's
// workspace for the split pre-pass (split_args' layout): kernel C 4*B*H*Sq*D
// + 4*B*H*D*Sqp floats, kernel D 4*B*H*Sk*D + 2*B*H*D*Skp, Sqp and Skp
// rounded up to a multiple of 8. Each returns 0 on success, else the
// cudaError_t of its launch, or 10000 when no tensor-map encoder was found,
// or 20000 + the CUresult of a refused tensor map.

// Kernel C: writes dk and dv (dq is not touched and may be null).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             float* ws, const long long* strides, int B, int H, int Sq, int Sk, int D,
                             int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, strides, B, H, Sq,
                               Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch_bf16(flash_bwd_dkv_bf16_kernel<128>, 128, DkvSmem<128>::kAlloc, true, p, s);
  if (dtype == 0 && D == 64)
    return launch_bf16(flash_bwd_dkv_bf16_kernel<64>, 64, DkvSmem<64>::kAlloc, true, p, s);
  if (dtype == 1 && D == 128)
    return launch_f32<128, true>(p, ws, s);
  if (dtype == 1 && D == 64)
    return launch_f32<64, true>(p, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D: writes dq (dk and dv are not touched and may be null).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, float* ws,
                            const long long* strides, int B, int H, int Sq, int Sk, int D,
                            int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, strides, B, H,
                               Sq, Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch_bf16(flash_bwd_dq_bf16_kernel<128>, 128, DqSmem<128>::kAlloc, false, p, s);
  if (dtype == 0 && D == 64)
    return launch_bf16(flash_bwd_dq_bf16_kernel<64>, 64, DqSmem<64>::kAlloc, false, p, s);
  if (dtype == 1 && D == 128)
    return launch_f32<128, false>(p, ws, s);
  if (dtype == 1 && D == 64)
    return launch_f32<64, false>(p, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
