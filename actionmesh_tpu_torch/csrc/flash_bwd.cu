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
// fp32 design: plain FMA (no TF32). 128 threads, 32 rows of the block's tile;
// each thread computes a 2x4 micro-tile of S and dP, the tile of P / dS goes
// through shared memory, then each thread accumulates 2 rows x D/8 columns of
// its gradients.
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
// fp32 path: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Rows = 32;  // rows a block owns, and rows per step of its loop

template <int D>
constexpr int f32_smem_bytes() {
  // four [32][D+1] tiles, two [32][33] tiles of P / dS, two stat rows
  return (4 * kF32Rows * (D + 1) + 2 * kF32Rows * (kF32Rows + 1) + 2 * kF32Rows) * 4;
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ss,
                                              int row0, int limit) {
  for (int i = threadIdx.x; i < kF32Rows * D; i += kF32Threads) {
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
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(const Params p) {
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
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Params p) {
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

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, int smem, int rows_total, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows_total + kF32Rows - 1) / kF32Rows, p.H, p.B);
  kernel<<<grid, kF32Threads, smem, stream>>>(p);
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
// 0 = bf16, 1 = fp32. Each returns 0 on success, else the cudaError_t of its
// launch, or (bf16) 10000 when no tensor-map encoder was found, or 20000 +
// the CUresult of a refused tensor map.

// Kernel C: writes dk and dv (dq is not touched and may be null).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Sq, int Sk, int D,
                             int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, strides, B, H, Sq,
                               Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch_bf16(flash_bwd_dkv_bf16_kernel<128>, 128, DkvSmem<128>::kAlloc, true, p, s);
  if (dtype == 0 && D == 64)
    return launch_bf16(flash_bwd_dkv_bf16_kernel<64>, 64, DkvSmem<64>::kAlloc, true, p, s);
  if (dtype == 1 && D == 128)
    return launch_f32(flash_bwd_dkv_f32_kernel<128>, f32_smem_bytes<128>(), Sk, p, s);
  if (dtype == 1 && D == 64)
    return launch_f32(flash_bwd_dkv_f32_kernel<64>, f32_smem_bytes<64>(), Sk, p, s);
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
    return launch_bf16(flash_bwd_dq_bf16_kernel<128>, 128, DqSmem<128>::kAlloc, false, p, s);
  if (dtype == 0 && D == 64)
    return launch_bf16(flash_bwd_dq_bf16_kernel<64>, 64, DqSmem<64>::kAlloc, false, p, s);
  if (dtype == 1 && D == 128)
    return launch_f32(flash_bwd_dq_f32_kernel<128>, f32_smem_bytes<128>(), Sq, p, s);
  if (dtype == 1 && D == 64)
    return launch_f32(flash_bwd_dq_f32_kernel<64>, f32_smem_bytes<64>(), Sq, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
