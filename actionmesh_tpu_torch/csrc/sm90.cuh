// sm_90a (Hopper) building blocks shared by the port's kernels: mbarriers,
// TMA tensor loads and the host-side tensor-map encoder, wgmma shared-memory
// descriptors and products (bf16, fp16, TF32), setmaxnreg, named barriers, bf16/fp16
// packing and the TF32 split of split-precision (3xTF32) products. Inline PTX only
// (no CUTLASS/CuTe), so a source that includes this header builds in
// seconds. Compile with -gencode arch=compute_90a,code=sm_90a: wgmma and
// setmaxnreg exist only for that target.
//
// Shared-memory layout the descriptors below assume (what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes): an "atom" holds R rows of 64 bf16 (or
// fp16) or 32 fp32 (128 bytes each) with the 16-byte chunks of row r XOR-ed by
// (r % 8); the atom starts at a 1024-byte aligned address. A D=128 bf16 row
// spans two atoms (columns 0-63, 64-127), an fp32 row four, placed one after
// the other.
//
// wgmma accumulator layout (m64nN, fp32), thread i of the warpgroup, warp
// w = i / 32, g = (i % 32) / 4, t = i % 4: d[4j + 0..1] = D[16w + g][8j + 2t
// + 0..1], d[4j + 2..3] = D[16w + g + 8][8j + 2t + 0..1]. The register
// A-fragment of m64nNk16 (bf16, fp16) is a0 = A[16w + g][2t..], a1 = A[16w + g +
// 8][2t..], a2 = A[16w + g][2t + 8..], a3 = A[16w + g + 8][2t + 8..], so an
// accumulator over 16 columns, packed pairwise to bf16 (or fp16), is the A
// operand of the next product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to nearest into one 32-bit pair of T (bf16 or fp16).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load the box at coordinates (c0 innermost .. c3) of a rank-4 tensor map
// into shared memory; completion is counted in bytes on `bar`. Elements
// outside the tensor are filled with zeros (and still counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tmap)) : "memory");
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time through the CUDA
// runtime's entry-point query, so that the library needs no link against it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Error codes of the tensor-map encode, beside the cudaError_t values.
constexpr int kErrNoEncoder = 10000;    // no cuTensorMapEncodeTiled was found
constexpr int kErrEncodeBase = 20000;   // + the CUresult of a refused encode

// Make the primary context of the device that holds `ptr` current on the
// calling thread (cudaSetDevice binds it at once since CUDA 12). The encode
// needs a current context, and a thread whose first CUDA work is a launch
// here (a server's request thread: PyTorch's allocator may serve its tensors
// from its cache without a runtime call) has none: the encode then fails with
// CUDA_ERROR_INVALID_CONTEXT. Returns 0 or a cudaError_t.
inline int bind_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, ptr);
  if (e == cudaSuccess) e = cudaSetDevice(attr.device);
  return static_cast<int>(e);
}

// Rank-4 tensor map (D, S, H, B) of a tensor of `type` (`elem_bytes` each)
// with element strides (ss, sh, sb), box 128 bytes of columns (64 bf16, 32
// fp32: one swizzle atom column) x `box_rows` rows, 128-byte swizzle, zero
// fill beyond the tensor. Returns 0 or an error code.
inline int make_tensor_map_typed(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                                 const void* ptr, int D, int S, int H, int B, long long ss,
                                 long long sh, long long sb, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  if (const int err = bind_device_of(ptr)) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * elem_bytes), (cuuint64_t)(sh * elem_bytes),
                                 (cuuint64_t)(sb * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

// The 16-bit map (T: __nv_bfloat16 or __half): box 64 columns x `box_rows` rows.
template <typename T = __nv_bfloat16>
inline int make_tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                           long long ss, long long sh, long long sb, int box_rows) {
  constexpr CUtensorMapDataType type = std::is_same_v<T, __half>
                                           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return make_tensor_map_typed(map, type, 2, ptr, D, S, H, B, ss, sh, sb, box_rows);
}

// The fp32 map: box 32 columns x `box_rows` rows.
inline int make_tensor_map_f32(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                               long long ss, long long sh, long long sb, int box_rows) {
  return make_tensor_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, D, S, H, B, ss, sh,
                               sb, box_rows);
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups (all 128 threads execute it)
// ---------------------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// Named barriers (id 0 is __syncthreads'); `threads` is a multiple of 32 and
// counts every thread that arrives or waits, warp by warp
// ---------------------------------------------------------------------------

// Arrive at barrier `id` and wait until `threads` threads have arrived.
__device__ __forceinline__ void named_barrier_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at barrier `id` without waiting.
__device__ __forceinline__ void named_barrier_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
//   K-major (the reduction axis contiguous, e.g. Q and K of S = Q K^T): SBO =
//   1024 bytes between 8-row groups, LBO unused; step to the next 16
//   columns inside an atom by adding 32 bytes to the start address.
//   MN-major (the output axis contiguous, e.g. V of O = P V): LBO = bytes
//   between 64-column atoms, SBO = 1024 bytes between 8-row (key) groups;
//   step to the next 16 keys by adding 16 rows * 128 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // layout type: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16-bit products: the element type T of A and B is __nv_bfloat16 or __half
// (the PTX type bf16 or f16; the accumulator is fp32 either way, and both
// run at the same rate). The operand lists are shared by the two types.
template <typename T>
constexpr bool kIsF16 = std::is_same_v<T, __half>;

#define AM_WGMMA_D32                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),     \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),     \
  "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define AM_WGMMA_D64                                                                             \
  AM_WGMMA_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),    \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),     \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),     \
  "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define AM_REGS_32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define AM_REGS_64                                                                  \
  AM_REGS_32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// D (64 x 128) (+)= A (64 x 16, shared) * B (128 x 16, shared), both K-major.
#define AM_SS_N128(ty)                                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                 \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " " AM_REGS_64 "}, "               \
  "%64, %65, p, 1, 1, 0, 0;\n}\n"
// D (64 x 128) (+)= A (64 x 16, registers) * B (16 x 128, shared, MN-major).
#define AM_RS_N128(ty)                                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                 \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " " AM_REGS_64 "}, "               \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
// D (64 x 64) (+)= A (64 x 16, registers) * B (16 x 64, shared, MN-major).
#define AM_RS_N64(ty)                                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                 \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " " AM_REGS_32 "}, "                \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
// D (64 x 64) (+)= A (64 x 16, shared) * B (64 x 16, shared), both K-major.
#define AM_SS_N64(ty)                                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                 \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " " AM_REGS_32 "}, "                \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<T>) {
    asm volatile(AM_SS_N128("f16") : AM_WGMMA_D64 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(AM_SS_N128("bf16") : AM_WGMMA_D64 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<T>) {
    asm volatile(AM_RS_N128("f16") : AM_WGMMA_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(AM_RS_N128("bf16") : AM_WGMMA_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<T>) {
    asm volatile(AM_RS_N64("f16") : AM_WGMMA_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(AM_RS_N64("bf16") : AM_WGMMA_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<T>) {
    asm volatile(AM_SS_N64("f16") : AM_WGMMA_D32 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(AM_SS_N64("bf16") : AM_WGMMA_D32 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

#define AM_WGMMA_D80                                                                             \
  AM_WGMMA_D64, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),    \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),     \
  "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define AM_REGS_80                                                                  \
  AM_REGS_64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
// D (64 x 160) (+)= A (64 x 16, shared) * B (160 x 16, shared), both K-major.
#define AM_SS_N160(ty)                                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"                                                 \
  "wgmma.mma_async.sync.aligned.m64n160k16.f32." ty "." ty " " AM_REGS_80 "}, "               \
  "%80, %81, p, 1, 1, 0, 0;\n}\n"

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n160k16_ss(float (&d)[80], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<T>) {
    asm volatile(AM_SS_N160("f16") : AM_WGMMA_D80 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(AM_SS_N160("bf16") : AM_WGMMA_D80 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// The products above by output width N (64, 128 or 160): D is 64 x N, N / 2
// accumulator registers a thread.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 160, "wgmma_ss: N is 64, 128 or 160");
  if constexpr (N == 160) {
    wgmma_m64n160k16_ss<T>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16_ss<T>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n64k16_ss<T>(d, desc_a, desc_b, scale_d);
  }
}

template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs<T>(d, a, desc_b, scale_d);
  } else {
    wgmma_m64n64k16_rs<T>(d, a, desc_b, scale_d);
  }
}

// ---------------------------------------------------------------------------
// Split precision (3xTF32): fp32 operands as hi + lo TF32 parts
// ---------------------------------------------------------------------------

// The split, defined on the bit pattern (ops/flash_attention.py:tf32_split
// is the same to the bit): hi = x rounded to TF32 (10 mantissa bits) to
// nearest, ties away from zero, or truncated where rounding would overflow
// to inf; lo = x - hi, exact in fp32. inf and NaN give hi = x, lo = 0.
// Kernel A's fp32 path and kernels C and D's fp32 path share it.
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  const uint32_t b = __float_as_uint(x);
  const bool special = (b & 0x7F800000u) == 0x7F800000u;
  uint32_t h = (b + 0x1000u) & 0xFFFFE000u;
  if ((h & 0x7F800000u) == 0x7F800000u) h = b & 0xFFFFE000u;
  hi = special ? x : __uint_as_float(h);
  lo = special ? 0.f : x - hi;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  tf32_split(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// The split of a finite x whose rounding cannot overflow (|x| below 2^128
// (1 - 2^-12)), in three operations: the same bits as tf32_split there. An
// inf or NaN x gives a NaN part (tf32_split's gives hi = x, lo = 0); both
// make the product's sum inf or NaN. For operands split in registers on
// every use, where tf32_split's special cases cost most of the time.
__device__ __forceinline__ void tf32_split_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Storage position p of a row inside its group of 8 in a transposed split
// workspace (kernel A's v^T, kernel C's q^T and dO^T, kernel D's k^T): row
// (p % 4) * 2 + p / 4, so that an fp32 accumulator's columns (2t, 2t+1) of
// each 8 are the TF32 A-fragment's columns (t, t+4) of the next product.
__device__ __forceinline__ int vt_key(int pos) {
  return (pos & ~7) | ((pos & 3) << 1) | ((pos >> 2) & 1);
}

// TF32 products (fp32 bit patterns in, of which the tensor core reads the
// top 19 bits: sign, exponent, 10 mantissa bits). TF32 operands are K-major
// only, 8 deep (32 bytes, as 16 bf16). The register A-fragment of m64nNk8
// is a0 = A[16w + g][t], a1 = A[16w + g + 8][t], a2 = A[16w + g][t + 4],
// a3 = A[16w + g + 8][t + 4].

// D (64 x 32, fp32) += A (64 x 8, registers) * B (32 x 8, shared, K-major).
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 8, registers) * B (64 x 8, shared, K-major).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 8, registers) * B (128 x 8, shared, K-major);
// scale_d = 0 overwrites D instead.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The TF32 products above by output width N (32, 64 or 128), accumulating.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_tf32_rs: N is 32, 64 or 128");
  if constexpr (N == 128) {
    wgmma_m64n128k8_tf32_rs(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_m64n64k8_tf32_rs(d, a, desc_b);
  } else {
    wgmma_m64n32k8_tf32_rs(d, a, desc_b);
  }
}

// Keeps register A fragments alive (in their registers) up to this point:
// an asynchronous product reads them until the wgmma_wait that covers it.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
