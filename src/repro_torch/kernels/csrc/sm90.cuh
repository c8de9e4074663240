// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu),
// written from the PTX ISA:
//
//   * TMA: a 3-D tensor map of a bf16 [outer, rows, cols] tensor, encoded on
//     the host through the driver's cuTensorMapEncodeTiled (reached with
//     cudaGetDriverEntryPoint, so no -lcuda), and the load of one
//     [1, box_rows, 64] box into shared memory with 128-byte swizzle,
//     completing on an mbarrier.  Rows past `rows` read as zeros: a box at
//     the end of one head never reads the next head's rows.  And a 1-D map
//     of a float32 vector with its load, zeros past the end.
//   * mbarrier: init, arrive, arrive.expect_tx and a parity wait.
//   * setmaxnreg, to move registers from a producer warpgroup to consumers.
//   * wgmma: shared-memory matrix descriptors for the 128-byte swizzle, and
//     mma_async m64nNk16 bf16 -> f32 in two forms: SS (A and B from shared
//     memory; N = 16, 32, 64, 128) and RS (A from registers; N = 64, 96,
//     128, 192), with
//     B's transpose bit for MN-major operands; fence / commit_group /
//     wait_group, and register fences that keep the compiler from touching
//     an accumulator or an A fragment while a product is in flight.
//   * The conversion of a float32 accumulator fragment into bf16 A
//     fragments: the m64nN accumulator layout (thread t of the warpgroup
//     holds rows 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4)
//     + {0, 1}, at index 4 j + 2 {0, 1} + {0, 1}) is the RS A layout of
//     m64k16, two values a 32-bit register, so the accumulator of keys
//     16 kk .. 16 kk + 15 becomes the A operand of k-step kk in registers.
//
// Shared-memory tiles.  A tile of R rows of 64 bf16 (128 bytes) is one TMA
// box with 128-byte swizzle: 16-byte chunk c of row r sits at chunk
// c ^ (r % 8), in 1024-byte atoms of 8 rows, so every tile starts on a
// 1024-byte boundary.  A tile of 128 columns is two such tiles ("column
// blocks") one after the other, and a tile of 96 or 192 columns two or
// three: the map's columns end at 96 or 192, so TMA writes zeros into
// columns 96-127 of a 96-column tile's second block (a box always moves
// its whole 128-byte rows, and the mbarrier counts them).  A K-major
// product over 96 columns takes 6 k-steps and never reads the zero half;
// an MN-major product of N = 96 reads half of the second block.  Read
// K-major (the contraction runs along the 64 columns), a descriptor covers
// 8-row groups 1024 bytes apart (SBO) and k-step kk starts 32 kk bytes into
// the column block; read MN-major
// (the contraction runs along the rows, B's transpose bit set), 8-row
// groups along K are 1024 bytes apart (SBO), column blocks along N are
// one tile apart (LBO), and k-step kk starts 16 kk rows (2048 kk bytes) in.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---- host: tensor maps ------------------------------------------------------

// Error codes beyond cudaError_t's, returned by the C entry points.
constexpr int kErrNoEncoder = 10001;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10002;      // cuTensorMapEncodeTiled refused

inline const char* error_string(int code) {
  if (code == kErrNoEncoder)
    return "the driver offers no cuTensorMapEncodeTiled";
  if (code == kErrEncode)
    return "cuTensorMapEncodeTiled refused the tensor map (base pointer "
           "not 16-byte aligned, or a row stride not a multiple of 16 "
           "bytes)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a contiguous bf16 [outer, rows, cols] tensor, box [1, box_rows, 64],
// 128-byte swizzle, zeros past every edge.  Returns 0 or a kErr* code.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, int outer,
                          int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Map of a contiguous float32 vector of n elements, box [box] (box * 4 a
// multiple of 16), no swizzle, zeros past the end.  Returns 0 or a kErr*
// code.
inline int encode_f32_1d(CUtensorMap* map, const void* base, long long n,
                         int box) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // rank 1: no stride is read
  const cuuint32_t boxd[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, boxd, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

// 64-column blocks of a shared tile of `cols` columns (96 -> 2, the second
// half zeros; 192 -> 3).
__host__ __device__ constexpr int col_blocks(int cols) {
  return (cols + 63) / 64;
}

// ---- device: shared memory, mbarriers, TMA ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (swizzled tiles start there).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive once and expect `bytes` more of transactions (TMA) in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed.  (A watchdog that
// traps after a bound on clock64() made ptxas spill in the dK/dV kernel and
// slowed it, so the wait is bare.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// One [1, box_rows, 64] box of `map` at element coordinates (c0 along the
// columns, c1 along the rows, c2 along the outer dimension) into dst.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One [box] run of a 1-D map at element c0 into dst: c0 times the element
// size 16-byte aligned (else an illegal instruction), dst 128-byte aligned
// (else a misaligned address), as for every TMA load.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// ---- device: register budgets ------------------------------------------

// setmaxnreg: a warpgroup gives up (dec) or claims (inc) registers, so a
// producer warpgroup that only issues TMA leaves its share to the
// consumers.  All four warps of the warpgroup execute it.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- device: wgmma ----------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand starting at `p` (see the
// header for LBO and SBO).
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // layout type: 128-byte swizzle
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
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Register fences: after wgmma_wait, every read of an accumulator (and
// every reuse of an A fragment's registers) is ordered after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] = A . B (+ d when `accumulate`), A [64 x 16] and B [16 x N]
// bf16 in shared memory; B is K-major (kTransB = 0) or MN-major (1).
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, %11;\n}\n"
        : SM90_D8(0)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : SM90_D8(0), SM90_D8(8)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24),
          SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
  }
}

// d[64 x N] = A . B (+ d when `accumulate`), A [64 x 16] bf16 in registers
// (a[0..3]: the m64k16 A fragment), B [16 x N] bf16 in shared memory.
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192,
                "N is 64, 96, 128 or 192");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
          SM90_D8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24),
          SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
          SM90_D8(40), SM90_D8(48), SM90_D8(56), SM90_D8(64), SM90_D8(72),
          SM90_D8(80), SM90_D8(88)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  }
}

#undef SM90_D8

// ---- device: fragments ------------------------------------------------------

// Two floats as one register of two bf16 (x0 in the low half: the lower k).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-step kk from a float32 accumulator fragment: the
// values of columns 16 kk .. 16 kk + 15, rounded to bf16 once.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&acc)[R], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// The same, split into two bf16 parts that sum to the value within float32's
// rounding of the second: hi = bf16(x), lo = bf16(x - hi).  Two products
// with hi and lo into one float32 accumulator carry ~16 bits of x.
template <int R>
__device__ __forceinline__ void acc_to_a_split(const float (&acc)[R], int kk,
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = acc[8 * kk + 2 * r], x1 = acc[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

}  // namespace sm90
