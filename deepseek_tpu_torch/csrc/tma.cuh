// Asynchronous copies into shared memory on Hopper, shared by the port's
// kernels: mbarriers that count a copy's bytes, TMA tile loads through a
// tensor map (cp.async.bulk.tensor), 1-D bulk copies of a contiguous run
// (cp.async.bulk: no tensor map), and the host-side encoding of 2-D
// tensor maps through the runtime's driver entry point (no libcuda link).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one box of `map` at (c0 columns, c1 rows) into shared memory at dst,
// completing `bar`'s transaction count
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned) in one bulk copy, completing `bar`'s transaction count
__device__ __forceinline__ void bulk_1d(uint32_t dst, const void* src,
                                       uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime (this library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map of `rows` rows of `cols` KT elements `stride_b` bytes apart,
// boxes of box_cols x box_rows: 128-byte swizzled column blocks (a box
// row of at most 128 bytes; by default for bf16: the operand tiles) or
// raw column blocks (plain). kMapped; kNoMap where TMA cannot
// take the tensor (a base, row stride or box width off 16 bytes), whose
// tiles then come by cp.async; kMapFailed where the driver's encoder is
// missing or refuses a map TMA can take (the launch then fails: no slower
// route stands in for it)
enum MapResult { kMapped, kNoMap, kMapFailed };
template <typename KT>
inline MapResult map_2d(CUtensorMap* m, const void* base, long long cols,
                        long long rows, long long stride_b, int box_cols,
                        int box_rows,
                        bool swizzle = std::is_same<KT, __nv_bfloat16>::value) {
  constexpr bool bf16 = std::is_same<KT, __nv_bfloat16>::value;
  constexpr CUtensorMapDataType dt =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : std::is_same<KT, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
      : std::is_same<KT, float>::value  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if ((reinterpret_cast<unsigned long long>(base) & 15) || (stride_b & 15) ||
      (box_cols * (int)sizeof(KT)) % 16 || box_cols > 256 || cols < box_cols ||
      (swizzle && box_cols * (int)sizeof(KT) > 128) ||
      rows < box_rows || rows >= (1LL << 31))
    return kNoMap;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kMapFailed;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_b};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r =
      enc(m, dt, 2, const_cast<void*>(base), dims, strides, box, es,
          CU_TENSOR_MAP_INTERLEAVE_NONE,
          swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? kMapped : kMapFailed;
}

