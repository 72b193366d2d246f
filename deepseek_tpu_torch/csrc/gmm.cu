// Grouped plain-table matrix product on Hopper's tensor cores (sm_90a).
//
// Replaces megablox.gmm as deepseek_tpu/ops/matmul.py::grouped_expert_ffn
// calls it (ops/matmul.py:308-362; K11): the rows of x (M, k) come grouped
// by expert, group e (group_off[e] .. group_off[e+1], consecutive from row
// 0) against the plain table W[e] (E, n, k), cast to x's dtype (the
// compute dtype) first:
//
//   y[row, c] = sum_j x[row, j] * cast(W[e(row)][c, j])     (f32)
//
// Rows past the last group are left unwritten. Pairs (x, W): bf16 x bf16
// (V3's bf16 tables), bf16 x f16 and bf16 x f32 (the table rounded to
// bf16, nearest-even: DeepSeek-V2-Lite's F16 tables in bf16 compute),
// f32 x bf16 and f32 x f16/f32 (f32 compute).
//
// Bound: bytes. A routed group holds ~24-36 rows (V2-Lite: 2048 rows over
// 66 groups, 256 in each shared one; V3's cut: 2304 over 64), so a table
// block meets at most a few dozen rows: ~70 flops a table byte, below the
// card's ~295 bf16 flops a byte. The design streams every table block
// from device memory once per tile and keeps the tensor cores off the
// critical path:
//  - a block owns 128 table rows (output columns) and one tile of 64
//    consecutive rows of one group (_GMM_ROWS in ops/kernels/qmm.py); the
//    grid is (column blocks, tiles), column blocks fastest, so the blocks
//    of one tile (which share its rows) and the tiles of one group (which
//    share its table) run together and meet in L2. A group of more rows
//    than a tile takes several tiles (the shared experts: 4); tiles past
//    the last group exit.
//  - the products are wgmma m64n64k16 with the TABLE rows as M (A, from
//    registers: each of the two warp groups its 64 rows) and the tile's
//    rows as N (B, from shared memory, K-major). A thin group wastes
//    columns of N, not bytes; and the table's format change happens in
//    registers on the way from shared memory to the A fragments: bf16
//    as is (ldmatrix), f16 widened and rounded to bf16 (nearest-even, as
//    `rhs.to(torch.bfloat16)`), f32 rounded likewise; never an f16 MMA,
//    which would compute another function.
//  - f32 compute keeps the f32 function through split operands, as K9/K10
//    do: x = hi + lo in bf16 (x - hi - lo within 2^-18 |x|), converted in
//    shared memory once per stage for both warp groups; an f16 or f32
//    table = hi + lo too (an f16 value is exact in two bf16 terms). Passes
//    a k16 step: bf16 x: 1 (W.x); f32 x over a bf16 table: 2 (W.x_hi +
//    W.x_lo); over f16/f32: 3 (W_hi.x_hi + W_hi.x_lo + W_lo.x_hi). The
//    products of two bf16 values are exact in the f32 accumulators.
//  - staging: a 4-stage ring of 64-column k-steps, each the block's 128 x
//    64 table tile and the tile's 64 x 64 rows, by TMA (2-D maps encoded
//    on the host, 128-byte swizzled boxes of 128 bytes a row) into an
//    mbarrier a stage; one thread refills a stage once both warp groups
//    are done with it, so three k-steps stay in flight while one is
//    multiplied (bf16: 72 KB, two blocks an SM). Rows past a group (the
//    next group's, or past the table's E*n rows and x's M rows, which TMA
//    fills with zeros) give columns of the product that are not stored.
//  - the epilogue writes y from the accumulator fragments (eight lanes a
//    32-byte run of a row of y).
// Needs k % 64 == 0 (V2-Lite's w2 has k = 1408) and 16-byte aligned bases.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;        // table rows a block: two warp groups of 64
constexpr int kBN = 64;         // rows of x a tile (_GMM_ROWS in the wrapper)
constexpr int kBK = 64;         // k columns a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

template <typename XT, typename WT>
struct Cfg {
  static constexpr bool kXSplit = std::is_same<XT, float>::value;  // x = hi + lo
  static constexpr bool kWBf16 = std::is_same<WT, __nv_bfloat16>::value;
  static constexpr bool kWSplit = kXSplit && !kWBf16;              // W = hi + lo
  static constexpr int XBOX = 128 / (int)sizeof(XT);   // columns a TMA box row
  static constexpr int WBOX = 128 / (int)sizeof(WT);
  static constexpr int XB = kBN * kBK * (int)sizeof(XT);   // x bytes a stage
  static constexpr int WB = kBM * kBK * (int)sizeof(WT);   // table bytes a stage
  static constexpr int STAGE = WB + XB;                    // 1024-aligned
  static constexpr int XT16 = kBN * kBK * 2;               // a bf16 x tile
  static constexpr int CONV = kXSplit ? 2 * XT16 : 0;      // x hi, x lo
  static constexpr int SMEM = kStages * STAGE + CONV + 1024;   // + alignment
  static_assert(SMEM <= kMaxSmem - 1024, "shared memory");
};

struct Tiles {
  const int32_t* group_off;   // (E+1,) row offsets of the groups
  const int32_t* tile_off;    // (E+1,) first tile of each group
  int rows, E;
};

// tile g -> (group, first row, live rows); false for a tile past the groups
__device__ bool tile_of(const Tiles& t, int g, int& e, int& r0, int& nr) {
  if (g >= t.tile_off[t.E]) return false;
  int lo = 0, hi = t.E - 1;                 // last e with tile_off[e] <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile_off[mid] <= g) lo = mid; else hi = mid - 1;
  }
  e = lo;
  r0 = t.group_off[e] + (g - t.tile_off[e]) * kBN;
  nr = min(min(kBN, t.group_off[e + 1] - r0), t.rows - r0);
  return nr > 0;
}

struct alignas(64) Maps {
  CUtensorMap x;   // (M rows, k) of XT, boxes of XBOX x 64 rows
  CUtensorMap w;   // (E*n rows, k) of WT, boxes of WBOX x 128 rows
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the A fragment (m16n8k16 layout) of this warp's 16 table rows from row0
// of the stage's table tile (kBM rows, 128-byte swizzled column blocks) at
// k16 step kk: bf16 hi terms, and lo terms where the table is split
template <typename WT, bool SPLIT>
__device__ __forceinline__ void load_a(uint32_t w, int row0, int kk, int lane,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  if constexpr (sizeof(WT) == 2) {
    // ldmatrix: lane i addresses row (i & 7) + 8 * ((i >> 3) & 1) and the
    // 8 columns from kk*16 + 8 * (i >> 4): the four 8x8 blocks a0..a3
    const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    uint32_t raw[4];
    ldmatrix_x4(w + tile_b(r, kBM, (kk * 16 + (lane >> 4) * 8) * 2), raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
        hi[i] = raw[i];
      } else {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&raw[i]));
        if constexpr (SPLIT) split2(f.x, f.y, hi[i], lo[i]);
        else hi[i] = bf16x2(f.x, f.y);
      }
    }
  } else {
    // f32: a_i is (row g (+8 for a1, a3), columns 2c, 2c+1 (+8 for a2, a3))
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i & 1) * 8;
      const int col = kk * 16 + 2 * c + (i >> 1) * 8;
      const float2 f = *reinterpret_cast<const float2*>(
          __cvta_shared_to_generic(w + tile_b(r, kBM, col * 4)));
      if constexpr (SPLIT) split2(f.x, f.y, hi[i], lo[i]);
      else hi[i] = bf16x2(f.x, f.y);
    }
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const __grid_constant__ Maps maps, Tiles tl, float* __restrict__ y,
           int n, int k) {
  using C = Cfg<XT, WT>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];

  int e, r0, nr;
  if (!tile_of(tl, blockIdx.y, e, r0, nr)) return;
  const int col0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;   // this warp's table rows
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t conv = base + kStages * C::STAGE;       // f32 x: hi, then lo
  const int nk = k / kBK;
  const int wrow = e * n + col0;       // the block's first row of the (E*n, k) map

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread asks for k-step ks: the table tile, then the rows of x
  auto issue = [&](int ks) {
    const int st = ks % kStages;
    const uint32_t bar = smem_addr(&full[st]);
    const uint32_t sw = base + st * C::STAGE, sx = sw + C::WB;
    mbar_expect(bar, C::STAGE);
#pragma unroll
    for (int j = 0; j < kBK / C::WBOX; ++j)
      tma_2d(sw + j * kBM * 128, &maps.w, ks * kBK + j * C::WBOX, wrow, bar);
#pragma unroll
    for (int j = 0; j < kBK / C::XBOX; ++j)
      tma_2d(sx + j * kBN * 128, &maps.x, ks * kBK + j * C::XBOX, r0, bar);
  };
  if (tid == 0)
    for (int s = 0; s < min(kStages, nk); ++s) issue(s);

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int ks = 0; ks < nk; ++ks) {
    const int st = ks % kStages;
    mbar_wait(smem_addr(&full[st]), (ks / kStages) & 1);
    const uint32_t sw = base + st * C::STAGE, sx = sw + C::WB;
    uint32_t xh = sx;
    if constexpr (C::kXSplit) {
      // the stage's f32 rows -> bf16 hi and lo tiles (K-major, swizzled):
      // 4 values a thread an item, both warp groups' work shared
#pragma unroll
      for (int it = 0; it < kBN * kBK / 4 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i >> 4, c4 = i & 15;
        const float4 v = *reinterpret_cast<const float4*>(
            __cvta_shared_to_generic(sx + tile_b(r, kBN, c4 * 16)));
        uint32_t h0, l0, h1, l1;
        split2(v.x, v.y, h0, l0);
        split2(v.z, v.w, h1, l1);
        const uint32_t o = tile_b(r, kBN, c4 * 8);
        *reinterpret_cast<uint2*>(__cvta_shared_to_generic(conv + o)) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(__cvta_shared_to_generic(conv + C::XT16 + o)) =
            make_uint2(l0, l1);
      }
      proxy_fence();
      __syncthreads();
      xh = conv;
    }
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a<WT, C::kWSplit>(sw, row0, kk, lane, ah[kk], al[kk]);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 32 bytes a k16 step inside the 128-byte rows of the x tile
      const uint64_t dh = desc(xh + kk * 32, 16, 1024);
      wgmma_rs_n64_k(acc, ah[kk], dh);
      if constexpr (C::kXSplit)
        wgmma_rs_n64_k(acc, ah[kk], desc(xh + C::XT16 + kk * 32, 16, 1024));
      if constexpr (C::kWSplit) wgmma_rs_n64_k(acc, al[kk], dh);
    }
    wg_commit();
    wg_wait();
    pin(acc);
    __syncthreads();                  // stage st (and the x hi/lo tiles) free
    if (tid == 0 && ks + kStages < nk) issue(ks + kStages);
  }

  // acc[t] holds table rows row0 + g (+8) x tile rows 8t + 2c (+1)
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col0 + row0 + g + 8 * h;
    if (col >= n) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 8 * t + 2 * c + j;
        if (r < nr) y[(size_t)(r0 + r) * n + col] = acc[t][2 * h + j];
      }
  }
}

template <typename T>
constexpr CUtensorMapDataType tma_dtype() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<T, __half>::value      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// a 2-D map of `rows` rows of k T values, boxes of 128 bytes x box_rows,
// 128-byte swizzled; false where the driver's encoder is missing or
// refuses it (the launch then fails: there is no other route)
template <typename T>
bool encode(CUtensorMap* m, const void* base, long long rows, int k, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, tma_dtype<T>(), 2, const_cast<void*>(base), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* w, const Tiles& tl, float* y, int G,
                   int E, int n, int k, cudaStream_t stream) {
  using C = Cfg<XT, WT>;
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_kernel<XT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode<XT>(&maps.x, x, tl.rows, k, kBN) ||
      !encode<WT>(&maps.w, w, (long long)E * n, k, kBM))
    return cudaErrorNotSupported;
  dim3 grid((n + kBM - 1) / kBM, G);
  gmm_kernel<XT, WT><<<grid, kThreads, C::SMEM, stream>>>(maps, tl, y, n, k);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch(int w_dtype, const void* x, const void* w, const Tiles& tl,
                     float* y, int G, int E, int n, int k, cudaStream_t st) {
  switch (w_dtype) {
    case 0: return launch<XT, float>(x, w, tl, y, G, E, n, k, st);
    case 1: return launch<XT, __half>(x, w, tl, y, G, E, n, k, st);
    case 2: return launch<XT, __nv_bfloat16>(x, w, tl, y, G, E, n, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (rows, n) f32 = x (rows, k) grouped against W (E, n, k): x_dtype and
// w_dtype 0 = f32, 1 = f16 (W only), 2 = bf16; group_off and tile_off
// (E+1,) int32 as the header says (tiles of 64 rows); G tiles launched
// (at least tile_off[E]). Needs k % 64 == 0, 16-byte aligned x and W,
// G <= 65535. Returns a cudaError_t (cudaErrorNotSupported where the
// driver does not encode the TMA maps); the launch is asynchronous on
// `stream`.
extern "C" int gmm(const void* x, int x_dtype, const void* w, int w_dtype,
                   const void* group_off, const void* tile_off, void* y, int rows,
                   int G, int E, int n, int k, void* stream) {
  if (rows <= 0 || G <= 0 || G > 65535 || E <= 0 || n <= 0 || k <= 0 || k % kBK ||
      (x_dtype != 0 && x_dtype != 2) || w_dtype < 0 || w_dtype > 2 ||
      x == nullptr || w == nullptr || group_off == nullptr || tile_off == nullptr ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w) & 15) ||
      (long long)E * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Tiles tl{static_cast<const int32_t*>(group_off),
                 static_cast<const int32_t*>(tile_off), rows, E};
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(x_dtype == 0 ? dispatch<float>(w_dtype, x, w, tl, ys, G, E, n, k, st)
                            : dispatch<__nv_bfloat16>(w_dtype, x, w, tl, ys, G, E, n, k, st));
}
