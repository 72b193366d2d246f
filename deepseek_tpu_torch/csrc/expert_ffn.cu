// Fused expert FFN of one decode token (kernel K7) for Hopper (sm_90a).
//
// Replaces the TPU kernel deepseek_tpu/ops/pallas/qmm.py::qmm_expert_ffn
// (qmm.py:771, pallas_call :930). For one token x (n) and N (expert,
// weight) pairs, in pair order,
//
//   y = sum_p wts[p] * ( glu(x . w1_e(p), x . w3_e(p)) . w2_e(p) )
//
// w13 (E, 2m, n) is a nibble table whose rows are stored stride-16
// permuted in two halves (KNibbleTensor.rowperm = 2: stored row o*(m/16) + g
// of a half is its natural row 16g + o), so the w13 products leave h in the
// permuted activation order that the w2 product reads; w2 (E, d, m) is a
// nibble table with natural rows. The nibble arithmetic is csrc/qmm.cu's
// (K1/K2): see its header for the plane layout, the 0.5 + u/256 byte-permute
// floats and the output-side offset against the per-16 group sums s16.
//
// Bound: bytes. The N experts' planes are read once (DeepSeek-V3, 8 routed
// + 1 shared expert: 9 x (18.35 + 9.18) MB) at 4 flops a weight byte, far
// below the card's balance point. What the one launch saves against the
// three-launch chain (K2 on w13, the GLU, K2 on w2, a weighted sum) is the
// launches, h's round trip through device memory and the combine.
//
// Design: one cooperative launch of a persistent grid (its size from the
// occupancy query, cached per device), 256 threads a block, subgroups of
// kLpr lanes sharing kRows weight rows as in csrc/qmm.cu; a subgroup keeps
// the next quad's planes in flight while it computes this one.
//  - Phase 1: every block stages x in the permuted order with its natural
//    group sums. A subgroup takes items (pair p, j): the stored rows 2j and
//    2j + 1 of the w1 half and m + 2j, m + 2j + 1 of the w3 half of expert
//    e(p), computed together as 4 rows; the lane holding the sums writes
//    g[p][2j + i] = glu(h1, h3) * wts[p] (f32, the routing weight folded in)
//    to the (N, m) scratch the wrapper allocates.
//  - grid.sync(): every g row is written and visible.
//  - Phase 2: a block stages the g rows of up to `chunk` pairs (all N at
//    DeepSeek-V3's m: 9 x 8.5 KB) in shared memory, with each natural
//    group's sum over its permuted positions o*(m/16) + g. A subgroup takes
//    kRows w2 rows and sweeps them over the chunk's pairs in order, its
//    loads running ahead across the pairs, then reduces its lanes' sums and
//    stores each row once per chunk (adding to the previous chunk's, which
//    the same lane wrote). No atomics: the result is deterministic.
// The accumulation is float32 throughout; the GLU is the f32 SILU or tanh
// GELU of ops/activations.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "knib.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kLpr = 16;       // lanes sharing a row: 2 subgroups a warp
constexpr int kSub = 32 / kLpr;
constexpr int kRows = 4;       // weight rows per subgroup item
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float glu(float gate, float up, int act) {
  float a;
  if (act == 0) {
    a = gate / (1.f + expf(-gate));                       // SILU
  } else {                                                 // tanh GELU
    a = 0.5f * gate *
        (1.f + tanhf(0.797885f * (gate + 0.044715f * gate * gate * gate)));
  }
  return a * up;
}

struct Table {
  const uint8_t* p;    // (E, rows, n/2) u8
  const uint16_t* a;   // (E, rows, n/16) bf16
  const uint16_t* c;   // (E, rows, n/16) bf16, or null
  int rows;
  float off;
};

struct Params {
  const float* x;        // (n,) natural order
  Table w13, w2;
  const int32_t* idx;    // (N,) expert ids
  const float* wts;      // (N,) routing weights
  float* g;              // (N, m) scratch: glu(h) * wts, permuted order
  float* y;              // (d,)
  int N, n, mh, d, act, chunk;
};

// Accumulate into acc (this lane's partial sums) the nibble products of
// rows rows[] of each pair's expert against its staged activations: pair
// i's expert eids[i], activations xs + i*xs_step in the permuted order
// (width n) and natural group sums s16 + i*s_step. The lane takes quads
// sl, sl + kLpr, ... of every pair, the next quad's planes loaded before
// this one's arithmetic, also across pairs.
template <bool HAS_C>
__device__ __forceinline__ void sweep(const Table& t, const int32_t* eids, int np,
                                      const int (&rows)[kRows], const float* xs,
                                      int xs_step, const float* s16, int s_step,
                                      int n, int sl, float (&acc)[kRows]) {
  const int n16 = n >> 4, nq = n16 >> 2;
  if (sl >= nq) return;
  const size_t half = (size_t)(n >> 1);
  const float c0 = 128.f + t.off;

  auto load = [&](int i, int q, uint32_t (&w)[kRows][8], uint2 (&av)[kRows],
                  uint2 (&cv)[kRows]) {
    const size_t e = (size_t)__ldg(eids + i);
    const uint8_t* pe = t.p + e * (size_t)t.rows * half;
    const uint16_t* ae = t.a + e * (size_t)t.rows * n16;
    const int g0 = q << 2;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const uint8_t* pr = pe + (size_t)rows[rr] * half + g0;
#pragma unroll
      for (int o = 0; o < 8; ++o)
        w[rr][o] = __ldg(reinterpret_cast<const uint32_t*>(pr + (size_t)o * n16));
      av[rr] = __ldg(reinterpret_cast<const uint2*>(ae + (size_t)rows[rr] * n16 + g0));
      if (HAS_C)
        cv[rr] = __ldg(reinterpret_cast<const uint2*>(
            t.c + e * (size_t)t.rows * n16 + (size_t)rows[rr] * n16 + g0));
    }
  };

  uint32_t w[kRows][8];
  uint2 av[kRows], cv[kRows];
  int i = 0, q = sl;
  load(i, q, w, av, cv);
  while (i < np) {
    int in = i, qn = q + kLpr;
    if (qn >= nq) {
      qn = sl;
      ++in;
    }
    uint32_t wn[kRows][8];
    uint2 avn[kRows], cvn[kRows];
    if (in < np) load(in, qn, wn, avn, cvn);
    knib_quad<kRows, HAS_C>(w, av, cv, xs + (size_t)i * xs_step,
                            s16 + (size_t)i * s_step, n16, q << 2, c0, acc);
    if (in < np) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int o = 0; o < 8; ++o) w[rr][o] = wn[rr][o];
        av[rr] = avn[rr];
        cv[rr] = cvn[rr];
      }
    }
    i = in;
    q = qn;
  }
}

__device__ __forceinline__ void reduce_lanes(float (&acc)[kRows]) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int m = kLpr / 2; m > 0; m >>= 1)
      acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], m);
  }
}

template <bool HAS_C>
__global__ void __launch_bounds__(kThreads, 1) expert_ffn_kernel(Params prm) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31;
  const int sl = lane % kLpr;
  const int warp = blockIdx.x * (kThreads / 32) + (tid >> 5);
  const int n_warps = gridDim.x * (kThreads / 32);
  const int n = prm.n, mh = prm.mh, N = prm.N;

  // phase 1: x staged permuted with its natural group sums
  {
    float* xs = sm;
    float* s16 = sm + n;
    stage_permuted<kThreads>(prm.x, 0, n, xs, s16);
    __syncthreads();
    const int jh = mh >> 1;                       // row pairs per half
    const int items = N * jh;
    // whole warps take rounds of kSub items, so every lane reaches the
    // shuffles of every round
    for (int base = warp * kSub; base < items; base += n_warps * kSub) {
      const int item = base + lane / kLpr;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      const int p = item / jh, j = item - (item / jh) * jh;
      if (item < items) {
        const int rows[kRows] = {2 * j, 2 * j + 1, mh + 2 * j, mh + 2 * j + 1};
        sweep<HAS_C>(prm.w13, prm.idx + p, 1, rows, xs, 0, s16, 0, n, sl, acc);
      }
      reduce_lanes(acc);
      if (item < items && sl == 0) {
        const float wt = __ldg(prm.wts + p);
        float2 gv;
        gv.x = glu(acc[0], acc[2], prm.act) * wt;
        gv.y = glu(acc[1], acc[3], prm.act) * wt;
        *reinterpret_cast<float2*>(prm.g + (size_t)p * mh + 2 * j) = gv;
      }
    }
  }

  cg::this_grid().sync();

  // phase 2: the pairs' g rows staged by chunks, each w2 row swept over them
  const int m16 = mh >> 4;
  const int items = (prm.d + kRows - 1) / kRows;
  for (int c0 = 0; c0 < N; c0 += prm.chunk) {
    const int pc = min(prm.chunk, N - c0);
    float* gs = sm;                               // (pc, mh) permuted order
    float* ss = sm + (size_t)pc * mh;             // (pc, m16) natural sums
    __syncthreads();                              // the last chunk consumed
    const float4* g4 = reinterpret_cast<const float4*>(prm.g + (size_t)c0 * mh);
    float4* gs4 = reinterpret_cast<float4*>(gs);
    for (int k = tid; k < pc * (mh >> 2); k += kThreads) gs4[k] = __ldcg(g4 + k);
    __syncthreads();
    for (int k = tid; k < pc * m16; k += kThreads) {
      const int pp = k / m16, gg = k - pp * m16;
      const float* gp = gs + (size_t)pp * mh + gg;
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < 16; ++o) s += gp[o * m16];
      ss[k] = s;
    }
    __syncthreads();
    for (int base = warp * kSub; base < items; base += n_warps * kSub) {
      const int item = base + lane / kLpr;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      const int r0 = item * kRows;
      if (item < items) {
        int rows[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) rows[rr] = min(r0 + rr, prm.d - 1);
        sweep<HAS_C>(prm.w2, prm.idx + c0, pc, rows, gs, mh, ss, m16, mh, sl, acc);
      }
      reduce_lanes(acc);
      if (item < items && sl == 0) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int r = r0 + rr;
          if (r < prm.d) prm.y[r] = (c0 == 0 ? 0.f : prm.y[r]) + acc[rr];
        }
      }
    }
  }
}

// (device, kernel) -> (blocks a multiprocessor at kMaxSmem's opt-in for
// the given shared memory, multiprocessors); the query runs once per key
std::mutex g_mu;
std::map<std::pair<int, const void*>, std::map<size_t, int>> g_occ;
std::map<int, int> g_sms;

cudaError_t grid_size(const void* kernel, size_t smem, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  auto& per = g_occ[{dev, kernel}];
  if (per.empty()) {      // first use on this device: the shared-memory opt-in
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  auto it = per.find(smem);
  if (it == per.end()) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    it = per.emplace(smem, blocks).first;
  }
  if (g_sms.find(dev) == g_sms.end()) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev] = sms;
  }
  if (it->second < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = it->second * g_sms[dev];
  return cudaSuccess;
}

}  // namespace

// y (1, d) f32 = the fused expert FFN of x (1, n) f32 (natural order) over
// N pairs: idx (N,) int32 expert ids, wts (N,) f32. w13 planes p13 (E, 2m,
// n/2) u8, a13 and c13 (E, 2m, n/16) bf16, rows permuted in two halves;
// w2 planes p2 (E, d, m/2) u8, a2 and c2 (E, d, m/16) bf16 (c13 and c2
// both null or both set); g a (N, m) f32 scratch; act 0 = SILU, 1 = tanh
// GELU. Needs n % 256 == 0 and m % 256 == 0. Returns a cudaError_t; the
// launch is asynchronous on `stream` and does not synchronize it.
extern "C" int expert_ffn(const void* x, const void* p13, const void* a13,
                          const void* c13, int off13, const void* p2,
                          const void* a2, const void* c2, int off2,
                          const void* idx, const void* wts, void* g, void* y,
                          int N, int n, int mh, int d, int act, void* stream) {
  const size_t p1 = (size_t)(n + n / 16) * sizeof(float);
  const size_t per_pair = (size_t)(mh + mh / 16) * sizeof(float);
  if (N <= 0 || n <= 0 || mh <= 0 || d <= 0 || n % 256 != 0 || mh % 256 != 0 ||
      (act != 0 && act != 1) || (c13 == nullptr) != (c2 == nullptr) ||
      p1 > (size_t)kMaxSmem || per_pair > (size_t)kMaxSmem || x == nullptr ||
      p13 == nullptr || a13 == nullptr || p2 == nullptr || a2 == nullptr ||
      idx == nullptr || wts == nullptr || g == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chunk = (int)std::min<size_t>((size_t)N, (size_t)kMaxSmem / per_pair);
  const size_t smem = std::max(p1, (size_t)chunk * per_pair);
  Params prm;
  prm.x = static_cast<const float*>(x);
  prm.w13 = Table{static_cast<const uint8_t*>(p13), static_cast<const uint16_t*>(a13),
                  static_cast<const uint16_t*>(c13), 2 * mh, (float)off13};
  prm.w2 = Table{static_cast<const uint8_t*>(p2), static_cast<const uint16_t*>(a2),
                 static_cast<const uint16_t*>(c2), d, (float)off2};
  prm.idx = static_cast<const int32_t*>(idx);
  prm.wts = static_cast<const float*>(wts);
  prm.g = static_cast<float*>(g);
  prm.y = static_cast<float*>(y);
  prm.N = N;
  prm.n = n;
  prm.mh = mh;
  prm.d = d;
  prm.act = act;
  prm.chunk = chunk;
  const void* kernel = c13 != nullptr
                           ? reinterpret_cast<const void*>(expert_ffn_kernel<true>)
                           : reinterpret_cast<const void*>(expert_ffn_kernel<false>);
  int grid = 0;
  cudaError_t err = grid_size(kernel, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
