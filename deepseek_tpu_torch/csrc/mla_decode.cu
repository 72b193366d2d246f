// Absorbed-MLA flash decode for Hopper (sm_90a), split over the KV axis.
//
// Replaces the TPU kernel deepseek_tpu/ops/pallas/attention.py::
// mla_decode_attn (_mla_body, K3): per sequence b and head h,
//
//   s_t   = scale * (q_c[b,h] . ckv[b,t] + q_rope[b,h] . krope[b,t]),
//           t < kv_len[b] (slots at or past kv_len are masked)
//   out   = sum_t softmax(s)_t * ckv[b,t]          (B, H, R) float32
//
// The TPU walks S in order, one grid row per sequence, carrying (m, l,
// acc) in scratch. At B = 1 that would leave all but one of the card's
// 132 SMs idle, so this kernel splits S (flash-decoding): the grid is
// (head group, KV split, sequence); each block runs the online softmax
// over its slice and writes unnormalized partials (acc, m, l), and a
// second kernel merges the splits exactly:
//   out = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*).
//
// Bound: at the full 4096-slot window the work is ~1.2 GFLOP per layer
// over ~4.7 MB of bf16 cache, which is bytes-bound only on the tensor
// cores. This first version computes the products with float32 FMAs on
// the CUDA cores (simple and exact in f32), so it is bound by those
// operations, not by the cache bytes; a wgmma/mma.sync version is later
// work (ROADMAP.md). Cache tiles are staged once in shared memory as
// float32 (row stride padded by one word so the per-lane score reads hit
// distinct banks) and serve all 16 heads of the block (MQA-shaped cache).
// Slots past kv_len or S are zeroed, never read.
//
// Partials (partials=True, the sequence-parallel decode: one shard of the
// window per rank): the merge combines the splits into one unnormalized
// triple per (b, h) instead of dividing,
//   m = max_s m_s,  l = sum_s l_s e^(m_s - m),  acc = sum_s acc_s e^(m_s - m),
// the TPU kernel's partials output. A shard past the live prefix has
// kv_len 0, every split is empty (l = 0), and the merge writes acc 0, l 0,
// m = -1e30 (the JAX _NEG_INF): no exp of a difference of two -1e30s and
// no 0/0 is formed.
//
// int8 cache (kv_cache_dtype="int8"): each cache row comes with an f32
// scale, ckv_scale[b,t] for its latent part and krope_scale[b,t] for its
// rope part (amax/127). The TPU folds the scales into the score and
// probability rows; here each row is widened to f32 times its scale as it
// is staged into shared memory, so the score and P.V loops are the float
// kernel's. The same function up to f32 rounding: the staged tile is
// exactly dequant_rows of the int8 tile, and the bytes read are half the
// f16 cache's (plus 8 bytes of scales a slot).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kHG = 16;        // heads per block (warp w scores heads w, w+8)
constexpr int kTS = 32;        // cache slots per tile (one per lane)
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;
constexpr int kCols = 3;       // column strides of a staged row: R + P <= 768
constexpr int kLoadRows = 8;   // cache rows staged per batch of loads
constexpr int kMaxSplits = 64; // merge keeps one weight per split in smem

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// RJ = ceil(R / kThreads): latent columns owned per thread in the P.V step
template <int RJ, typename T>
__global__ void __launch_bounds__(kThreads)
mla_split_kernel(const float* __restrict__ qc, const float* __restrict__ qr,
                 const T* __restrict__ ckv, const T* __restrict__ kr,
                 const float* __restrict__ ckv_s, const float* __restrict__ kr_s,
                 const int32_t* __restrict__ kv_len,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int S, int R, int P,
                 int chunk, int nsplit, float scale) {
  extern __shared__ float4 smem4[];
  const int D = R + P;
  const int ks = D + 1;                       // padded tile row stride
  float* qs = reinterpret_cast<float*>(smem4);   // [kHG][D]
  float* kt = qs + kHG * D;                      // [kTS][ks]
  float* ps = kt + kTS * ks;                     // [kTS][kHG]
  float* alpha_s = ps + kTS * kHG;               // [kHG]

  const int hg = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int h_base = hg * kHG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(kv_len[b], S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t part = ((size_t)b * H + h_base) * nsplit + split;  // (b,h,split)

  if (start >= end) {          // empty slice: l = 0 tells the merge to skip
    if (tid < kHG && h_base + tid < H) {
      m_out[part + (size_t)tid * nsplit] = kNegInf;
      l_out[part + (size_t)tid * nsplit] = 0.f;
    }
    return;
  }

  // stage the block's queries: all loads of a thread issued before any
  // store, so their latencies overlap (kCols x 256 >= D is checked)
  {
    float v[kHG][kCols];
#pragma unroll
    for (int h = 0; h < kHG; ++h) {
      // clamped addresses: every load is issued unconditionally
      const size_t row = (size_t)b * H + min(h_base + h, H - 1);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int i = min(tid + k * kThreads, D - 1);
        const float* src = i < R ? qc + row * R + i : qr + row * P + (i - R);
        v[h][k] = __ldg(src);
      }
    }
#pragma unroll
    for (int h = 0; h < kHG; ++h)
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int i = tid + k * kThreads;
        if (i < D) qs[h * D + i] = v[h][k];
      }
  }

  const int h0 = warp, h1 = warp + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[RJ][kHG];
#pragma unroll
  for (int j = 0; j < RJ; ++j)
#pragma unroll
    for (int h = 0; h < kHG; ++h) acc[j][h] = 0.f;

  constexpr bool kQ = std::is_same<T, int8_t>::value;   // int8 rows + scales
  const T* ckv_b = ckv + (size_t)b * S * R;
  const T* kr_b = kr + (size_t)b * S * P;
  const float* cs_b = kQ ? ckv_s + (size_t)b * S : nullptr;
  const float* rs_b = kQ ? kr_s + (size_t)b * S : nullptr;

  for (int t0 = start; t0 < end; t0 += kTS) {
    __syncthreads();           // previous tile fully consumed (and qs ready)
    // stage the tile as f32, kLoadRows rows at a time with every load of
    // the batch in flight together; slots at or past `end` become 0
    for (int tb = 0; tb < kTS; tb += kLoadRows) {
      float v[kLoadRows][kCols];
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) {
        // clamped addresses (never past `end`, so never past S): every load
        // is issued unconditionally, the value is masked afterwards
        const int pos = min(t0 + tb + r, end - 1);
        const bool live = t0 + tb + r < end;
        float sc = 1.f, sr = 1.f;
        if constexpr (kQ) {
          sc = cs_b[pos];
          sr = rs_b[pos];
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int i = min(tid + k * kThreads, D - 1);
          const T* src = i < R ? ckv_b + (size_t)pos * R + i
                               : kr_b + (size_t)pos * P + (i - R);
          float x = to_f(*src);
          if constexpr (kQ) x *= i < R ? sc : sr;
          v[r][k] = live ? x : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r)
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int i = tid + k * kThreads;
          if (i < D) kt[(tb + r) * ks + i] = v[r][k];
        }
    }
    __syncthreads();

    // scores: lane = slot, heads h0 and h1 of this warp
    const float* krow = kt + lane * ks;
    const float* q0 = qs + h0 * D;
    const float* q1 = qs + h1 * D;
    // two partial sums per head halve the FMA dependency chain
    float s0 = 0.f, s1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll 4
    for (int i = 0; i < D; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q0 + i);
      const float4 c = *reinterpret_cast<const float4*>(q1 + i);
      const float k0 = krow[i], k1 = krow[i + 1], k2 = krow[i + 2],
                  k3 = krow[i + 3];
      s0 = fmaf(a.x, k0, s0); u0 = fmaf(a.y, k1, u0);
      s0 = fmaf(a.z, k2, s0); u0 = fmaf(a.w, k3, u0);
      s1 = fmaf(c.x, k0, s1); u1 = fmaf(c.y, k1, u1);
      s1 = fmaf(c.z, k2, s1); u1 = fmaf(c.w, k3, u1);
    }
    s0 += u0;
    s1 += u1;
    const bool valid = t0 + lane < end;
    s0 = valid ? s0 * scale : kNegInf;
    s1 = valid ? s1 * scale : kNegInf;

    const float mn0 = fmaxf(m0, warp_max(s0));
    const float mn1 = fmaxf(m1, warp_max(s1));
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    const float p0 = valid ? __expf(s0 - mn0) : 0.f;
    const float p1 = valid ? __expf(s1 - mn1) : 0.f;
    l0 = l0 * al0 + warp_sum(p0);
    l1 = l1 * al1 + warp_sum(p1);
    m0 = mn0;
    m1 = mn1;
    ps[lane * kHG + h0] = p0;
    ps[lane * kHG + h1] = p1;
    if (lane == 0) {
      alpha_s[h0] = al0;
      alpha_s[h1] = al1;
    }
    __syncthreads();

    // acc[h][c] = acc * alpha[h] + sum_t p[t][h] * ckv[t][c]
    float al[kHG];
#pragma unroll
    for (int h = 0; h < kHG; ++h) al[h] = alpha_s[h];
#pragma unroll
    for (int j = 0; j < RJ; ++j)
#pragma unroll
      for (int h = 0; h < kHG; ++h) acc[j][h] *= al[h];
    const int ntile = min(kTS, end - t0);
#pragma unroll 4
    for (int t = 0; t < ntile; ++t) {
      const float4* pt = reinterpret_cast<const float4*>(ps + t * kHG);
      float pv[kHG];
#pragma unroll
      for (int v4 = 0; v4 < kHG / 4; ++v4) {
        const float4 f = pt[v4];
        pv[4 * v4] = f.x; pv[4 * v4 + 1] = f.y;
        pv[4 * v4 + 2] = f.z; pv[4 * v4 + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int col = tid + j * kThreads;
        const float v = col < R ? kt[t * ks + col] : 0.f;
#pragma unroll
        for (int h = 0; h < kHG; ++h) acc[j][h] = fmaf(pv[h], v, acc[j][h]);
      }
    }
  }

  if (lane == 0) {
    if (h_base + h0 < H) {
      m_out[part + (size_t)h0 * nsplit] = m0;
      l_out[part + (size_t)h0 * nsplit] = l0;
    }
    if (h_base + h1 < H) {
      m_out[part + (size_t)h1 * nsplit] = m1;
      l_out[part + (size_t)h1 * nsplit] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int col = tid + j * kThreads;
    if (col >= R) continue;
#pragma unroll
    for (int h = 0; h < kHG; ++h)
      if (h_base + h < H)
        acc_out[(part + (size_t)h * nsplit) * R + col] = acc[j][h];
  }
}

// one block per (b, h): exact merge of the split partials. The non-empty
// splits and their weights e^(m_s - m*) / sum_s l_s e^(m_s - m*) go to
// shared memory first, so the column loop's loads are independent. With
// m_out (partials) the weights stay e^(m_s - m*) and the block also writes
// m* and l* = sum_s l_s e^(m_s - m*) (-1e30 and 0 when no split is live).
__global__ void mla_merge_kernel(const float* __restrict__ acc_in,
                                 const float* __restrict__ m_in,
                                 const float* __restrict__ l_in,
                                 float* __restrict__ out,
                                 float* __restrict__ m_out,
                                 float* __restrict__ l_out, int R, int nsplit) {
  __shared__ float w_s[kMaxSplits];
  __shared__ int id_s[kMaxSplits];
  __shared__ int n_live;
  const size_t bh = blockIdx.x;
  if (threadIdx.x == 0) {
    const float* m = m_in + bh * nsplit;
    const float* l = l_in + bh * nsplit;
    float mx = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
    float denom = 0.f;
    int n = 0;
    for (int s = 0; s < nsplit; ++s)
      if (l[s] > 0.f) {
        const float e = __expf(m[s] - mx);
        denom += l[s] * e;
        w_s[n] = e;
        id_s[n++] = s;
      }
    if (m_out != nullptr) {
      m_out[bh] = mx;            // kNegInf when no split is live
      l_out[bh] = denom;
    } else {
      const float inv = denom > 0.f ? 1.f / denom : 0.f;
      for (int j = 0; j < n; ++j) w_s[j] *= inv;
    }
    n_live = n;
  }
  __syncthreads();
  const int n = n_live;
  const float* acc = acc_in + bh * nsplit * R;
  for (int col = threadIdx.x; col < R; col += blockDim.x) {
    float v = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) v = fmaf(acc[(size_t)id_s[j] * R + col], w_s[j], v);
    out[bh * R + col] = v;
  }
}

template <int RJ, typename T>
cudaError_t launch(const float* qc, const float* qr, const void* ckv,
                   const void* kr, const float* cs, const float* rs,
                   const int32_t* kv_len, float* out, float* m_out,
                   float* l_out, float* acc, float* m, float* l, int B, int H,
                   int S, int R, int P, int nsplit, float scale,
                   cudaStream_t stream) {
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(
        mla_split_kernel<RJ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  const int D = R + P;
  const size_t smem =
      ((size_t)kHG * D + (size_t)kTS * (D + 1) + kTS * kHG + kHG) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int chunk = ((S + nsplit - 1) / nsplit + kTS - 1) / kTS * kTS;
  dim3 grid((H + kHG - 1) / kHG, nsplit, B);
  mla_split_kernel<RJ, T><<<grid, kThreads, smem, stream>>>(
      qc, qr, static_cast<const T*>(ckv), static_cast<const T*>(kr), cs, rs,
      kv_len, acc, m, l, H, S, R, P, chunk, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_merge_kernel<<<B * H, 128, 0, stream>>>(acc, m, l, out, m_out, l_out, R,
                                               nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* qc, const float* qr, const void* ckv,
                     const void* kr, const float* cs, const float* rs,
                     const int32_t* kv_len, float* out, float* m_out,
                     float* l_out, float* acc, float* m, float* l, int B, int H,
                     int S, int R, int P, int nsplit, float scale,
                     cudaStream_t stream) {
  if (R <= kThreads)
    return launch<1, T>(qc, qr, ckv, kr, cs, rs, kv_len, out, m_out, l_out,
                        acc, m, l, B, H, S, R, P, nsplit, scale, stream);
  return launch<2, T>(qc, qr, ckv, kr, cs, rs, kv_len, out, m_out, l_out, acc,
                      m, l, B, H, S, R, P, nsplit, scale, stream);
}

}  // namespace

// q_c (B,H,R) f32, q_rope (B,H,P) f32, ckv (B,S,R) and krope (B,S,P) of
// dtype 0 = f32, 1 = f16, 2 = bf16, 3 = int8 (then ckv_scale and
// krope_scale (B,S) f32, contiguous; ignored otherwise), kv_len (B,) int32
// -> out (B,H,R) f32. With m_out and l_out (B,H) f32 (partials; both null
// otherwise) out is the unnormalized accumulator and m_out, l_out its flash
// statistics. acc (B,H,nsplit,R), m and l (B,H,nsplit) f32 are scratch the
// caller allocates. Needs R <= 512, R + P <= 768, (R + P) % 4 == 0 and at
// most 64 splits (checked here).
// Returns a cudaError_t; both launches are asynchronous on `stream`.
extern "C" int mla_decode(const void* qc, const void* qr, const void* ckv,
                          const void* kr, const void* ckv_scale,
                          const void* krope_scale, const void* kv_len,
                          void* out, void* m_out, void* l_out, void* acc,
                          void* m, void* l, int B, int H, int S, int R, int P,
                          int dtype, int nsplit, float scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || R <= 0 || R > 2 * kThreads ||
      P < 0 || (R + P) % 4 != 0 || R + P > kCols * kThreads || nsplit <= 0 ||
      nsplit > kMaxSplits || (m_out == nullptr) != (l_out == nullptr) ||
      (dtype == 3 && (ckv_scale == nullptr || krope_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto a = static_cast<const float*>(qc);
  auto b = static_cast<const float*>(qr);
  auto cs = static_cast<const float*>(ckv_scale);
  auto rs = static_cast<const float*>(krope_scale);
  auto kl = static_cast<const int32_t*>(kv_len);
  auto o = static_cast<float*>(out);
  auto mo = static_cast<float*>(m_out);
  auto lo = static_cast<float*>(l_out);
  auto ac = static_cast<float*>(acc);
  auto mm = static_cast<float*>(m);
  auto ll = static_cast<float*>(l);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(a, b, ckv, kr, cs, rs, kl, o, mo, lo, ac, mm,
                                  ll, B, H, S, R, P, nsplit, scale, st);
    case 1:
      return (int)dispatch<__half>(a, b, ckv, kr, cs, rs, kl, o, mo, lo, ac, mm,
                                   ll, B, H, S, R, P, nsplit, scale, st);
    case 2:
      return (int)dispatch<__nv_bfloat16>(a, b, ckv, kr, cs, rs, kl, o, mo, lo,
                                          ac, mm, ll, B, H, S, R, P, nsplit,
                                          scale, st);
    case 3:
      return (int)dispatch<int8_t>(a, b, ckv, kr, cs, rs, kl, o, mo, lo, ac, mm,
                                   ll, B, H, S, R, P, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
