// Chunked causal flash attention for prefill on Hopper (sm_90a).
//
// Replaces the TPU kernels deepseek_tpu/ops/pallas/attention.py::
// mha_prefill_attn (_mha_prefill_body, K9: the decompressed heads of the
// hybrid-MLA prefill) and ::mla_prefill_attn (_mla_prefill_body, K10: the
// absorbed prefill over the latent cache). For query t of the chunk at
// position q_pos0 + t and cache slot s holding position cache_pos0 + s:
//
//   s_ts = scale * q_t . k_s,   masked unless cache_pos0 + s <= q_pos0 + t
//   out_t = sum_s softmax(s_t)_s v_s                      (float32)
//
//   K9  (MHA): q (B,T,H,Dh) f32, k (B,S,H,Dh), v (B,S,H,Dv)
//   K10 (MQA): q = [q_c | q_rope] (B,T,H,R+P) f32, k = [ckv | krope]
//              (B,S,R+P), v = ckv (B,S,R): one cache row serves every head
//
// The TPU walks S in order inside one program and carries (m, l, acc) in
// scratch. Here a block owns 64 query rows and walks the S tiles itself
// with the online softmax; blocks run in parallel over (rows, b):
//  - K9: the rows are 64 consecutive queries of one head (grid = H x
//    ceil(T/64) x B): each head reads its own K and V;
//  - K10: the rows are 64 consecutive (t, h) pairs of the row-major
//    (T, H) order: K and V are shared by all heads, so each cache tile is
//    loaded once for 64 rows (at H = 128, 2 blocks per query position).
// A block stops at the last slot its latest query may see, so a chunk at
// the start of the window reads only the filled slots.
//
// Bound: operations. At T = 256, S = 4096, H = 128 the K10 products are
// ~290 GFLOP over ~5 MB of cache. This first version computes them with
// float32 FMAs on the CUDA cores (exact in f32; the TPU ran its dots in
// bf16): a warp owns 8 query rows; for the scores a lane owns 4 rows x 1
// slot of a 16-slot tile, for P.V a lane owns 8 rows x 4 (DV/128 times)
// output columns. Queries stay in shared memory for the whole walk, and
// each cache tile is staged once as float32 (rows padded by 4 words:
// 16-byte aligned, and 8 consecutive rows' float4 reads fall in distinct
// banks). Tensor cores (mma/wgmma) are later work (ROADMAP.md).
//
// int8 cache (kv_cache_dtype="int8", KT = int8_t in both instances): every
// stored row comes with an f32 scale (amax/127): K10's latent and rope
// parts of slot s (ckv_scale, krope_scale (B,S)), K9's key and value rows
// of (slot s, head h), read from the head-major (B,H,S) views through
// their strides (the cache keeps them (B,S,H); no copy). The TPU folds
// them into the score and probability rows; here each row is widened to
// f32 times its scale as it is staged into shared memory, so the walk is
// the float kernel's over exactly the dequantized tile (the same function
// up to f32 rounding). The operations, not the bytes, still bound it.
//
// Partials (partials=True, context-parallel prefill: one shard of the
// window per rank, its slot s at global position cache_pos0 + s): the
// block stores its rows' unnormalized accumulator and flash statistics
// instead of dividing, m (the row's running maximum of the scaled scores)
// and l = sum exp(s - m) laid out (B,T,H), the TPU kernel's partials output
// after its swapaxes. A row that sees no slot of the shard keeps acc 0,
// l 0 and m = -1e30 (the JAX _NEG_INF); a block whose latest query comes
// before the shard's first slot walks no tile and writes just that.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 query rows each
constexpr int kRows = 64;      // query rows per block
constexpr int kTS = 16;        // cache slots per tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

struct Args {
  const float* q;    // K9: q (B,T,H,DK); K10: q_c (B,T,H,DV)
  const float* qr;   // K10: q_rope (B,T,H,DK-DV); K9: unused
  const void* k;     // K9: k (B,S,H,DK); K10: ckv (B,S,DV)
  const void* v;     // K9: v (B,S,H,DV); K10: krope (B,S,DK-DV)
  float* out;        // (B,T,H,DV)
  float* m_out;      // partials: (B,T,H) row maxima, null otherwise
  float* l_out;      // partials: (B,T,H) sums of exp(s - m)
  int T, H, S, DK;
  int q_pos0, cache_pos0;
  float scale;
  // int8 caches: the f32 scales of the k and v rows (K10: ckv and krope),
  // element (b, h, s) at b * sb + h * sh + s * ss (K10: sh = 0)
  const float* ks;
  const float* vs;
  int sb, sh, ss;
};

size_t smem_bytes(int DK, int DV, bool mqa) {
  const size_t ld = DK + 4;
  size_t f = kRows * ld + kTS * ld + (mqa ? 0 : (size_t)kTS * (DV + 4)) +
             kRows * kTS + 2 * kRows;
  return f * sizeof(float);
}

template <int DV, bool MQA, typename KT>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(Args a) {
  constexpr int NJ = DV / 128;          // float4 column groups per lane
  extern __shared__ float4 smem4[];
  const int DK = a.DK, H = a.H, T = a.T, S = a.S;
  const int ld = DK + 4;
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][ld]
  float* ks = qs + kRows * ld;                   // [kTS][ld]
  float* vs = MQA ? ks : ks + kTS * ld;          // [kTS][ldv]
  const int ldv = MQA ? ld : DV + 4;
  float* ps = MQA ? ks + kTS * ld : vs + kTS * ldv;  // [kRows][kTS]
  float* al = ps + kRows * kTS;                  // [kRows] alpha, then l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  // block rows -> (t, h): K10 flattens (t, h); K9 fixes h
  int h_fix = 0, row0;
  if (MQA) {
    row0 = blockIdx.x * kRows;                   // index into T*H
  } else {
    const int ntt = (T + kRows - 1) / kRows;
    h_fix = blockIdx.x / ntt;
    row0 = (blockIdx.x % ntt) * kRows;           // first t
  }
  const int n_rows = MQA ? T * H : T;
  auto row_t = [&](int i) { return MQA ? (row0 + i) / H : row0 + i; };
  auto row_h = [&](int i) { return MQA ? (row0 + i) % H : h_fix; };
  // (b, t, h) row offset of block row i (valid rows only)
  auto row_off = [&](int i) {
    return ((size_t)b * T + row_t(i)) * H + row_h(i);
  };

  // last slot the block's latest query may see
  const int i_last = min(kRows, n_rows - row0) - 1;
  int s_end = a.q_pos0 + row_t(i_last) - a.cache_pos0 + 1;
  s_end = max(0, min(S, s_end));

  // stage the queries (rows past the end are zero)
  for (int idx = tid; idx < kRows * DK; idx += kThreads) {
    const int i = idx / DK, c = idx - i * DK;
    float val = 0.f;
    if (row0 + i < n_rows) {
      const size_t r = row_off(i);
      if (MQA)
        val = c < DV ? a.q[r * DV + c] : a.qr[r * (DK - DV) + (c - DV)];
      else
        val = a.q[r * DK + c];
    }
    qs[i * ld + c] = val;
  }

  // score lanes: slot j of the tile, rows rs + 0..3 of the warp's 8
  const int j = lane & 15;
  const int rs = warp * 8 + (lane >> 4) * 4;
  int lim[4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lim[i] = row0 + rs + i < n_rows
                 ? a.q_pos0 + row_t(rs + i) - a.cache_pos0 : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[8][NJ][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][jj][q] = 0.f;

  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  constexpr bool kQ = std::is_same<KT, int8_t>::value;   // int8 rows + scales
  const size_t sc_b = (size_t)b * a.sb + (size_t)h_fix * a.sh;
  for (int s0 = 0; s0 < s_end; s0 += kTS) {
    __syncthreads();            // previous tile consumed (and qs staged)
    // stage slots s0..s0+15 as f32; slots at or past s_end become zero
    for (int idx = tid; idx < kTS * DK; idx += kThreads) {
      const int r = idx / DK, c = idx - r * DK;
      const int s = s0 + r;
      const int sc = min(s, s_end - 1);          // clamped address
      float val;
      if (MQA)
        val = c < DV ? to_f(kp[((size_t)b * S + sc) * DV + c])
                     : to_f(vp[((size_t)b * S + sc) * (DK - DV) + (c - DV)]);
      else
        val = to_f(kp[(((size_t)b * S + sc) * H + h_fix) * DK + c]);
      if constexpr (kQ)
        val *= (MQA && c >= DV ? a.vs : a.ks)[sc_b + (size_t)sc * a.ss];
      ks[r * ld + c] = s < s_end ? val : 0.f;
    }
    if (!MQA) {
      for (int idx = tid; idx < kTS * DV; idx += kThreads) {
        const int r = idx / DV, c = idx - r * DV;
        const int s = s0 + r;
        const int sc = min(s, s_end - 1);
        float val = to_f(vp[(((size_t)b * S + sc) * H + h_fix) * DV + c]);
        if constexpr (kQ) val *= a.vs[sc_b + (size_t)sc * a.ss];
        vs[r * ldv + c] = s < s_end ? val : 0.f;
      }
    }
    __syncthreads();

    // scores of rows rs..rs+3 against slot j
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = ks + j * ld;
#pragma unroll 4
    for (int c = 0; c < DK; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (rs + i) * ld + c);
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }
    // online softmax per row over the 16 lanes of this half-warp
    const int s = s0 + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = s <= lim[i] && s < s_end;
      const float x = ok ? sc[i] * a.scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - mn);
      const float p = ok ? __expf(x - mn) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
      ps[(rs + i) * kTS + j] = p;
      if (j == 0) al[rs + i] = alpha;
    }
    __syncwarp();

    // acc[r][c] = acc * alpha[r] + sum_s p[r][s] * v[s][c], rows of this warp
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float alpha = al[warp * 8 + r];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][jj][q] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < kTS; ++t) {
      float pv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) pv[r] = ps[(warp * 8 + r) * kTS + t];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vs + t * ldv + jj * 128 + lane * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][jj][0] = fmaf(pv[r], v4.x, acc[r][jj][0]);
          acc[r][jj][1] = fmaf(pv[r], v4.y, acc[r][jj][1]);
          acc[r][jj][2] = fmaf(pv[r], v4.z, acc[r][jj][2]);
          acc[r][jj][3] = fmaf(pv[r], v4.w, acc[r][jj][3]);
        }
      }
    }
    __syncwarp();               // ps and al are rewritten by the next tile
  }

  // normalize: the score lanes hold l; hand it to the P.V lanes. For
  // partials the same lanes store m and l, and acc is not divided.
  const bool partials = a.m_out != nullptr;
  if (j == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      al[rs + i] = l[i];
      if (partials && row0 + rs + i < n_rows) {
        a.m_out[row_off(rs + i)] = m[i];
        a.l_out[row_off(rs + i)] = l[i];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = warp * 8 + r;
    if (row0 + i >= n_rows) continue;
    // fully masked rows have l == 0 and acc == 0
    const float inv = partials ? 1.f : 1.f / fmaxf(al[i], 1e-30f);
    float* o = a.out + row_off(i) * DV;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float4 v4;
      v4.x = acc[r][jj][0] * inv;
      v4.y = acc[r][jj][1] * inv;
      v4.z = acc[r][jj][2] * inv;
      v4.w = acc[r][jj][3] * inv;
      *reinterpret_cast<float4*>(o + jj * 128 + lane * 4) = v4;
    }
  }
}

template <int DV, bool MQA, typename KT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_attn_kernel<DV, MQA, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  const size_t smem = smem_bytes(a.DK, DV, MQA);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int nx = MQA ? (a.T * a.H + kRows - 1) / kRows
                     : a.H * ((a.T + kRows - 1) / kRows);
  dim3 grid(nx, B);
  prefill_attn_kernel<DV, MQA, KT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool MQA, typename KT>
cudaError_t by_dv(const Args& a, int DV, int B, cudaStream_t stream) {
  switch (DV) {
    case 128: return launch<128, MQA, KT>(a, B, stream);
    case 512: return launch<512, MQA, KT>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MQA>
int by_dtype(const Args& a, int DV, int B, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return (int)by_dv<MQA, float>(a, DV, B, stream);
    case 1: return (int)by_dv<MQA, __half>(a, DV, B, stream);
    case 2: return (int)by_dv<MQA, __nv_bfloat16>(a, DV, B, stream);
    case 3:
      if (a.ks == nullptr || a.vs == nullptr || a.sb < 0 || a.sh < 0 || a.ss < 0)
        return (int)cudaErrorInvalidValue;
      return (int)by_dv<MQA, int8_t>(a, DV, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_dims(int B, int T, int H, int S, int DK, int DV) {
  return B <= 0 || B > 65535 || T <= 0 || H <= 0 || S <= 0 || DK <= 0 ||
         DK % 4 != 0 || (DV != 128 && DV != 512);
}

}  // namespace

// K9: q (B,T,H,DK) f32, k (B,S,H,DK) and v (B,S,H,DV) of dtype 0 = f32,
// 1 = f16, 2 = bf16, 3 = int8 -> out (B,T,H,DV) f32. For int8, k_scale and
// v_scale are (B,H,S) f32 views with element strides (sb, sh, ss); ignored
// otherwise. DK % 4 == 0, DV in {128, 512}. With m_out and l_out (B,T,H)
// f32 (partials; both null otherwise) out is the unnormalized accumulator.
// Returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int mha_prefill(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           void* out, void* m_out, void* l_out, int B, int T,
                           int H, int S, int DK, int DV, int dtype, int q_pos0,
                           int cache_pos0, float scale, int sb, int sh, int ss,
                           void* stream) {
  if (bad_dims(B, T, H, S, DK, DV) || (m_out == nullptr) != (l_out == nullptr) ||
      (long long)H * ((T + kRows - 1) / kRows) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), nullptr, k, v, static_cast<float*>(out),
         static_cast<float*>(m_out), static_cast<float*>(l_out),
         T, H, S, DK, q_pos0, cache_pos0, scale,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         sb, sh, ss};
  return by_dtype<false>(a, DV, B, dtype, static_cast<cudaStream_t>(stream));
}

// K10: q_c (B,T,H,R) and q_rope (B,T,H,P) f32, ckv (B,S,R) and krope
// (B,S,P) of dtype 0/1/2/3 (3 = int8, then ckv_scale and krope_scale (B,S)
// f32, contiguous) -> out (B,T,H,R) f32. R in {128, 512},
// (R + P) % 4 == 0. With m_out and l_out (B,T,H) f32 (partials; both null
// otherwise) out is the unnormalized accumulator.
// Returns a cudaError_t; asynchronous on `stream`.
extern "C" int mla_prefill(const void* q_c, const void* q_rope,
                           const void* ckv, const void* krope,
                           const void* ckv_scale, const void* krope_scale,
                           void* out, void* m_out, void* l_out, int B, int T,
                           int H, int S, int R, int P, int dtype, int q_pos0,
                           int cache_pos0, float scale, void* stream) {
  if (bad_dims(B, T, H, S, R + P, R) || P < 0 ||
      (m_out == nullptr) != (l_out == nullptr) ||
      (long long)T * H > 2147483647LL - kRows)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q_c), static_cast<const float*>(q_rope),
         ckv, krope, static_cast<float*>(out), static_cast<float*>(m_out),
         static_cast<float*>(l_out), T, H, S, R + P, q_pos0,
         cache_pos0, scale, static_cast<const float*>(ckv_scale),
         static_cast<const float*>(krope_scale), S, 0, 1};
  return by_dtype<true>(a, R, B, dtype, static_cast<cudaStream_t>(stream));
}
