// Native K-quant encoder/decoder for offline checkpoint conversion: the
// port's copy of deepseek_tpu/native/kquant.cpp (the same code, so that both
// packages' converters write the same bytes).
//
// Implements the llama.cpp Q2_K / Q3_K / Q8_K super-block wire formats
// (256 weights per block; layout documented in quant/kquant.py)
// with the same fitting algorithm as the vectorized numpy encoder: a
// weighted min+scale grid search for Q2_K sub-blocks and an RMSE
// coordinate-descent refinement for Q3_K. OpenMP parallelizes over matrix
// rows (each row's blocks are independent).
//
// Fresh implementation for this project; numerics use double accumulators to
// track the numpy encoder closely. Exposed via a C ABI for ctypes.
//
// Built by native/build.py at first use (g++ -O3 -std=c++17 -shared -fPIC
// -fopenmp -march=native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlock = 256;     // weights per super-block
constexpr int kSub = 16;        // sub-blocks per super-block (of 16 weights)
constexpr int kQ2Bytes = 84;
constexpr int kQ3Bytes = 110;
constexpr int kQ8Bytes = 4 + 256 + 32;

inline int nearest(float v) { return (int)std::nearbyintf(v); }

inline uint16_t to_f16(float f) {
  // round-to-nearest-even float32 -> float16 (scalar, no F16C dependency)
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xff) - 127 + 15;
  uint32_t mant = x & 0x7fffffu;
  if (exp >= 31) return (uint16_t)(sign | 0x7c00u);            // inf/overflow
  if (exp <= 0) {                                              // subnormal
    if (exp < -10) return (uint16_t)sign;
    mant |= 0x800000u;
    int shift = 14 - exp;
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) half++;
    return (uint16_t)(sign | half);
  }
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)(sign | half);
}

inline float from_f16(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {
      int e = -1;
      do { mant <<= 1; e++; } while (!(mant & 0x400u));
      x = sign | ((uint32_t)(127 - 15 - e) << 23) | ((mant & 0x3ffu) << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7f800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

// Weighted [min, scale] grid fit for one 16-value group (Q2_K sub-blocks).
float fit_min_scale(const float* x, const float* w, int n, int nmax,
                    uint8_t* L, float* the_min) {
  float vmin = x[0], vmax = x[0];
  double sum_w = 0, sum_x = 0;
  for (int i = 0; i < n; i++) {
    vmin = std::min(vmin, x[i]);
    vmax = std::max(vmax, x[i]);
    sum_w += w[i];
    sum_x += (double)w[i] * x[i];
  }
  if (vmin > 0) vmin = 0;
  if (vmax == vmin) {
    for (int i = 0; i < n; i++) L[i] = 0;
    *the_min = -vmin;
    return 0.f;
  }
  float rng = vmax - vmin;
  float iscale = nmax / rng;
  float scale = 1.f / iscale;
  float best_min = vmin;
  double best_err = 0;
  for (int i = 0; i < n; i++) {
    int l = std::clamp(nearest(iscale * (x[i] - vmin)), 0, nmax);
    L[i] = (uint8_t)l;
    best_err += (double)w[i] * std::fabs(scale * l + vmin - x[i]);
  }
  uint8_t Laux[16];
  for (int step = 0; step <= 15; step++) {
    float cand = (-0.5f + 0.1f * step + nmax) / rng;
    double sl = 0, sl2 = 0, sxl = 0;
    for (int i = 0; i < n; i++) {
      int l = std::clamp(nearest(cand * (x[i] - vmin)), 0, nmax);
      Laux[i] = (uint8_t)l;
      sl += (double)w[i] * l;
      sl2 += (double)w[i] * l * l;
      sxl += (double)w[i] * l * x[i];
    }
    double D = sum_w * sl2 - sl * sl;
    if (D <= 0) continue;
    double ts = (sum_w * sxl - sum_x * sl) / D;
    double tm = (sl2 * sum_x - sl * sxl) / D;
    if (tm > 0) {
      tm = 0;
      ts = sl2 > 0 ? sxl / sl2 : 0;
    }
    double err = 0;
    for (int i = 0; i < n; i++)
      err += (double)w[i] * std::fabs(ts * Laux[i] + tm - x[i]);
    if (err < best_err) {
      best_err = err;
      scale = (float)ts;
      best_min = (float)tm;
      std::memcpy(L, Laux, n);
    }
  }
  *the_min = -best_min;
  return scale;
}

// Symmetric RMSE-refined fit for one 16-value group (Q3_K sub-blocks).
// L outputs in [0, 2*nmax).
float fit_symmetric(const float* x, int n, int nmax, int8_t* L) {
  float maxv = 0, amax = 0;
  for (int i = 0; i < n; i++) {
    float a = std::fabs(x[i]);
    if (a > amax) { amax = a; maxv = x[i]; }
  }
  if (amax < 1e-15f) {
    std::memset(L, 0, n);
    return 0.f;
  }
  float iscale = -nmax / maxv;
  double sumlx = 0, suml2 = 0;
  for (int i = 0; i < n; i++) {
    int l = std::clamp(nearest(iscale * x[i]), -nmax, nmax - 1);
    L[i] = (int8_t)l;
    double w = (double)x[i] * x[i];
    sumlx += w * x[i] * l;
    suml2 += w * (double)l * l;
  }
  for (int sweep = 0; sweep < 5; sweep++) {
    bool changed = false;
    for (int i = 0; i < n; i++) {
      double w = (double)x[i] * x[i];
      double slx = sumlx - w * x[i] * L[i];
      if (slx <= 0) continue;
      double sl2 = suml2 - w * (double)L[i] * L[i];
      int nl = std::clamp(nearest((float)(x[i] * sl2 / slx)), -nmax, nmax - 1);
      if (nl == L[i]) continue;
      slx += w * x[i] * nl;
      sl2 += w * (double)nl * nl;
      if (sl2 > 0 && slx * slx * suml2 > sumlx * sumlx * sl2) {
        L[i] = (int8_t)nl;
        sumlx = slx;
        suml2 = sl2;
        changed = true;
      }
    }
    if (!changed) break;
  }
  for (int i = 0; i < n; i++) L[i] += nmax;
  return suml2 > 0 ? (float)(sumlx / suml2) : 0.f;
}

void pack_2bit(const uint8_t* L, uint8_t* qs) {
  // byte qs[c*32 + l] holds weights c*128 + s*32 + l at bit 2s
  for (int c = 0; c < 2; c++)
    for (int l = 0; l < 32; l++) {
      const uint8_t* p = L + c * 128 + l;
      qs[c * 32 + l] =
          (uint8_t)(p[0] | (p[32] << 2) | (p[64] << 4) | (p[96] << 6));
    }
}

void encode_q2k_block(const float* x, uint8_t* out) {
  uint8_t L[kBlock];
  float scales[kSub], mins[kSub], weights[16];
  float max_scale = 0, max_min = 0;
  for (int j = 0; j < kSub; j++) {
    for (int i = 0; i < 16; i++) weights[i] = std::fabs(x[16 * j + i]);
    scales[j] = fit_min_scale(x + 16 * j, weights, 16, 3, L + 16 * j, &mins[j]);
    max_scale = std::max(max_scale, scales[j]);
    max_min = std::max(max_min, mins[j]);
  }
  uint8_t* sb = out;           // scales[16]
  uint8_t* qs = out + 16;      // qs[64]
  uint16_t d16 = 0, dmin16 = 0;
  if (max_scale > 0) {
    float inv = 15.f / max_scale;
    for (int j = 0; j < kSub; j++) sb[j] = (uint8_t)nearest(inv * scales[j]);
    d16 = to_f16(max_scale / 15.f);
  } else {
    std::memset(sb, 0, kSub);
  }
  if (max_min > 0) {
    float inv = 15.f / max_min;
    for (int j = 0; j < kSub; j++)
      sb[j] |= (uint8_t)(nearest(inv * mins[j]) << 4);
    dmin16 = to_f16(max_min / 15.f);
  }
  float d = from_f16(d16), dmin = from_f16(dmin16);
  for (int j = 0; j < kSub; j++) {
    float dl = d * (sb[j] & 0xF);
    if (dl == 0) continue;
    float ml = dmin * (sb[j] >> 4);
    for (int i = 0; i < 16; i++)
      L[16 * j + i] =
          (uint8_t)std::clamp(nearest((x[16 * j + i] + ml) / dl), 0, 3);
  }
  pack_2bit(L, qs);
  std::memcpy(out + 80, &d16, 2);
  std::memcpy(out + 82, &dmin16, 2);
}

void encode_q3k_block(const float* x, uint8_t* out) {
  int8_t L[kBlock];
  float scales[kSub];
  float max_scale = 0, amax = 0;
  for (int j = 0; j < kSub; j++) {
    scales[j] = fit_symmetric(x + 16 * j, 16, 4, L + 16 * j);
    float a = std::fabs(scales[j]);
    if (a > amax) { amax = a; max_scale = scales[j]; }
  }
  uint8_t* hmask = out;          // [32]
  uint8_t* qs = out + 32;        // [64]
  uint8_t* sb = out + 96;        // scales [12]
  std::memset(sb, 0, 12);
  uint16_t d16 = 0;
  if (max_scale != 0) {
    float inv = -32.f / max_scale;
    for (int j = 0; j < kSub; j++) {
      int l = std::clamp((int)(int8_t)nearest(inv * scales[j]), -32, 31) + 32;
      if (j < 8) sb[j] = (uint8_t)(l & 0xF);
      else sb[j - 8] |= (uint8_t)((l & 0xF) << 4);
      sb[8 + j % 4] |= (uint8_t)((l >> 4) << (2 * (j / 4)));
    }
    d16 = to_f16(-max_scale / 32.f);
  }
  float d = from_f16(d16);
  for (int j = 0; j < kSub; j++) {
    int lo = j < 8 ? (sb[j] & 0xF) : (sb[j - 8] >> 4);
    int hi = (sb[8 + j % 4] >> (2 * (j / 4))) & 3;
    int sc = (lo | (hi << 4)) - 32;
    float dl = d * sc;
    if (dl == 0) continue;
    for (int i = 0; i < 16; i++)
      L[16 * j + i] =
          (int8_t)(std::clamp(nearest(x[16 * j + i] / dl), -4, 3) + 4);
  }
  std::memset(hmask, 0, 32);
  uint8_t Llow[kBlock];
  for (int p = 0; p < kBlock; p++) {
    int v = L[p];
    if (v > 3) {
      hmask[p % 32] |= (uint8_t)(1u << (p / 32));
      v -= 4;
    }
    Llow[p] = (uint8_t)v;
  }
  pack_2bit(Llow, qs);
  std::memcpy(out + 108, &d16, 2);
}

void encode_q8k_block(const float* x, uint8_t* out) {
  float maxv = 0, amax = 0;
  for (int i = 0; i < kBlock; i++) {
    float a = std::fabs(x[i]);
    if (a > amax) { amax = a; maxv = x[i]; }
  }
  float* dp = (float*)out;
  int8_t* qs = (int8_t*)(out + 4);
  int16_t* bsums = (int16_t*)(out + 4 + kBlock);
  if (amax == 0) {
    *dp = 0;
    std::memset(qs, 0, kBlock);
    std::memset(bsums, 0, 32);
    return;
  }
  float iscale = -127.f / maxv;
  for (int i = 0; i < kBlock; i++)
    qs[i] = (int8_t)std::min(127, nearest(iscale * x[i]));
  for (int j = 0; j < kSub; j++) {
    int s = 0;
    for (int i = 0; i < 16; i++) s += qs[16 * j + i];
    bsums[j] = (int16_t)s;
  }
  *dp = 1.f / iscale;
}

// --- decode ---

void decode_q2k_block(const uint8_t* in, float* y) {
  const uint8_t* sb = in;
  const uint8_t* qs = in + 16;
  uint16_t d16, dmin16;
  std::memcpy(&d16, in + 80, 2);
  std::memcpy(&dmin16, in + 82, 2);
  float d = from_f16(d16), dmin = from_f16(dmin16);
  for (int c = 0; c < 2; c++)
    for (int s = 0; s < 4; s++)
      for (int l = 0; l < 32; l++) {
        int p = c * 128 + s * 32 + l;
        int q = (qs[c * 32 + l] >> (2 * s)) & 3;
        int sc = sb[p / 16];
        y[p] = d * (sc & 0xF) * q - dmin * (sc >> 4);
      }
}

void decode_q3k_block(const uint8_t* in, float* y) {
  const uint8_t* hmask = in;
  const uint8_t* qs = in + 32;
  const uint8_t* sb = in + 96;
  uint16_t d16;
  std::memcpy(&d16, in + 108, 2);
  float d = from_f16(d16);
  for (int c = 0; c < 2; c++)
    for (int s = 0; s < 4; s++)
      for (int l = 0; l < 32; l++) {
        int p = c * 128 + s * 32 + l;
        int q = (qs[c * 32 + l] >> (2 * s)) & 3;
        int hb = (hmask[p % 32] >> (p / 32)) & 1;
        int j = p / 16;
        int lo = j < 8 ? (sb[j] & 0xF) : (sb[j - 8] >> 4);
        int hi = (sb[8 + j % 4] >> (2 * (j / 4))) & 3;
        int sc = (lo | (hi << 4)) - 32;
        y[p] = d * sc * (q + 4 * hb - 4);
      }
}

}  // namespace

extern "C" {

void dseek_quantize_q2k(const float* x, uint8_t* out, int64_t rows, int64_t cols) {
  int64_t bpr = cols / kBlock;
#pragma omp parallel for schedule(dynamic)
  for (int64_t r = 0; r < rows; r++)
    for (int64_t b = 0; b < bpr; b++)
      encode_q2k_block(x + r * cols + b * kBlock,
                       out + (r * bpr + b) * kQ2Bytes);
}

void dseek_quantize_q3k(const float* x, uint8_t* out, int64_t rows, int64_t cols) {
  int64_t bpr = cols / kBlock;
#pragma omp parallel for schedule(dynamic)
  for (int64_t r = 0; r < rows; r++)
    for (int64_t b = 0; b < bpr; b++)
      encode_q3k_block(x + r * cols + b * kBlock,
                       out + (r * bpr + b) * kQ3Bytes);
}

void dseek_quantize_q8k(const float* x, uint8_t* out, int64_t rows, int64_t cols) {
  int64_t bpr = cols / kBlock;
#pragma omp parallel for schedule(dynamic)
  for (int64_t r = 0; r < rows; r++)
    for (int64_t b = 0; b < bpr; b++)
      encode_q8k_block(x + r * cols + b * kBlock,
                       out + (r * bpr + b) * kQ8Bytes);
}

void dseek_dequantize_q2k(const uint8_t* in, float* y, int64_t rows, int64_t cols) {
  int64_t bpr = cols / kBlock;
#pragma omp parallel for schedule(dynamic)
  for (int64_t r = 0; r < rows; r++)
    for (int64_t b = 0; b < bpr; b++)
      decode_q2k_block(in + (r * bpr + b) * kQ2Bytes,
                       y + r * cols + b * kBlock);
}

void dseek_dequantize_q3k(const uint8_t* in, float* y, int64_t rows, int64_t cols) {
  int64_t bpr = cols / kBlock;
#pragma omp parallel for schedule(dynamic)
  for (int64_t r = 0; r < rows; r++)
    for (int64_t b = 0; b < bpr; b++)
      decode_q3k_block(in + (r * bpr + b) * kQ3Bytes,
                       y + r * cols + b * kBlock);
}

}  // extern "C"
