// RoIAlign sample geometry and channel-vector helpers, shared by K5
// (roi_align.cu, forward) and K6 (roi_align_bwd.cu, backward) so that the
// two cannot drift apart.
//
// The arithmetic is that of trcnn_torch/ops/roi_align.py:_samples, which
// repeats the JAX package's (trcnn/ops/roi_align.py): x1 = roi * scale;
// roi_w = max(x2 - x1, 1); bin = roi_w / P as the IEEE float32 quotient
// (__fdiv_rn; the build does not pass --use_fast_math); sample j of the
// RoI's P*s along an axis at x1 + ((j + 0.5) / s) * bin, clipped to
// [0, size - 1] before its floor; lo = floor, hi = min(lo + 1, size - 1),
// frac = c - lo.  Every product and sum is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc contracts none of them into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace trcnn_align {

constexpr int kMaxSamples = 64;  // P * s per axis (ops/roi_align.py MAX_SAMPLES)
constexpr int kMaxS = 4;         // s per axis (ops/roi_align.py MAX_SAMPLING)

// One RoI's start and bin size along each axis.
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, float scale, int P) {
  const float x1 = __fmul_rn(roi[0], scale), y1 = __fmul_rn(roi[1], scale);
  const float x2 = __fmul_rn(roi[2], scale), y2 = __fmul_rn(roi[3], scale);
  const float roi_w = fmaxf(__fsub_rn(x2, x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(y2, y1), 1.0f);
  return {x1, y1, __fdiv_rn(roi_w, static_cast<float>(P)),
          __fdiv_rn(roi_h, static_cast<float>(P))};
}

struct Sample {
  int lo, hi;
  float f;
};

// (j + 0.5) / s, sample j's offset in bins.
__device__ __forceinline__ float sample_grid(int j, int s) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f), static_cast<float>(s));
}

// The sample at `grid` bins from start along an axis of `size` cells.
__device__ __forceinline__ Sample sample_from(float start, float bin, float grid, int size) {
  float c = __fadd_rn(start, __fmul_rn(grid, bin));
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
  const float lo = floorf(c);
  const int ilo = static_cast<int>(lo);
  return {ilo, min(ilo + 1, size - 1), __fsub_rn(c, lo)};
}

// Sample j of P*s along an axis of `size` cells.
__device__ __forceinline__ Sample sample_at(float start, float bin, int j, int s, int size) {
  return sample_from(start, bin, sample_grid(j, s), size);
}

// x / (s * s): a bin's mean (K5) or a sample's share of the bin's
// cotangent (K6).  For s a power of two the quotient is exact as a product
// by the reciprocal, which the IEEE quotient then equals bit for bit.
__device__ __forceinline__ float div_count(float x, float count, bool pow2, float inv) {
  return pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, count);
}

// V consecutive channels at p (device or shared memory) widened to float,
// exact for bf16: one 16-byte load for V * sizeof(T) == 16, else V
// element loads.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (sizeof(T) * V == 16 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if constexpr (sizeof(T) * V == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = p[k];
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = __bfloat162float(p[k]);
  }
}

template <typename U, bool kStream>
__device__ __forceinline__ void put(U* p, const U& v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// V floats stored as V consecutive elements of T at p (device memory),
// rounded to nearest even for bf16, with streaming stores (evict first)
// when kStream: 16-byte vectors for 4 or 8 float32 and 8 bf16, an 8-byte
// one for 4 bf16, else one element at a time.
template <typename T, int V, bool kStream>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (sizeof(T) == 4 && V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      put<float4, kStream>(reinterpret_cast<float4*>(p + k),
                           make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]));
    }
  } else if constexpr (sizeof(T) == 2 && (V == 4 || V == 8)) {
    unsigned w[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    if constexpr (V == 8) {
      put<uint4, kStream>(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      put<uint2, kStream>(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = f[k];
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16_rn(f[k]);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace trcnn_align
