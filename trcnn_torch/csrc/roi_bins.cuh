// Caffe RoI bin bounds, shared by K2 (roi_pool.cu, forward) and K4
// (roi_pool_bwd.cu, backward) so that the two cannot drift apart.
//
// The arithmetic is that of trcnn_torch/ops/roi_pool.py:roi_bin_bounds:
// round half away from zero as copysign(floor(|x| + 0.5), x); the bin size
// as the IEEE float32 quotient roi_size / P (__fdiv_rn; the build does not
// pass --use_fast_math, which would make '/' inexact); floor(p * bin) and
// ceil((p + 1) * bin) with __fmul_rn; clipped to the map.  RoI sizes are
// clamped to 4095 like the JAX code's division table.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trcnn_roi {

constexpr int kDivTableMax = 4096;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int round_half_away(float x) {
  return static_cast<int>(copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x));
}

// One RoI's start cell and bin size along each axis.
struct RoiBins {
  int start_h, start_w;
  float bin_h, bin_w;
};

__device__ __forceinline__ RoiBins roi_bins(const float* roi, float scale, int P) {
  const int sw = round_half_away(__fmul_rn(roi[0], scale));
  const int sh = round_half_away(__fmul_rn(roi[1], scale));
  const int ew = round_half_away(__fmul_rn(roi[2], scale));
  const int eh = round_half_away(__fmul_rn(roi[3], scale));
  const int roi_w = min(max(ew - sw + 1, 1), kDivTableMax - 1);
  const int roi_h = min(max(eh - sh + 1, 1), kDivTableMax - 1);
  return {sh, sw, __fdiv_rn(static_cast<float>(roi_h), static_cast<float>(P)),
          __fdiv_rn(static_cast<float>(roi_w), static_cast<float>(P))};
}

// Cells [lo, hi) of bin p along one axis, clipped to [0, extent].
__device__ __forceinline__ void bin_range(int p, float bin, int start, int extent,
                                          int& lo, int& hi) {
  lo = min(max(static_cast<int>(floorf(__fmul_rn(static_cast<float>(p), bin))) + start, 0),
           extent);
  hi = min(max(static_cast<int>(ceilf(__fmul_rn(static_cast<float>(p + 1), bin))) + start, 0),
           extent);
}

}  // namespace trcnn_roi
