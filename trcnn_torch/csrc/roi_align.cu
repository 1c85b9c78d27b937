// K5: RoIAlign forward (bilinear, s x s samples per bin, averaged) over an
// NHWC feature map, float32 output.
//
// Replaces no Pallas kernel: the JAX package computes RoIAlign in XLA
// (trcnn/ops/roi_align.py:roi_align, selected by RoIConfig.mode="align" in
// trcnn/models/faster_rcnn.py:145-149).  Its formulation gathers four
// (R, P*s, P*s, C) corner tensors and weights them in float32, which at the
// ResNet-101 COCO detect shape (B=8, R=1000, P=14, s=2, C=1024) is 25.7 GB
// per corner: it cannot run on one card.  The spec is
// trcnn_torch/ops/roi_align.py:roi_align_plain.
//
// Arithmetic, identical to the plain version's operation by operation:
// x1 = roi * scale; roi_w = max(x2 - x1, 1); bin = roi_w / P (IEEE
// quotient); sample j at x1 + ((j + 0.5) / s) * bin, clipped to [0, W-1],
// floored; weights in float32; value = ((v00*(1-fy))*(1-fx) +
// (v01*(1-fy))*fx) + (v10*fy)*(1-fx)) + (v11*fy)*fx; a bin's samples summed
// row by row, then divided by s*s.  Every product and sum is an explicit
// __fmul_rn / __fadd_rn, so nvcc contracts none of them into an FMA, and the
// build does not pass --use_fast_math: the kernel is bit-equal to its plain
// version.
//
// What bounds it on the card: bytes.  The float32 output is written once:
// at R101 COCO detect b=8 it is 6.4 GB, about 1.9 ms at 3.35 TB/s.  An
// image's map (8.6 MB in bf16 at 50 x 84 x 1024) stays in L2, so the 16
// corner reads per bin and channel pass from L2 to the SMs and are what
// holds the kernel above its bound.
//
// Design (simple first): one block per (image, RoI, bin row).  Its threads
// place the row's s sample rows and the RoI's P*s sample columns (cell,
// neighbour, fraction) in shared memory, then run over the row's P bins x C
// channels as work items of one 16-byte channel vector (8 bf16 or 4
// float32); consecutive threads take consecutive vectors, so a warp reads
// 512 contiguous bytes of one corner cell and writes the output with
// streaming stores.  A channel count that is not a multiple of the vector,
// or a base that is not 16-byte aligned, takes one channel per item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSamples = 64;  // P * s per axis (ops/roi_align.py MAX_SAMPLES)

struct Sample {
  int lo, hi;
  float f;
};

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

// Sample j of P*s along an axis of `size` cells.
__device__ __forceinline__ Sample sample_at(float start, float bin, int j, int s, int size) {
  const float grid = __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f), static_cast<float>(s));
  float c = __fadd_rn(start, __fmul_rn(grid, bin));
  c = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
  const float lo = floorf(c);
  const int ilo = static_cast<int>(lo);
  return {ilo, min(ilo + 1, size - 1), __fsub_rn(c, lo)};
}

template <typename T, int V>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      __stcs(reinterpret_cast<float4*>(p + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois, int R,
                         int H, int W, int C, int P, int S, float scale,
                         float* __restrict__ out) {
  __shared__ Sample ys[kMaxSamples];
  __shared__ Sample xs[kMaxSamples];
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const RoiGeom g = roi_geom(rois + ((size_t)b * R + r) * 4, scale, P);
  for (int j = threadIdx.x; j < P * S; j += blockDim.x) {
    xs[j] = sample_at(g.x1, g.bin_w, j, S, W);
    if (j < S) ys[j] = sample_at(g.y1, g.bin_h, ph * S + j, S, H);
  }
  __syncthreads();

  const int nv = C / V;
  const T* fb = feat + (size_t)b * H * W * C;
  float* ob = out + (((size_t)b * R + r) * P + ph) * (size_t)P * C;
  const float count = static_cast<float>(S * S);
  for (int i = threadIdx.x; i < P * nv; i += blockDim.x) {
    const int pw = i / nv;
    const int c0 = (i - pw * nv) * V;
    float acc[V] = {};
    for (int iy = 0; iy < S; ++iy) {
      const Sample sy = ys[iy];
      const float wy = sy.f, wy1 = __fsub_rn(1.0f, sy.f);
      const T* row_lo = fb + (size_t)sy.lo * W * C + c0;
      const T* row_hi = fb + (size_t)sy.hi * W * C + c0;
      for (int ix = 0; ix < S; ++ix) {
        const Sample sx = xs[pw * S + ix];
        const float wx = sx.f, wx1 = __fsub_rn(1.0f, sx.f);
        float v00[V], v01[V], v10[V], v11[V];
        Vec<T, V>::load(row_lo + (size_t)sx.lo * C, v00);
        Vec<T, V>::load(row_lo + (size_t)sx.hi * C, v01);
        Vec<T, V>::load(row_hi + (size_t)sx.lo * C, v10);
        Vec<T, V>::load(row_hi + (size_t)sx.hi * C, v11);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float val = __fmul_rn(__fmul_rn(v00[k], wy1), wx1);
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(v01[k], wy1), wx));
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(v10[k], wy), wx1));
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(v11[k], wy), wx));
          acc[k] = (iy == 0 && ix == 0) ? val : __fadd_rn(acc[k], val);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fdiv_rn(acc[k], count);
    store<V>(ob + (size_t)pw * C + c0, acc);
  }
}

template <typename T, int V>
cudaError_t launch(const void* feat, const float* rois, int B, int R, int H, int W, int C, int P,
                   int S, float scale, float* out, cudaStream_t stream) {
  roi_align_fwd_kernel<T, V><<<dim3(P, R, B), kThreads, 0, stream>>>(
      static_cast<const T*>(feat), rois, R, H, W, C, P, S, scale, out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; out (B, R, P, P, C) float32.  P * S <= 64.
extern "C" cudaError_t trcnn_roi_align_fwd(const void* feat, const float* rois, int B, int R,
                                           int H, int W, int C, int P, int S,
                                           float spatial_scale, int dtype, float* out,
                                           cudaStream_t stream) {
  if (P * S > kMaxSamples || P < 1 || S < 1 || R > 65535 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  const bool vec = aligned16(feat) && aligned16(out);
  if (dtype == 0) {
    return vec && C % 4 == 0
               ? launch<float, 4>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out, stream)
               : launch<float, 1>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out, stream);
  }
  if (dtype == 1) {
    return vec && C % 8 == 0
               ? launch<__nv_bfloat16, 8>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out,
                                          stream)
               : launch<__nv_bfloat16, 1>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out,
                                          stream);
  }
  return cudaErrorInvalidValue;
}
