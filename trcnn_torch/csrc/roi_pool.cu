// K2: Caffe RoI max-pool forward over an NHWC feature map.
//
// Replaces: trcnn/ops/roi_pool_pallas.py:roi_max_pool_pallas (forward,
// _forward_from -> _kernel), which reads each bin's row range through a
// sliding-max sparse table held in VMEM.  That table is a TPU formulation;
// the spec is trcnn/ops/roi_pool.py:roi_max_pool, and this kernel computes
// the spec directly.
//
// Design: one block per (image, RoI, bin row ph); its threads run over the
// channels, so every read of a feature cell is a contiguous NHWC channel run
// and coalesced.  Each thread loops over the bin columns pw and the bin's
// cells with a float32 running max and writes 0 for an empty bin.  A max is
// a selection, so the output is bit-equal to the plain version.
//
// Bin bounds are computed in the kernel exactly as roi_pool.py:50-108 does:
// round half away from zero as copysign(floor(|x| + 0.5), x); the bin size
// as the IEEE float32 quotient roi_size / P (__fdiv_rn; the build does not
// pass --use_fast_math, which would make '/' inexact); floor(p * bin) and
// ceil((p + 1) * bin) with __fmul_rn; clipped to the map.  roi sizes are
// clamped to 4095 like the JAX code's division table.
//
// What bounds it on the card: bytes.  At the VGG shape (B=8, 300 RoIs, 7x7
// bins, C=512, a 38x64 map) the output is 8*300*49*512*2 B = 120 MB of bf16
// writes, and the reads are bins' windows (about 1-3 cells each in a 38x64
// map), mostly L2 hits since the whole map (2.5 MB per image) fits in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDivTableMax = 4096;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int round_half_away(float x) {
  return static_cast<int>(copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x));
}

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                    int R, int H, int W, int C, int P, float scale,
                                    T* __restrict__ out) {
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const float* roi = rois + ((size_t)b * R + r) * 4;
  const int sw = round_half_away(__fmul_rn(roi[0], scale));
  const int sh = round_half_away(__fmul_rn(roi[1], scale));
  const int ew = round_half_away(__fmul_rn(roi[2], scale));
  const int eh = round_half_away(__fmul_rn(roi[3], scale));
  const int roi_w = min(max(ew - sw + 1, 1), kDivTableMax - 1);
  const int roi_h = min(max(eh - sh + 1, 1), kDivTableMax - 1);
  const float bin_w = __fdiv_rn(static_cast<float>(roi_w), static_cast<float>(P));
  const float bin_h = __fdiv_rn(static_cast<float>(roi_h), static_cast<float>(P));

  const int hs = min(max(static_cast<int>(floorf(__fmul_rn(static_cast<float>(ph), bin_h))) + sh, 0), H);
  const int he = min(max(static_cast<int>(ceilf(__fmul_rn(static_cast<float>(ph + 1), bin_h))) + sh, 0), H);

  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + (((size_t)b * R + r) * P + ph) * P * C;
  for (int pw = 0; pw < P; ++pw) {
    const int ws = min(max(static_cast<int>(floorf(__fmul_rn(static_cast<float>(pw), bin_w))) + sw, 0), W);
    const int we = min(max(static_cast<int>(ceilf(__fmul_rn(static_cast<float>(pw + 1), bin_w))) + sw, 0), W);
    const bool empty = (he <= hs) || (we <= ws);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float m = -INFINITY;
      for (int y = hs; y < he; ++y)
        for (int x = ws; x < we; ++x) m = fmaxf(m, load_f(fb + ((size_t)y * W + x) * C + c));
      store_f(ob + (size_t)pw * C + c, empty ? 0.0f : m);
    }
  }
}

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; out (B, R, P, P, C) in feat's dtype.
extern "C" cudaError_t trcnn_roi_pool_fwd(const void* feat, const float* rois, int B, int R,
                                          int H, int W, int C, int P, float spatial_scale,
                                          int dtype, void* out, cudaStream_t stream) {
  const dim3 grid(P, R, B);
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  if (dtype == 0) {
    roi_pool_fwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(feat), rois, R, H, W, C, P, spatial_scale,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_pool_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feat), rois, R, H, W, C, P, spatial_scale,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
