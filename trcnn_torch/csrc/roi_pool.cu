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
// a selection, so the output is bit-equal to the plain version.  The bin
// bounds come from roi_bins.cuh, which K4 (roi_pool_bwd.cu) shares.
//
// What bounds it on the card: bytes.  At the VGG shape (B=8, 300 RoIs, 7x7
// bins, C=512, a 38x64 map) the output is 8*300*49*512*2 B = 120 MB of bf16
// writes, and the reads are bins' windows (about 1-3 cells each in a 38x64
// map), mostly L2 hits since the whole map (2.5 MB per image) fits in L2.

#include "roi_bins.cuh"

namespace {

using namespace trcnn_roi;

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                    int R, int H, int W, int C, int P, float scale,
                                    T* __restrict__ out) {
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const RoiBins rb = roi_bins(rois + ((size_t)b * R + r) * 4, scale, P);
  int hs, he;
  bin_range(ph, rb.bin_h, rb.start_h, H, hs, he);

  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + (((size_t)b * R + r) * P + ph) * P * C;
  for (int pw = 0; pw < P; ++pw) {
    int ws, we;
    bin_range(pw, rb.bin_w, rb.start_w, W, ws, we);
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
