// K4: Caffe RoI max-pool backward over an NHWC feature map.
//
// Replaces: trcnn/ops/roi_pool_pallas.py:_bwd -> _backward_pallas
// (_bwd_kernel), which rebuilds each bin's max from the sliding-max table
// and writes a float32 dfeat block a whole channel block at a time, relying
// on the TPU running its grid in order.  The spec is
// trcnn/ops/roi_pool.py:roi_pool_backward_xla: each non-empty bin routes its
// whole upstream gradient to ONE argmax cell per channel, the one with the
// smallest column-major key x*H + y among equal maxima; dfeat accumulates
// in float32.
//
// Design: the argmax is recomputed from feat, so K2 stays as it is and no
// index tensor is saved (one would be 103 MB at the training shape).  One
// block per (image, RoI, bin row ph), threads across the channels, so every
// read of a cell and every atomic is a contiguous NHWC channel run.  Each
// thread walks a bin column by column, then row by row (x outer, y inner),
// and keeps the first strictly greater value: that is exactly the
// column-major-first argmax, without a second pass.  It then atomicAdds g
// (as float32) into the winner's cell of a zeroed float32 scratch dfeat that
// the wrapper allocates; the wrapper casts the scratch to feat's dtype.  The
// bin bounds come from roi_bins.cuh, shared with K2.
//
// Numerics: a float32 atomic sum's order changes from run to run, so with
// real-valued g the result matches the plain version within rounding; with
// integer-valued g every partial sum is exact and it is bit-equal.
//
// What bounds it on the card: bytes.  At the training shape (B=8, 128 RoIs,
// 7x7 bins, C=512, a 38x64 map, bf16) g is 25.69 M elements = 51.4 MB, feat
// is read once (19.9 MB) and dfeat written once (19.9 MB): about 91 MB, or
// about 27 us at 3.35 TB/s.  The float32 scratch (39.8 MB zeroed, then read
// for the cast) is this design's own cost above that bound; the atomics
// land mostly in L2, since one image's map is 2.5 MB.

#include "roi_bins.cuh"

namespace {

using namespace trcnn_roi;

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                    const T* __restrict__ g, int R, int H, int W, int C, int P,
                                    float scale, float* __restrict__ dfeat) {
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const RoiBins rb = roi_bins(rois + ((size_t)b * R + r) * 4, scale, P);
  int hs, he;
  bin_range(ph, rb.bin_h, rb.start_h, H, hs, he);
  if (he <= hs) return;

  const T* fb = feat + (size_t)b * H * W * C;
  float* db = dfeat + (size_t)b * H * W * C;
  const T* gb = g + (((size_t)b * R + r) * P + ph) * P * C;
  for (int pw = 0; pw < P; ++pw) {
    int ws, we;
    bin_range(pw, rb.bin_w, rb.start_w, W, ws, we);
    if (we <= ws) continue;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      int best = hs * W + ws;
      float m = load_f(fb + (size_t)best * C + c);
      for (int x = ws; x < we; ++x) {
        for (int y = hs; y < he; ++y) {
          const int cell = y * W + x;
          const float v = load_f(fb + (size_t)cell * C + c);
          if (v > m) {
            m = v;
            best = cell;
          }
        }
      }
      atomicAdd(db + (size_t)best * C + c, load_f(gb + (size_t)pw * C + c));
    }
  }
}

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; g (B, R, P, P, C) in feat's dtype; dfeat
// (B, H, W, C) float32, zeroed by the caller, accumulated into.
extern "C" cudaError_t trcnn_roi_pool_bwd(const void* feat, const float* rois, const void* g,
                                          int B, int R, int H, int W, int C, int P,
                                          float spatial_scale, int dtype, float* dfeat,
                                          cudaStream_t stream) {
  const dim3 grid(P, R, B);
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  if (dtype == 0) {
    roi_pool_bwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(feat), rois, static_cast<const float*>(g), R, H, W, C, P,
        spatial_scale, dfeat);
  } else if (dtype == 1) {
    roi_pool_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feat), rois, static_cast<const __nv_bfloat16*>(g),
        R, H, W, C, P, spatial_scale, dfeat);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
