// K2: Caffe RoI max-pool forward over an NHWC feature map.
//
// Replaces: trcnn/ops/roi_pool_pallas.py:roi_max_pool_pallas (forward,
// _forward_from -> _kernel), which reads each bin's row range through a
// sliding-max sparse table held in VMEM.  That table is a TPU formulation;
// the spec is trcnn/ops/roi_pool.py:roi_max_pool, and this kernel computes
// the spec directly.
//
// What bounds it on the card: bytes.  At the VGG detect shape (B=8, 300
// RoIs, 7x7 bins, C=512, a 38x64 map, bf16) the output is 120 MB of writes
// (about 36 us at 3.35 TB/s).  The reads are the bins' windows, about 8
// cells of 1 KB each per bin there (0.7 GB in all): no bound counts them,
// since L2 holds a whole image's map (2.5 MB in bf16), but they pass from
// L2 to the SMs and hold the kernel above its bound.  The first design (one
// block per (image, RoI, bin row), one 2-byte channel per thread, the row's
// 7 bins one after another) moved 64 bytes per warp instruction and kept
// few loads in flight: 0.474 ms at that shape, 9% of its bound.
//
// Design: one block per (image, RoI).  Its threads first place the RoI's P
// row ranges and P column ranges (roi_bins.cuh, shared with K4) in shared
// memory, then run over the RoI's whole output, P*P bins x C channels, as
// work items of one 16-byte channel vector each (8 bf16 or 4 float32):
// consecutive threads take consecutive vectors, so a warp writes 512
// contiguous bytes of output and reads 512 contiguous bytes of a window
// cell.  A thread loads each cell of its bin's window as one 16-byte
// vector, the column loop unrolled by 4 so that several loads are in
// flight, and reduces with __hmax2 on bf16 pairs or fmaxf on floats: both
// are exact selections, so the output is bit-equal to the plain version.
// An empty bin stores 0.  The stores are streaming (__stcs, evict first):
// the output is written once and read only by the next layer, and at the
// R101 pool (P=14, C=1024, B=8 x 300) it is 963 MB, far beyond L2; on the
// card they were faster there and no slower at P=7.  A channel count that
// is not a multiple of the vector, or a base that is not 16-byte aligned,
// takes the same kernel with one element per work item (V = 1).

#include <cstdint>

#include "roi_bins.cuh"

namespace {

using namespace trcnn_roi;

// V channels of T, loaded and stored as one unit: 16 bytes for V > 1.
template <typename T, int V>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 u;
  static __device__ __forceinline__ Chunk load(const __nv_bfloat16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  }
  static __device__ __forceinline__ Chunk zero() { return {make_uint4(0, 0, 0, 0)}; }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
  static __device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
    const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const unsigned*>(&m);
  }
  __device__ __forceinline__ void max_with(const Chunk& o) {
    u = make_uint4(max2(u.x, o.u.x), max2(u.y, o.u.y), max2(u.z, o.u.z), max2(u.w, o.u.w));
  }
};

template <>
struct Chunk<float, 4> {
  float4 f;
  static __device__ __forceinline__ Chunk load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  static __device__ __forceinline__ Chunk zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ __forceinline__ void store(float* p) const {
    __stcs(reinterpret_cast<float4*>(p), f);
  }
  __device__ __forceinline__ void max_with(const Chunk& o) {
    f = make_float4(fmaxf(f.x, o.f.x), fmaxf(f.y, o.f.y), fmaxf(f.z, o.f.z), fmaxf(f.w, o.f.w));
  }
};

template <typename T>
struct Chunk<T, 1> {
  float v;
  static __device__ __forceinline__ Chunk load(const T* p) { return {load_f(p)}; }
  static __device__ __forceinline__ Chunk zero() { return {0.0f}; }
  __device__ __forceinline__ void store(T* p) const { store_f(p, v); }
  __device__ __forceinline__ void max_with(const Chunk& o) { v = fmaxf(v, o.v); }
};

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    roi_pool_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois, int R, int H,
                        int W, int C, int P, float scale, T* __restrict__ out) {
  extern __shared__ int ranges[];  // hs[P], he[P], ws[P], we[P]
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const RoiBins rb = roi_bins(rois + ((size_t)b * R + r) * 4, scale, P);
    bin_range(p, rb.bin_h, rb.start_h, H, ranges[p], ranges[P + p]);
    bin_range(p, rb.bin_w, rb.start_w, W, ranges[2 * P + p], ranges[3 * P + p]);
  }
  __syncthreads();

  const int nv = C / V;  // work items per bin
  const int items = P * P * nv;
  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + ((size_t)b * R + r) * P * P * C;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int bin = i / nv;
    const int ph = bin / P;
    const int pw = bin - ph * P;
    const int hs = ranges[ph], he = ranges[P + ph];
    const int ws = ranges[2 * P + pw], we = ranges[3 * P + pw];
    const T* base = fb + (size_t)(i - bin * nv) * V;
    Chunk<T, V> m = Chunk<T, V>::zero();
    if (he > hs && we > ws) {
      m = Chunk<T, V>::load(base + ((size_t)hs * W + ws) * C);
      for (int y = hs; y < he; ++y) {
        const T* row = base + (size_t)y * W * C;
#pragma unroll 4
        for (int x = ws; x < we; ++x) m.max_with(Chunk<T, V>::load(row + (size_t)x * C));
      }
    }
    m.store(ob + (size_t)bin * C + (size_t)(i - bin * nv) * V);
  }
}

template <typename T, int V>
cudaError_t launch(const void* feat, const float* rois, int B, int R, int H, int W, int C, int P,
                   float scale, void* out, cudaStream_t stream) {
  roi_pool_fwd_kernel<T, V><<<dim3(R, B), kThreads, 4 * P * sizeof(int), stream>>>(
      static_cast<const T*>(feat), rois, R, H, W, C, P, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; out (B, R, P, P, C) in feat's dtype.
extern "C" cudaError_t trcnn_roi_pool_fwd(const void* feat, const float* rois, int B, int R,
                                          int H, int W, int C, int P, float spatial_scale,
                                          int dtype, void* out, cudaStream_t stream) {
  const bool vec = aligned16(feat) && aligned16(out);
  if (dtype == 0) {
    return vec && C % 4 == 0
               ? launch<float, 4>(feat, rois, B, R, H, W, C, P, spatial_scale, out, stream)
               : launch<float, 1>(feat, rois, B, R, H, W, C, P, spatial_scale, out, stream);
  }
  if (dtype == 1) {
    return vec && C % 8 == 0
               ? launch<__nv_bfloat16, 8>(feat, rois, B, R, H, W, C, P, spatial_scale, out, stream)
               : launch<__nv_bfloat16, 1>(feat, rois, B, R, H, W, C, P, spatial_scale, out,
                                          stream);
  }
  return cudaErrorInvalidValue;
}
