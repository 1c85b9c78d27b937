// K6: RoIAlign backward: g (B, R, P, P, C) float32 into dfeat (B, H, W, C),
// accumulated in float32 and rounded once to the feature dtype.
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA
// RoIAlign (trcnn/ops/roi_align.py:roi_align) by autodiff, whose transpose
// scatter-adds four corner tensors of (R, P*s, P*s, C).  The spec is
// trcnn_torch/ops/roi_align.py:roi_align_backward_plain: each sample sends
// g / s^2 times its bilinear weights to its four corner cells.
//
// What bounds it on the card: bytes (g read once, dfeat written once: at
// R101 COCO train b=8, 128 RoIs, 0.82 GB of g, about 0.3 ms).  Its time is
// set by the float32 atomic adds into device memory.
//
// Design (simple first): one block per (image, RoI, bin row).  The weights
// separate: a bin's s x s samples give cell (y, x) the weight
// wy(y) * wx(x), where wy(y) sums the row weights of the bin's s sample
// rows that land on row y (1 - fy on the floor row, fy on the next), and
// wx(x) likewise.  So the block first merges each axis's 2s (cell, weight)
// pairs into at most 2s distinct cells, in shared memory, and a bin then
// costs one atomic add per distinct (row, column) pair and channel vector:
// on the small bins of real proposals, where a bin's samples share cells,
// 4 to 9 adds instead of 16.  Threads run over the row's P bins x C
// channels, one 4-channel vector each, added by one 16-byte vector atomic
// (sm_90), so a warp's adds hit 512 contiguous bytes.  Float32
// atomics add in an order that changes from run to run: the result agrees
// with the plain version within rounding, not bit for bit.
//
// The launch zeroes the float32 accumulator (the output itself for float32
// features) and, for bfloat16 features, rounds it into the output in a
// second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSamples = 64;  // P * s per axis (ops/roi_align.py MAX_SAMPLES)
constexpr int kMaxS = 4;         // s per axis (ops/roi_align.py MAX_SAMPLING)

struct AxisCells {
  int n;
  int cell[2 * kMaxS];
  float w[2 * kMaxS];
};

// The bin's s samples along one axis, starting at sample j0: their floor and
// next cells with weights 1 - f and f, equal cells merged (first come first).
__device__ __forceinline__ void bin_cells(float start, float bin, int j0, int s, int size,
                                          AxisCells& a) {
  a.n = 0;
  for (int j = j0; j < j0 + s; ++j) {
    const float grid =
        __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f), static_cast<float>(s));
    float c = __fadd_rn(start, __fmul_rn(grid, bin));
    c = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
    const float lo = floorf(c);
    const float f = __fsub_rn(c, lo);
    const int ilo = static_cast<int>(lo);
    const int cells[2] = {ilo, min(ilo + 1, size - 1)};
    const float ws[2] = {__fsub_rn(1.0f, f), f};
    for (int t = 0; t < 2; ++t) {
      int k = 0;
      while (k < a.n && a.cell[k] != cells[t]) ++k;
      if (k == a.n) {
        a.cell[k] = cells[t];
        a.w[k] = ws[t];
        ++a.n;
      } else {
        a.w[k] = __fadd_rn(a.w[k], ws[t]);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(const float* __restrict__ g, const float* __restrict__ rois, int R,
                         int H, int W, int C, int P, int S, float scale,
                         float* __restrict__ dfeat) {
  __shared__ AxisCells ycells;
  __shared__ AxisCells xcells[kMaxSamples];
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  {
    const float* roi = rois + ((size_t)b * R + r) * 4;
    const float x1 = __fmul_rn(roi[0], scale), y1 = __fmul_rn(roi[1], scale);
    const float x2 = __fmul_rn(roi[2], scale), y2 = __fmul_rn(roi[3], scale);
    const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), static_cast<float>(P));
    const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), static_cast<float>(P));
    for (int pw = threadIdx.x; pw < P; pw += blockDim.x) {
      bin_cells(x1, bin_w, pw * S, S, W, xcells[pw]);
    }
    if (threadIdx.x == 0) bin_cells(y1, bin_h, ph * S, S, H, ycells);
  }
  __syncthreads();

  const int nv = C / V;
  const float* gb = g + (((size_t)b * R + r) * P + ph) * (size_t)P * C;
  float* db = dfeat + (size_t)b * H * W * C;
  const float count = static_cast<float>(S * S);
  const int ny = ycells.n;
  for (int i = threadIdx.x; i < P * nv; i += blockDim.x) {
    const int pw = i / nv;
    const int c0 = (i - pw * nv) * V;
    float gs[V];
#pragma unroll
    for (int k = 0; k < V; ++k) gs[k] = __fdiv_rn(__ldg(gb + (size_t)pw * C + c0 + k), count);
    const AxisCells& xc = xcells[pw];
    for (int a = 0; a < ny; ++a) {
      float* row = db + (size_t)ycells.cell[a] * W * C + c0;
      const float wy = ycells.w[a];
      for (int q = 0; q < xc.n; ++q) {
        const float wxy = __fmul_rn(xc.w[q], wy);
        float* cell = row + (size_t)xc.cell[q] * C;
        if constexpr (V == 4) {
          // one 16-byte vector atomic (sm_90, global memory, 16-byte aligned)
          atomicAdd(reinterpret_cast<float4*>(cell),
                    make_float4(__fmul_rn(gs[0], wxy), __fmul_rn(gs[1], wxy),
                                __fmul_rn(gs[2], wxy), __fmul_rn(gs[3], wxy)));
        } else {
          atomicAdd(cell, __fmul_rn(gs[0], wxy));
        }
      }
    }
  }
}

__global__ void round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                              size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

}  // namespace

// g (B, R, P, P, C) float32; rois (B, R, 4) float32 image coordinates;
// scratch (B, H, W, C) float32, zeroed here; out (B, H, W, C) in dtype 0
// (float32: out may be scratch) or 1 (bfloat16, rounded from scratch).
// P * S <= 64 and S <= 4.
extern "C" cudaError_t trcnn_roi_align_bwd(const float* g, const float* rois, int B, int R,
                                           int H, int W, int C, int P, int S,
                                           float spatial_scale, int dtype, float* scratch,
                                           void* out, cudaStream_t stream) {
  if (P * S > kMaxSamples || P < 1 || S < 1 || S > kMaxS || R > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const size_t n = (size_t)B * H * W * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  if (R > 0) {
    const dim3 grid(P, R, B);
    if (C % 4 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0) {
      roi_align_bwd_kernel<4><<<grid, kThreads, 0, stream>>>(g, rois, R, H, W, C, P, S,
                                                             spatial_scale, scratch);
    } else {
      roi_align_bwd_kernel<1><<<grid, kThreads, 0, stream>>>(g, rois, R, H, W, C, P, S,
                                                             spatial_scale, scratch);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dtype == 1) {
    const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 132 * 32));
    round_to_bf16<<<blocks, 256, 0, stream>>>(scratch, static_cast<__nv_bfloat16*>(out), n);
    err = cudaGetLastError();
  }
  return err;
}
