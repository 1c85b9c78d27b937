// K5: RoIAlign forward (bilinear, s x s samples per bin, averaged) over an
// NHWC feature map, in float32 or rounded once to bfloat16.
//
// Replaces no Pallas kernel: the JAX package computes RoIAlign in XLA
// (trcnn/ops/roi_align.py:roi_align, selected by RoIConfig.mode="align" in
// trcnn/models/faster_rcnn.py:145-149).  Its formulation gathers four
// (R, P*s, P*s, C) corner tensors and weights them in float32, which at the
// ResNet-101 COCO detect shape (B=8, R=1000, P=14, s=2, C=1024) is 25.7 GB
// per corner: it cannot run on one card.  The spec is
// trcnn_torch/ops/roi_align.py:roi_align_plain.
//
// Arithmetic, identical to the plain version's operation by operation
// (roi_align.cuh: the sample geometry, shared with K6): weights in
// float32; value = ((v00*(1-fy))*(1-fx) + (v01*(1-fy))*fx) + (v10*fy)*(1-fx))
// + (v11*fy)*fx; a bin's samples summed row by row, then divided by s*s.
// Every product and sum is an explicit __fmul_rn / __fadd_rn, so nvcc
// contracts none of them into an FMA, and the build does not pass
// --use_fast_math: the kernel is bit-equal to its plain version.  A
// bfloat16 output is the float32 mean rounded to nearest even
// (__float2bfloat16_rn), bit-equal to the plain result cast to bfloat16.
//
// Design: one block of 256 threads per (image, RoI).  Its samples touch at
// most 2Ps distinct rows and 2Ps distinct columns of the map; the block
// lists them once (sorted, each cell once: a sample's floor and next cell
// are indices into these lists, list_cells) and cuts its bin rows into
// bands whose touched rows x columns fit in one stage buffer at 64 channels
// a cell (the whole RoI on real proposals; a RoI over the whole COCO map
// takes bands of a few bin rows).  For each band it takes C in slices of
// equal width cc, as wide as the 48 KB stage allows and in whole 32-byte
// sectors of the output (all of C on small RoIs), and copies the touched
// cells' slice from device memory into shared memory by 16-byte cp.async,
// double-buffered: the next slice's copies are issued before this one's
// wait and are in flight while it computes.  Every sample is then computed
// from shared memory, one work item per (bin, 16-byte channel vector of the
// slice), and written with streaming stores.  Each feature cell thus passes
// from L2 to the SM once per band and slice, where the first design read
// each of a bin's 16 corners from L2 (256 bytes of L2 reads per 32-byte
// float32 output vector, about 51 GB per call at R101 COCO b=8).  A block
// whose bins read each touched cell fewer than kMinReuse times (16 s^2 P^2
// corner reads against its rows x columns; VGG-16's small RoIs at P=7)
// skips the staging and reads its corners from device memory through L1,
// with the same items and arithmetic: there the copies, barriers and
// slices cost more than the L2 traffic they save.  C not a multiple of the
// vector, or a base that is not 16-byte aligned, takes the same kernel one
// channel per item, copied by plain loads.
//
// What bounds it on the card: at R101 COCO b=8 the output, 1.6e9 elements,
// takes 3.2 GB in bfloat16 (1.0 ms at 3.35 TB/s) and 6.4 GB in float32
// (1.9 ms); the bound counts 49 operations an output element (four samples'
// eight products and three sums, the sums over samples and the mean), 1.2 ms
// at the card's 67 TFLOP/s of float32.  What holds it above (5.1 ms in
// bfloat16 on an H100 80GB HBM3 at 700 W, PERF.md): instruction issue.  A
// product and a sum may not merge into an FMA, so an output element costs
// 48 float32 instructions, and in bfloat16 16 more to widen its corners;
// the items' shared-memory loads and addresses come on top.  Variants that
// reused a column's products across a bin row's samples, ran 392 or 512
// threads, or three blocks an SM with smaller stages measured no faster.
// In float32 the 16 corner loads of 16 bytes per four outputs also bound
// the shared-memory bandwidth, and on VGG-16's map in float32 even the
// direct blocks stay a little slower than the first design, whose blocks
// (one per bin row) kept a smaller working set in L1.

#include "roi_align.cuh"

namespace {

using namespace trcnn_align;

constexpr int kThreads = 256;
constexpr int kBandChannels = 64;  // channels a band's stages take at least, where C has them
// corner reads per touched cell below which staging does not pay: measured
// on VGG-16's and R101's RoIs (PERF.md), where blocks below it read their
// corners through L1 faster than they could stage them
constexpr int kMinReuse = 8;
// shared memory of each of the two stage buffers: two blocks share an SM
constexpr int kStageBytes = 49152;
// a band holds at least one bin row: 2s rows x 2Ps columns x 16 bytes at s <= 4
static_assert(kStageBytes >= 2 * kMaxS * 2 * kMaxSamples * 16, "stage too small");

// A sample along one axis: its floor and next cell as indices into the
// axis's list of touched cells, and its fraction.
struct AxisSample {
  int ilo, ihi;
  float f;
};

// Bin rows [ph0, ph1) of a RoI: their touched rows are the list's
// [row0, row0 + rows), copied cc channels at a time.
struct Band {
  int ph0, ph1, row0, rows, cc;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the most recent one complete
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The samples of one axis (P*s of them) deduplicated into the sorted list
// of the cells they touch.  Floors and next cells are non-decreasing in j
// and hi <= lo + 1, so a floor is new unless it equals the previous
// sample's floor or next cell, and a next cell unless it equals its own
// floor or the previous sample's next cell; new cells come in increasing
// order.  Run by one thread.
__device__ void list_cells(const Sample* s, int n_samples, AxisSample* a, int* cells, int* count) {
  int n = 0, plo = -1, phi = -1, pilo = 0, pihi = 0;
  for (int j = 0; j < n_samples; ++j) {
    const int lo = s[j].lo, hi = s[j].hi;
    int ilo, ihi;
    if (lo == plo) {
      ilo = pilo;
    } else if (lo == phi) {
      ilo = pihi;
    } else {
      cells[n] = lo;
      ilo = n++;
    }
    if (hi == lo) {
      ihi = ilo;
    } else if (hi == phi) {
      ihi = pihi;
    } else {
      cells[n] = hi;
      ihi = n++;
    }
    a[j] = {ilo, ihi, s[j].f};
    plo = lo, phi = hi, pilo = ilo, pihi = ihi;
  }
  *count = n;
}

// A thread's items (a, b, c) of an a x b x c grid, c fastest, from item i
// on in steps of `step` items, advanced without a division per item.
struct Items {
  int a, b, c, sa, sb, sc;
  __device__ __forceinline__ Items(int i, int step, int nb, int nc) {
    c = i % nc, b = i / nc % nb, a = i / nc / nb;
    sc = step % nc, sb = step / nc % nb, sa = step / nc / nb;
  }
  __device__ __forceinline__ void next(int nb, int nc) {
    c += sc;
    int carry = c >= nc;
    c -= carry ? nc : 0;
    b += sb + carry;
    carry = b >= nb;
    b -= carry ? nb : 0;
    a += sa + carry;
  }
};

template <typename T, int V>
__device__ __forceinline__ void stage_copy(T* dst, const T* src) {
  if constexpr (sizeof(T) * V == 16) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

// Bin (ph, pw)'s mean over V channels, its corners read at at(row, col)
// (indices into the lists of touched rows and columns), with the plain
// version's products and sums in its order.
template <typename T, int V, int kS, typename At>
__device__ __forceinline__ void bin_mean(const AxisSample* ys, const AxisSample* xs, int ph,
                                         int pw, int S_arg, At at, float (&acc)[V]) {
  const int S = kS ? kS : S_arg;
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
    const AxisSample sy = ys[ph * S + iy];
    const float wy = sy.f, wy1 = __fsub_rn(1.0f, sy.f);
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      const AxisSample sx = xs[pw * S + ix];
      const float wx = sx.f, wx1 = __fsub_rn(1.0f, sx.f);
      float v00[V], v01[V], v10[V], v11[V];
      load_vec<T, V>(at(sy.ilo, sx.ilo), v00);
      load_vec<T, V>(at(sy.ilo, sx.ihi), v01);
      load_vec<T, V>(at(sy.ihi, sx.ilo), v10);
      load_vec<T, V>(at(sy.ihi, sx.ihi), v11);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        float val = __fmul_rn(__fmul_rn(v00[q], wy1), wx1);
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(v01[q], wy1), wx));
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(v10[q], wy), wx1));
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(v11[q], wy), wx));
        acc[q] = (iy == 0 && ix == 0) ? val : __fadd_rn(acc[q], val);
      }
    }
  }
  const float count = static_cast<float>(S * S);
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = div_count(acc[q], count, (S & (S - 1)) == 0, 1.0f / count);
}

// T: feat's element, O: the output's, V: channels a work item, kS: s
// known at compile time (0: the argument S).
template <typename T, typename O, int V, int kS>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois, int R,
                         int H, int W, int C, int P, int S_arg, float scale,
                         O* __restrict__ out) {
  const int S = kS ? kS : S_arg;
  constexpr int stage_elems = kStageBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sample raw[2][kMaxSamples];
  __shared__ AxisSample xs[kMaxSamples], ys[kMaxSamples];
  __shared__ int xcell[2 * kMaxSamples], ycell[2 * kMaxSamples];
  __shared__ Band bands[kMaxSamples];
  __shared__ int counts[2], n_bands;
  __shared__ bool direct;
  const int tid = threadIdx.x;
  const int r = blockIdx.x, b = blockIdx.y;
  const int PS = P * S;

  {
    const RoiGeom g = roi_geom(rois + ((size_t)b * R + r) * 4, scale, P);
    for (int j = tid; j < PS; j += kThreads) {
      raw[0][j] = sample_at(g.x1, g.bin_w, j, S, W);
      raw[1][j] = sample_at(g.y1, g.bin_h, j, S, H);
    }
  }
  __syncthreads();
  if (tid == 0) list_cells(raw[0], PS, xs, xcell, &counts[0]);
  if (tid == 32) list_cells(raw[1], PS, ys, ycell, &counts[1]);
  __syncthreads();
  const int ncols = counts[0];
  if (tid == 0) direct = P * P * S * S * 4 < kMinReuse * counts[1] * ncols;
  __syncthreads();
  if (tid == 0 && !direct) {
    // bands of bin rows whose touched cells fit a stage at kBandChannels
    // channels each (at least one bin row: 2s rows x 2Ps columns fit at
    // V); each band's C channels in slices of equal width, in whole 32-byte
    // sectors of the output where the stage takes them
    const int cells_max = stage_elems / min(kBandChannels, C);
    const int sector = max(V, 32 / (int)sizeof(O));
    int nb = 0;
    for (int ph0 = 0; ph0 < P;) {
      const int row0 = ys[ph0 * S].ilo;
      int ph1 = ph0 + 1;
      while (ph1 < P && (ys[(ph1 + 1) * S - 1].ihi - row0 + 1) * ncols <= cells_max) ++ph1;
      const int rows = ys[ph1 * S - 1].ihi - row0 + 1;
      const int fit = stage_elems / (rows * ncols);
      int cc = C;
      if (fit < C) {
        const int step = fit >= sector ? sector : V;
        const int widest = fit / step * step;
        const int slices = (C + widest - 1) / widest;
        cc = ((C + slices - 1) / slices + step - 1) / step * step;
      }
      bands[nb++] = {ph0, ph1, row0, rows, cc};
      ph0 = ph1;
    }
    n_bands = nb;
  }
  __syncthreads();

  const T* fb = feat + (size_t)b * H * W * C;
  O* ob = out + (size_t)(b * (size_t)R + r) * P * P * C;
  T* tiles[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + stage_elems};
  const int nb = n_bands;
  if (direct) {
    // too little reuse to stage: items (bin row, bin column, channel
    // vector) over all of C, corners read from device memory through L1 (a
    // loop over channel slices measured slower)
    const int nv = C / V;
    for (Items it(tid, kThreads, P, nv); it.a < P; it.next(P, nv)) {
      const T* fk = fb + it.c * V;
      float acc[V];
      bin_mean<T, V, kS>(ys, xs, it.a, it.b, S, [&](int ri, int ci) {
        return fk + ((size_t)ycell[ri] * W + xcell[ci]) * C;
      }, acc);
      store_vec<O, V, true>(ob + (size_t)(it.a * P + it.b) * C + it.c * V, acc);
    }
    return;
  }

  // copies of stage (band bi, channels from c0) into tile, as one group
  auto issue = [&](int bi, int c0, T* tile) {
    if (bi < nb) {
      const Band bd = bands[bi];
      const int ccs = min(bd.cc, C - c0);
      const int nv = ccs / V;
      // items (row, column, channel vector)
      for (Items it(tid, kThreads, ncols, nv); it.a < bd.rows; it.next(ncols, nv)) {
        stage_copy<T, V>(tile + (it.a * ncols + it.b) * ccs + it.c * V,
                         fb + ((size_t)ycell[bd.row0 + it.a] * W + xcell[it.b]) * C + c0 +
                             it.c * V);
      }
    }
    cp_async_commit();
  };

  int bi = 0, c0 = 0, nbi = 0, nc0 = 0, buf = 0;
  auto advance = [&](int& i, int& c) {
    c += bands[i].cc;
    if (c >= C) ++i, c = 0;
  };
  issue(0, 0, tiles[0]);
  advance(nbi, nc0);
  while (bi < nb) {
    issue(nbi, nc0, tiles[buf ^ 1]);  // in flight while this stage waits and computes
    cp_async_wait_prior();
    __syncthreads();
    const Band bd = bands[bi];
    const int ccs = min(bd.cc, C - c0);
    const int nv = ccs / V;
    const int nph = bd.ph1 - bd.ph0;
    const T* tile = tiles[buf];
    // items (bin row, bin column, channel vector)
    for (Items it(tid, kThreads, P, nv); it.a < nph; it.next(P, nv)) {
      const int ph = bd.ph0 + it.a, pw = it.b;
      const T* tk = tile + it.c * V;
      float acc[V];
      bin_mean<T, V, kS>(ys, xs, ph, pw, S, [&](int ri, int ci) {
        return tk + ((ri - bd.row0) * ncols + ci) * ccs;
      }, acc);
      store_vec<O, V, true>(ob + (size_t)(ph * P + pw) * C + c0 + it.c * V, acc);
    }
    __syncthreads();  // the tile free for the stage after next
    bi = nbi, c0 = nc0, buf ^= 1;
    if (nbi < nb) advance(nbi, nc0);
  }
}

template <typename T, typename O, int V, int kS>
cudaError_t launch(const void* feat, const float* rois, int B, int R, int H, int W, int C, int P,
                   int S, float scale, void* out, cudaStream_t stream) {
  auto kernel = roi_align_fwd_kernel<T, O, V, kS>;
  constexpr int smem = 2 * kStageBytes;
  // the kernel's shared-memory limit on each device, raised when a launch
  // needs more than the last one set
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = smem;
  }
  kernel<<<dim3(R, B), kThreads, smem, stream>>>(static_cast<const T*>(feat), rois, R, H, W, C,
                                                 P, S, scale, static_cast<O*>(out));
  return cudaGetLastError();
}

template <typename T, typename O, int V>
cudaError_t launch_s(const void* feat, const float* rois, int B, int R, int H, int W, int C,
                     int P, int S, float scale, void* out, cudaStream_t stream) {
  return S == 2 ? launch<T, O, V, 2>(feat, rois, B, R, H, W, C, P, S, scale, out, stream)
                : launch<T, O, V, 0>(feat, rois, B, R, H, W, C, P, S, scale, out, stream);
}

// 16-byte channel vectors where both bases are aligned and C is a multiple
// of the vector, else one channel an item.
template <typename T, typename O>
cudaError_t dispatch(const void* feat, const float* rois, int B, int R, int H, int W, int C,
                     int P, int S, float scale, void* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  return aligned16(feat) && aligned16(out) && C % V == 0
             ? launch_s<T, O, V>(feat, rois, B, R, H, W, C, P, S, scale, out, stream)
             : launch_s<T, O, 1>(feat, rois, B, R, H, W, C, P, S, scale, out, stream);
}

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; out (B, R, P, P, C) float32 (out_dtype 0) or
// bfloat16 (out_dtype 1).  P * S <= 64, S <= 4.
extern "C" cudaError_t trcnn_roi_align_fwd(const void* feat, const float* rois, int B, int R,
                                           int H, int W, int C, int P, int S,
                                           float spatial_scale, int dtype, int out_dtype,
                                           void* out, cudaStream_t stream) {
  if (P * S > kMaxSamples || P < 1 || S < 1 || S > kMaxS || B > 65535 || B < 1 || R < 1 ||
      H < 1 || W < 1 || C < 1 || dtype < 0 || dtype > 1 || out_dtype < 0 || out_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  switch (dtype * 2 + out_dtype) {
    case 0:
      return dispatch<float, float>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out,
                                    stream);
    case 1:
      return dispatch<float, __nv_bfloat16>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out,
                                            stream);
    case 2:
      return dispatch<__nv_bfloat16, float>(feat, rois, B, R, H, W, C, P, S, spatial_scale, out,
                                            stream);
    case 3:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(feat, rois, B, R, H, W, C, P, S,
                                                    spatial_scale, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
