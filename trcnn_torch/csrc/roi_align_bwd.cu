// K6: RoIAlign backward: g (B, R, P, P, C), float32 or bfloat16, into
// dfeat (B, H, W, C), summed in float32 and rounded once to the feature
// dtype.
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA
// RoIAlign (trcnn/ops/roi_align.py:roi_align) by autodiff, whose transpose
// scatter-adds four corner tensors of (R, P*s, P*s, C).  The spec is
// trcnn_torch/ops/roi_align.py:roi_align_backward_plain: each sample sends
// g / s^2 times its bilinear weights to its four corner cells.
//
// Design, in K4's style (roi_pool_bwd.cu): one block per (image, tile of
// ty x tx cells, channel slice of cc channels), from the wrapper's plan
// (trcnn_torch/ops/roi_align.py:_bwd_plan; cc is all of C up to 1024).  The
// block keeps the tile's float32 dfeat slab (ty x tx x cc) in shared memory,
// adds into it every bin of its image that touches the tile, and writes the
// slab once, in feat's dtype, with 16-byte stores.  Every dfeat element is
// written by exactly one block, so the wrapper allocates dfeat with
// torch.empty: no scratch in device memory, no zeroing pass, no rounding
// pass, no device-memory atomic.
//
// The weights separate: a bin's s x s samples give cell (y, x) the weight
// wy(y) * wx(x), where wy(y) sums the row weights of the bin's s sample rows
// that land on row y (1 - fy on the floor row, fy on the next), and wx(x)
// likewise.  The block first finds, one thread per RoI, the RoI's bin rows
// and bin columns whose cells reach into the tile (cells grow with the bin
// index, so a bisection over the bins, from the geometry of roi_align.cuh
// shared with K5 and the sample offsets (j + 0.5) / s divided once a
// block), and lists the RoIs that touch the tile, in order.  For a chunk of
// those it merges each touching bin axis's 2s (cell, weight) pairs into at
// most 2s distinct cells and keeps those in the tile as slab offsets.  A bin
// then costs one add per distinct (row, column) pair in the tile: 4 to 9 on
// real proposals instead of 16.
//
// Each thread owns V channels (4 or 2 on the vector path: the narrowest V
// that keeps the block at 256 threads or fewer; one for C not a multiple
// of 8 or an unaligned base) of every cell of the tile, walks the touching
// RoIs, their touching bin rows and columns and the bin's cells in one
// fixed order, loads g for four bins at a time and adds with plain
// shared-memory loads and stores.  Each slab element is thus summed by one
// thread in that order: K6 is run-to-run bit-identical and needs no
// shared-memory atomic (a compare-and-swap loop on this card: K4's header).
// The threads' vectors are consecutive in the slab, so a warp's accesses
// hit no bank twice.
//
// Arithmetic: g / s^2 as in the plain version; each add is the rounded
// product of that and the cell's merged weight wx * wy, then the rounded
// sum (__fmul_rn, __fadd_rn: no FMA, and the build does not pass
// --use_fast_math).  The merged weights and the per-thread order are not
// the plain version's index_add order, so K6 is within tolerance of it
// (one bf16 ulp of the largest dfeat, 1e-5 of it in float32), not
// bit-equal.
//
// What bounds it on the card: at R101 COCO train b=8 (128 RoIs, P=14,
// C=1024, bf16) g is 0.41 GB and dfeat 0.07 GB, 0.14 ms at 3.35 TB/s, and the
// bound's 49 operations per g element (the forward's count) 0.15 ms at 67
// TFLOP/s.  What holds it above (0.79 ms on an H100 80GB HBM3 at 700 W,
// PERF.md): each warp of a block walks the same bins for its own channels,
// so the walk's loads of bin geometry and its loop control are paid once
// per warp and per tile that a bin touches (a 3 x 3 tile at C = 1024: a bin
// of real proposals touches about two); then g's loads, then the adds.

#include "roi_align.cuh"

namespace {

using namespace trcnn_align;

constexpr int kMaxThreads = 256;
// bin axes of a chunk of RoIs kept in shared memory: 2P a RoI, 8 RoIs at P=14
constexpr int kGeomEntries = 224;
constexpr int kRoiChunk = 128;  // RoIs whose geometry and reach a block keeps at a time
constexpr int kPrefetch = 4;  // bins whose g is loaded ahead

// A bin's distinct cells along one axis that lie in the tile: their slab
// offsets and merged weights.
struct AxisCells {
  int n;
  int off[2 * kMaxS];
  float w[2 * kMaxS];
};

// The bin's s samples along one axis (offsets grid[j0 .. j0 + s) in bins):
// their floor and next cells with weights 1 - f and f, equal cells merged
// (first come first), then those in [lo, lo + n) kept as slab offsets
// (cell - lo) * stride.
__device__ void bin_cells(float start, float bin, const float* grid, int j0, int s, int size,
                          int lo, int n_tile, int stride, AxisCells& a) {
  int cell[2 * kMaxS];
  float w[2 * kMaxS];
  int n = 0;
  for (int j = j0; j < j0 + s; ++j) {
    const Sample sm = sample_from(start, bin, grid[j], size);
    const int cells[2] = {sm.lo, sm.hi};
    const float ws[2] = {__fsub_rn(1.0f, sm.f), sm.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int k = 0;
      while (k < n && cell[k] != cells[t]) ++k;
      if (k == n) {
        cell[k] = cells[t];
        w[k] = ws[t];
        ++n;
      } else {
        w[k] = __fadd_rn(w[k], ws[t]);
      }
    }
  }
  int m = 0;
  for (int k = 0; k < n; ++k) {
    if (cell[k] >= lo && cell[k] < lo + n_tile) {
      a.off[m] = (cell[k] - lo) * stride;
      a.w[m] = w[k];
      ++m;
    }
  }
  a.n = m;
}

template <typename T, int V>
__device__ __forceinline__ void load_g(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      f[0] = __ldg(reinterpret_cast<const float*>(p));
    } else {
      f[0] = __bfloat162float(__ldg(reinterpret_cast<const __nv_bfloat16*>(p)));
    }
  } else if constexpr (sizeof(T) == 4 && V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if constexpr (sizeof(T) == 4) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    f[0] = v.x, f[1] = v.y;
  } else {
    unsigned w[V / 2];
    if constexpr (V == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// slab[cell] += gv * w over the thread's V consecutive channels, the
// product and the sum each rounded (no FMA, as in the plain version).
template <int V>
__device__ __forceinline__ void add_cell(float* s, const float (&gv)[V], float w) {
  if constexpr (V == 4) {
    float4 cur = *reinterpret_cast<float4*>(s);
    cur.x = __fadd_rn(cur.x, __fmul_rn(gv[0], w));
    cur.y = __fadd_rn(cur.y, __fmul_rn(gv[1], w));
    cur.z = __fadd_rn(cur.z, __fmul_rn(gv[2], w));
    cur.w = __fadd_rn(cur.w, __fmul_rn(gv[3], w));
    *reinterpret_cast<float4*>(s) = cur;
  } else if constexpr (V == 2) {
    float2 cur = *reinterpret_cast<float2*>(s);
    cur.x = __fadd_rn(cur.x, __fmul_rn(gv[0], w));
    cur.y = __fadd_rn(cur.y, __fmul_rn(gv[1], w));
    *reinterpret_cast<float2*>(s) = cur;
  } else {
    s[0] = __fadd_rn(s[0], __fmul_rn(gv[0], w));
  }
}

// The bins [first, last] of one RoI along an axis whose cells reach into
// [lo, hi): the first whose last sample's next cell is >= lo and the last
// whose first sample's floor is < hi (both monotone in the bin), by
// bisection; first > last where none does.
__device__ __forceinline__ void touching(float start, float bin, const float* grid, int P, int S,
                                         int size, int lo, int hi, int& first, int& last) {
  int a = 0, b = P;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (sample_from(start, bin, grid[m * S + S - 1], size).hi >= lo) {
      b = m;
    } else {
      a = m + 1;
    }
  }
  first = a;
  a = -1, b = P - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (sample_from(start, bin, grid[m * S], size).lo < hi) {
      a = m;
    } else {
      b = m - 1;
    }
  }
  last = a;
}

// TG: g's element, TD: dfeat's, V: channels a thread, kS: s known at
// compile time (0: the argument S).
template <typename TG, typename TD, int V, int kS>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_bwd_kernel(const TG* __restrict__ g, const float* __restrict__ rois, int R, int H,
                         int W, int C, int P, int S_arg, float scale, int cc, int ty, int tx,
                         TD* __restrict__ dfeat) {
  const int S = kS ? kS : S_arg;
  constexpr int kCells = 2 * (kS ? kS : kMaxS);  // distinct cells of a bin axis, at most
  extern __shared__ __align__(16) float slab[];
  __shared__ AxisCells geo[kGeomEntries];
  __shared__ RoiGeom rg[kRoiChunk];
  __shared__ int4 span[kRoiChunk];  // touching bin rows [x, y] and columns [z, w]
  __shared__ short touch[kRoiChunk];  // the RoIs that touch the tile, in order
  __shared__ int warp_hits[kMaxThreads / 32];
  __shared__ float grid[kMaxSamples];
  const int ntx = (W + tx - 1) / tx;
  const int x0 = (blockIdx.x % ntx) * tx, y0 = (blockIdx.x / ntx) * ty;
  const int nx = min(tx, W - x0), ny = min(ty, H - y0);
  const int c0 = blockIdx.y * cc;
  const int b = blockIdx.z;
  const int ccs = min(cc, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const unsigned warp_mask =
      blockDim.x - warp * 32 >= 32 ? 0xffffffffu : (1u << (blockDim.x - warp * 32)) - 1;
  const bool active = tid * V < ccs;
  const int n_slab = ty * tx * cc;
  for (int i = tid; i < n_slab / 4; i += blockDim.x)
    reinterpret_cast<float4*>(slab)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = n_slab / 4 * 4 + tid; i < n_slab; i += blockDim.x) slab[i] = 0.f;
  for (int j = tid; j < P * S; j += blockDim.x) grid[j] = sample_grid(j, S);
  const float count = static_cast<float>(S * S);
  const bool pow2 = (S & (S - 1)) == 0;
  const float inv = 1.0f / count;
  const int per = 2 * P;  // a RoI's bin axes: P rows, then P columns
  const int chunk = kGeomEntries / per;
  const TG* gb = g + (size_t)b * R * P * P * C + c0 + tid * V;
  float* own = slab + tid * V;

  for (int R0 = 0; R0 < R; R0 += kRoiChunk) {
    const int nR = min(kRoiChunk, R - R0);
    // each RoI's geometry and the bins that reach into the tile; the
    // touching RoIs listed in order
    int n_touch = 0;
    for (int base = 0; base < nR; base += blockDim.x) {
      __syncthreads();  // the offsets made, warp_hits and the last RoIs done with
      const int i = base + tid;
      bool hit = false;
      if (i < nR) {
        const RoiGeom gm = roi_geom(rois + ((size_t)b * R + R0 + i) * 4, scale, P);
        int4 sp;
        touching(gm.y1, gm.bin_h, grid, P, S, H, y0, y0 + ny, sp.x, sp.y);
        touching(gm.x1, gm.bin_w, grid, P, S, W, x0, x0 + nx, sp.z, sp.w);
        hit = sp.x <= sp.y && sp.z <= sp.w;
        rg[i] = gm;
        span[i] = sp;
      }
      const unsigned ballot = __ballot_sync(warp_mask, hit);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      int before = n_touch, total = 0;
      for (int w = 0; w < n_warps; ++w) {
        before += w < warp ? warp_hits[w] : 0;
        total += warp_hits[w];
      }
      if (hit) touch[before + __popc(ballot & ((1u << lane) - 1))] = static_cast<short>(i);
      n_touch += total;
    }
    for (int t0 = 0; t0 < n_touch; t0 += chunk) {
      const int nr = min(chunk, n_touch - t0);
      __syncthreads();  // the list made, or the last chunk's walk done
      // the touching bin axes of the chunk's RoIs
      for (int e = tid; e < nr * per; e += blockDim.x) {
        const int rr = e / per, k = e - rr * per;
        const int i = touch[t0 + rr];
        const int4 sp = span[i];
        if (k < P) {
          if (k >= sp.x && k <= sp.y)
            bin_cells(rg[i].y1, rg[i].bin_h, grid, k * S, S, H, y0, ny, tx * cc, geo[e]);
        } else if (k - P >= sp.z && k - P <= sp.w) {
          bin_cells(rg[i].x1, rg[i].bin_w, grid, (k - P) * S, S, W, x0, nx, cc, geo[e]);
        }
      }
      __syncthreads();
      if (!active) continue;
      for (int rr = 0; rr < nr; ++rr) {
        const int i = touch[t0 + rr];
        const int4 sp = span[i];
        const AxisCells* cols_of = geo + rr * per + P;
        for (int ph = sp.x; ph <= sp.y; ++ph) {
          const AxisCells& ay = geo[rr * per + ph];
          const TG* gp = gb + (((size_t)(R0 + i) * P + ph) * P) * C;
          for (int pw0 = sp.z; pw0 <= sp.w; pw0 += kPrefetch) {
            float gs[kPrefetch][V];
#pragma unroll
            for (int u = 0; u < kPrefetch; ++u) {
              if (pw0 + u <= sp.w) load_g<TG, V>(gp + (size_t)(pw0 + u) * C, gs[u]);
            }
#pragma unroll
            for (int u = 0; u < kPrefetch; ++u) {
              if (pw0 + u > sp.w) break;
              const AxisCells& ax = cols_of[pw0 + u];
              float gv[V];
#pragma unroll
              for (int k = 0; k < V; ++k) gv[k] = div_count(gs[u][k], count, pow2, inv);
              int xo[kCells];
              float xw[kCells];
              const int nq = ax.n;
#pragma unroll
              for (int q = 0; q < kCells; ++q) {
                if (q < nq) xo[q] = ax.off[q], xw[q] = ax.w[q];
              }
#pragma unroll
              for (int a = 0; a < kCells; ++a) {
                if (a >= ay.n) break;
                const float wy = ay.w[a];
                float* srow = own + ay.off[a];
#pragma unroll
                for (int q = 0; q < kCells; ++q) {
                  if (q >= nq) break;
                  add_cell<V>(srow + xo[q], gv, __fmul_rn(xw[q], wy));
                }
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the slab, once, in dfeat's dtype: 16-byte vectors on the vector path
  constexpr int WV = V == 1 ? 1 : 16 / sizeof(TD);
  const int nw = ccs / WV;
  for (int i = tid; i < ny * nx * nw; i += blockDim.x) {
    const int cell = i / nw, k = i - cell * nw;
    const int y = cell / nx, x = cell - y * nx;
    const float* src = slab + (y * tx + x) * cc;
    float f[WV];
#pragma unroll
    for (int q = 0; q < WV; q += (WV >= 4 ? 4 : 1)) {
      if constexpr (WV >= 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + k * WV + q);
        f[q] = v.x, f[q + 1] = v.y, f[q + 2] = v.z, f[q + 3] = v.w;
      } else {
        f[q] = src[k * WV + q];
      }
    }
    store_vec<TD, WV, false>(
        dfeat + (((size_t)b * H + y0 + y) * W + x0 + x) * C + c0 + k * WV, f);
  }
}

template <typename TG, typename TD, int V, int kS>
cudaError_t launch(const void* g, const float* rois, int B, int R, int H, int W, int C, int P,
                   int S, float scale, int cc, int ty, int tx, int smem_bytes, void* dfeat,
                   cudaStream_t stream) {
  auto kernel = roi_align_bwd_kernel<TG, TD, V, kS>;
  const int threads = (cc + V - 1) / V;
  if (cc < 1 || cc % V != 0 || threads > kMaxThreads || ty < 1 ||
      tx < 1 || (size_t)smem_bytes < (size_t)ty * tx * cc * sizeof(float) ||
      2 * P > kGeomEntries)
    return cudaErrorInvalidValue;
  // the kernel's shared-memory limit on each device, raised when a launch
  // needs more than the last one set
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = smem_bytes;
  }
  const dim3 grid(((H + ty - 1) / ty) * ((W + tx - 1) / tx), (C + cc - 1) / cc, B);
  kernel<<<grid, threads, smem_bytes, stream>>>(static_cast<const TG*>(g), rois, R, H, W, C, P, S,
                                                scale, cc, ty, tx, static_cast<TD*>(dfeat));
  return cudaGetLastError();
}

template <typename TG, typename TD, int V>
cudaError_t launch_s(const void* g, const float* rois, int B, int R, int H, int W, int C, int P,
                     int S, float scale, int cc, int ty, int tx, int smem_bytes, void* dfeat,
                     cudaStream_t stream) {
  return S == 2 ? launch<TG, TD, V, 2>(g, rois, B, R, H, W, C, P, S, scale, cc, ty, tx,
                                       smem_bytes, dfeat, stream)
                : launch<TG, TD, V, 0>(g, rois, B, R, H, W, C, P, S, scale, cc, ty, tx,
                                       smem_bytes, dfeat, stream);
}

// The vector path (V = 4 or 2 channels a thread and 16-byte dfeat
// stores) takes C and cc multiples of 8 and 16-byte aligned bases.
template <typename TG, typename TD>
cudaError_t dispatch(const void* g, const float* rois, int B, int R, int H, int W, int C, int P,
                     int S, float scale, int V, int cc, int ty, int tx, int smem_bytes,
                     void* dfeat, cudaStream_t stream) {
  if (V > 1 && (C % 8 != 0 || cc % 8 != 0 || !aligned16(g) || !aligned16(dfeat)))
    return cudaErrorInvalidValue;
  switch (V) {
    case 4:
      return launch_s<TG, TD, 4>(g, rois, B, R, H, W, C, P, S, scale, cc, ty, tx, smem_bytes,
                                 dfeat, stream);
    case 2:
      return launch_s<TG, TD, 2>(g, rois, B, R, H, W, C, P, S, scale, cc, ty, tx, smem_bytes,
                                 dfeat, stream);
    case 1:
      return launch_s<TG, TD, 1>(g, rois, B, R, H, W, C, P, S, scale, cc, ty, tx, smem_bytes,
                                 dfeat, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// g (B, R, P, P, C) float32 (g_dtype 0) or bfloat16 (1); rois (B, R, 4)
// float32 image coordinates; dfeat (B, H, W, C) float32 (dtype 0) or
// bfloat16 (1), every element written.  The plan (ops/roi_align.py
// _bwd_plan): V channels a thread (4 or 2: the vector path; or 1), cc
// channels and ty x tx cells a block, smem_bytes >= ty * tx * cc * 4 of
// dynamic shared memory.  P * S <= 64 and S <= 4.
extern "C" cudaError_t trcnn_roi_align_bwd(const void* g, const float* rois, int B, int R, int H,
                                           int W, int C, int P, int S, float spatial_scale,
                                           int g_dtype, int dtype, int V, int cc, int ty, int tx,
                                           int smem_bytes, void* dfeat, cudaStream_t stream) {
  if (P * S > kMaxSamples || P < 1 || S < 1 || S > kMaxS || R < 0 || B < 1 || B > 65535 ||
      H < 1 || W < 1 || C < 1 || g_dtype < 0 || g_dtype > 1 || dtype < 0 || dtype > 1) {
    return cudaErrorInvalidValue;
  }
  switch (g_dtype * 2 + dtype) {
    case 0:
      return dispatch<float, float>(g, rois, B, R, H, W, C, P, S, spatial_scale, V, cc, ty, tx,
                                    smem_bytes, dfeat, stream);
    case 1:
      return dispatch<float, __nv_bfloat16>(g, rois, B, R, H, W, C, P, S, spatial_scale, V, cc,
                                            ty, tx, smem_bytes, dfeat, stream);
    case 2:
      return dispatch<__nv_bfloat16, float>(g, rois, B, R, H, W, C, P, S, spatial_scale, V, cc,
                                            ty, tx, smem_bytes, dfeat, stream);
    default:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(g, rois, B, R, H, W, C, P, S, spatial_scale,
                                                    V, cc, ty, tx, smem_bytes, dfeat, stream);
  }
}
