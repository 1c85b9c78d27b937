// K4: Caffe RoI max-pool backward over an NHWC feature map.
//
// Replaces: trcnn/ops/roi_pool_pallas.py:_bwd -> _backward_pallas
// (_bwd_kernel), whose grid runs over (image, channel block, RoI group) and
// keeps the image's whole float32 dfeat block in VMEM, written once, with no
// atomics.  The spec is trcnn/ops/roi_pool.py:roi_pool_backward_xla: each
// non-empty bin routes its whole upstream gradient to ONE argmax cell per
// channel, the one with the smallest column-major key x*H + y among equal
// maxima; dfeat accumulates in float32 and is returned in feat's dtype.
//
// What bounds it on the card: bytes.  At the training shape (B=8, 128
// RoIs, 7x7 bins, C=512, a 38x64 map, bf16) g is 51.4 MB, feat is read once
// (19.9 MB) and dfeat written once (19.9 MB): 91 MB, about 27 us at 3.35
// TB/s.  The first design sent one float32 atomicAdd per (bin,
// channel) to a zeroed float32 scratch in device memory, which the wrapper
// then cast: the scratch cost 100 MB of traffic beside the bound's 91, and
// it ran at 8% of its bound (0.353 ms).
//
// Design, the TPU kernel's structure on Hopper: one block of 1024 threads
// per (image, channel slice of cc channels, band of rows).  In shared memory
// the block keeps its slice of the whole map (H x W x cc in feat's dtype), a
// float32 dfeat slab for its band (band_rows x W x cc) and each RoI's P row
// and P column ranges as bytes (roi_bins.cuh, shared with K2, computed once
// per block).  It copies the slice in, zeroes the slab, and walks all of its
// image's bins (R x P x P) with its threads spread over (bin, 16-byte channel
// vector).  Each work item recomputes its bin's winners from the slice with
// the walk of the spec, flattened to one loop: x outer, y inner, the first
// strictly greater value, which is the column-major-first argmax among
// ties.  bf16 values stay packed: one __hgt2_mask per bf16x2 word selects
// both the new maxima and their 16-bit cell indices.  The item then adds g,
// as float32, into the slab by shared-memory atomics where the winner's row
// lies in the band; a bin that straddles a band edge is walked by every band
// it touches and added only where its winner lies.  After a barrier the
// block writes its slab once, in feat's dtype, with 16-byte stores: every
// dfeat element is written by exactly one block, so the wrapper allocates it
// with torch.empty and needs no scratch, no zeroing and no cast.  Within a
// cell the slab's channels are XOR-swizzled by the cell's 128-byte bank row,
// so that the lanes of a warp, which add at different cells, spread over the
// banks.  The slice width and band height come from the wrapper's plan
// (trcnn_torch/ops/roi_pool.py:_bwd_plan): cc = 8 and one band at the VGG,
// R101 and COCO maps in bf16.  C not a multiple of the vector, or a base not
// 16-byte aligned, takes the same kernel one channel per work item (V = 1).
//
// What holds it above its bound (k4_split.py splits its time on the card):
// the card has no shared-memory float add, so each of the R x P x P x C adds
// is a compare-and-swap loop (ATOMS.CAST.SPIN), and each lane of a warp
// walks a different bin, so lanes idle while the largest bin of the warp
// finishes.  Walking the map through L1 and L2 instead of a shared slice was
// slower than the first design.
//
// The large-map variant (kGlobal, entry point trcnn_roi_pool_bwd_large):
// a map whose slice does not fit in shared memory beside the slab, or that
// has more than 255 cells on a side, is walked from global memory (L1 and
// L2) instead, with the same blocks, the same walk and the same float32
// slab of dfeat in shared memory; bin ranges are 16-bit, winners plain
// ints.  The wrapper's plan picks it only for such maps: where the slice
// fits, an L2 walk measured slower than the shared slice (PERF.md).  The slab
// alone bounds it: band_rows x W x cc floats, down to one channel a block,
// so it takes maps up to 65535 rows and 56064 columns, and, since cell
// indices and winners are ints, at most INT_MAX cells.
//
// Numerics: shared-memory atomics add in a run-dependent order, so with
// real-valued g the result matches the plain version within rounding; with
// integer-valued g every partial sum is exact and it is bit-equal.

#include <climits>
#include <cstdint>
#include <type_traits>

#include "roi_bins.cuh"

namespace {

using namespace trcnn_roi;

constexpr int kThreads = 1024;
// Shared memory for a chunk of RoIs beside the slice and the slab: each
// RoI's P row ranges and P column ranges, 4P coordinates a RoI, as bytes
// (16-bit in the large-map variant)
// (= trcnn_torch/ops/roi_pool.py:_CHUNK_BYTES).
constexpr int kChunkBytes = 8192;

// V consecutive channels at p (device or shared memory) widened to float,
// exact for bf16: one 16-byte load for V > 1.
template <typename T, int V>
__device__ __forceinline__ void load_lanes(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = load_f(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_lanes(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    store_f(p, f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 0xffff in each 16-bit half where bf16 a > bf16 b (IEEE: false for NaN
// and for -0 against +0), as the float compare of the widened values.
__device__ __forceinline__ unsigned gt_mask(unsigned a, unsigned b) {
  return __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&a),
                     *reinterpret_cast<const __nv_bfloat162*>(&b));
}

// A bin's running argmax over V channels of T: the first cell, then each
// later cell whose value is strictly greater.  kPacked selects the packed
// bf16 form below where it exists.
template <typename T, int V, bool kPacked>
struct Argmax {
  float m[V];
  int best[V];
  __device__ __forceinline__ void init(const T* p, int cell) {
    load_lanes<T, V>(p, m);
#pragma unroll
    for (int k = 0; k < V; ++k) best[k] = cell;
  }
  __device__ __forceinline__ void step(const T* p, int cell) {
    float f[V];
    load_lanes<T, V>(p, f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (f[k] > m[k]) {
        m[k] = f[k];
        best[k] = cell;
      }
    }
  }
  __device__ __forceinline__ int winner(int k) const { return best[k]; }
};

// bf16 in 16-byte vectors: values stay packed as bf16x2 words, winners as
// 16-bit cell pairs (a slice has under 2^16 cells: it fits in shared
// memory), and one mask per word selects both, three instructions per two
// channels.  Not for the large-map variant, whose maps may have more cells.
template <>
struct Argmax<__nv_bfloat16, 8, true> {
  unsigned m[4], best[4];
  __device__ __forceinline__ void init(const __nv_bfloat16* p, int cell) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) best[k] = static_cast<unsigned>(cell) * 0x10001u;
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* p, int cell) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    const unsigned cells = static_cast<unsigned>(cell) * 0x10001u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned gt = gt_mask(w[k], m[k]);
      m[k] = (m[k] & ~gt) | (w[k] & gt);
      best[k] = (best[k] & ~gt) | (cells & gt);
    }
  }
  __device__ __forceinline__ int winner(int k) const {
    return (best[k >> 1] >> (16 * (k & 1))) & 0xffff;
  }
};

// Bytes of the shared slice, rounded up so that the slab after it stays
// 16-byte aligned.
__host__ __device__ __forceinline__ size_t tile_bytes(int cells, int cc, size_t elem) {
  return ((size_t)cells * cc * elem + 127) / 128 * 128;
}

// Slab index of channel c of a cell: cc floats per cell, the low bits of c
// XOR-ed with the cell's 128-byte bank row (within one V-channel group).
template <int V>
__device__ __forceinline__ int slab_index(int cell, int c, int cc) {
  return cell * cc + (c ^ (((cell * cc) >> 5) & (V - 1)));
}

// One work item: bin (ph, pw) of a RoI for channel vector v.  Walks the
// bin's cells of the map (src, cells `stride` elements apart: the shared
// slice, or feat itself in the large-map variant) in column-major order
// (x outer, y inner) and adds g (V channels at gp) into the slab at each
// channel's winner that lies in the band [y_lo, y_hi).
template <typename T, int V, bool kGlobal, typename Coord>
__device__ __forceinline__ void accumulate_bin(const Coord* rg, int ph, int pw, int v, int W,
                                               int P, int cc, int y_lo, int y_hi, const T* src,
                                               int stride, float* slab, const T* gp) {
  const int hs = rg[ph], he = rg[P + ph];
  if (he <= hs || he <= y_lo || hs >= y_hi) return;  // empty, or not in the band
  const int ws = rg[2 * P + pw], we = rg[3 * P + pw];
  if (we <= ws) return;
  float gv[V];
  load_lanes<T, V>(gp, gv);
  const T* col = src + v * V;
  int cell = hs * W + ws;
  Argmax<T, V, !kGlobal> am;
  // 64-bit cell offsets only where the map lies in global memory
  auto at = [&](int c) { return col + (kGlobal ? (size_t)c * stride : (size_t)(c * stride)); };
  am.init(at(cell), cell);
  const int bh = he - hs, n = (we - ws) * bh;
  int y = 0;
#pragma unroll 4
  for (int t = 1; t < n; ++t) {
    if (++y == bh) {
      y = 0;
      cell += 1 - (bh - 1) * W;
    } else {
      cell += W;
    }
    am.step(at(cell), cell);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int w = am.winner(k) - y_lo * W;
    if (w >= 0 && w < (y_hi - y_lo) * W) atomicAdd(slab + slab_index<V>(w, v * V + k, cc), gv[k]);
  }
}

template <typename T, int V, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
    roi_pool_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                        const T* __restrict__ g, int R, int H, int W, int C, int P, float scale,
                        int cc, int band_rows, T* __restrict__ dfeat) {
  using Coord = std::conditional_t<kGlobal, uint16_t, uint8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * cc;
  const int y_lo = blockIdx.y * band_rows;
  const int y_hi = min(H, y_lo + band_rows);
  const int b = blockIdx.z;
  const int map_cells = H * W;
  const int slab_cells = band_rows * W;
  T* tile = reinterpret_cast<T*>(smem);
  float* slab = reinterpret_cast<float*>(
      smem + (kGlobal ? 0 : tile_bytes(map_cells, cc, sizeof(T))));
  Coord* ranges = reinterpret_cast<Coord*>(slab + (size_t)slab_cells * cc);
  const int chunk = kChunkBytes / (4 * P * (int)sizeof(Coord));

  const int nv = min(cc, C - c0) / V;  // work items per bin
  const T* fb = feat + (size_t)b * H * W * C + c0;
  if constexpr (!kGlobal) {
    for (int i = threadIdx.x; i < map_cells * nv; i += blockDim.x) {
      const int cell = i / nv;
      const int v = i - cell * nv;
      if constexpr (V == 1) {
        tile[cell * cc + v] = fb[(size_t)cell * C + v];
      } else {
        *reinterpret_cast<uint4*>(tile + cell * cc + v * V) =
            __ldg(reinterpret_cast<const uint4*>(fb + (size_t)cell * C + v * V));
      }
    }
  }
  if ((slab_cells * cc) % 4 == 0) {
    float4* slab4 = reinterpret_cast<float4*>(slab);
    for (int i = threadIdx.x; i < slab_cells * cc / 4; i += blockDim.x)
      slab4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < slab_cells * cc; i += blockDim.x) slab[i] = 0.f;
  }
  const T* src = kGlobal ? fb : tile;
  const int stride = kGlobal ? C : cc;

  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int nr = min(chunk, R - r0);
    if (r0 > 0) __syncthreads();  // the previous chunk done with
    // each RoI's P row ranges and P column ranges: 4P bytes (the first
    // chunk's while the slice loads)
    for (int i = threadIdx.x; i < nr * P; i += blockDim.x) {
      const int rr = i / P, p = i - rr * P;
      const RoiBins rb = roi_bins(rois + ((size_t)b * R + r0 + rr) * 4, scale, P);
      Coord* rg = ranges + rr * 4 * P;
      int lo, hi;
      bin_range(p, rb.bin_h, rb.start_h, H, lo, hi);
      rg[p] = lo, rg[P + p] = hi;
      bin_range(p, rb.bin_w, rb.start_w, W, lo, hi);
      rg[2 * P + p] = lo, rg[3 * P + p] = hi;
    }
    __syncthreads();
    // this thread's items (rr, ph, pw, v), v fastest, advanced by blockDim
    // in mixed radix, without a division per item
    int v = threadIdx.x % nv, pw = threadIdx.x / nv;
    int ph = pw / P, rr = ph / P;
    pw -= ph * P, ph -= rr * P;
    const int sv = blockDim.x % nv, sq = blockDim.x / nv;
    const int spw = sq % P, sph = sq / P % P, srr = sq / (P * P);
    while (rr < nr) {
      const int q = (rr * P + ph) * P + pw;  // the bin, counted over the chunk's RoIs
      accumulate_bin<T, V, kGlobal>(ranges + rr * 4 * P, ph, pw, v, W, P, cc, y_lo, y_hi, src,
                                    stride, slab,
                                    g + (((size_t)b * R + r0) * P * P + q) * C + c0 + v * V);
      v += sv;
      int carry = v >= nv;
      v -= carry ? nv : 0;
      pw += spw + carry;
      carry = pw >= P;
      pw -= carry ? P : 0;
      ph += sph + carry;
      carry = ph >= P;
      ph -= carry ? P : 0;
      rr += srr + carry;
    }
  }
  __syncthreads();

  const int out_items = (y_hi - y_lo) * W * nv;
  T* db = dfeat + ((size_t)b * H + y_lo) * W * C + c0;
  for (int i = threadIdx.x; i < out_items; i += blockDim.x) {
    const int cell = i / nv;
    const int v = i - cell * nv;
    float f[V];
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = slab[slab_index<V>(cell, v * V + k, cc)];
    store_lanes<T, V>(db + (size_t)cell * C + v * V, f);
  }
}

template <typename T, int V, bool kGlobal>
cudaError_t launch(const void* feat, const float* rois, const void* g, int B, int R, int H,
                   int W, int C, int P, float scale, int cc, int band_rows, int smem_bytes,
                   void* dfeat, cudaStream_t stream) {
  const size_t coord = kGlobal ? 2 : 1;
  const size_t need = (kGlobal ? 0 : tile_bytes(H * W, cc, sizeof(T))) +
                      (size_t)band_rows * W * cc * sizeof(float) + kChunkBytes;
  const int max_side = kGlobal ? 65535 : 255;
  if (cc <= 0 || cc % V != 0 || (!kGlobal && cc * sizeof(T) % 16 != 0) || band_rows <= 0 ||
      (size_t)smem_bytes < need || P < 1 || 4 * P * coord > kChunkBytes || H > max_side ||
      W > max_side || (size_t)H * W > (size_t)INT_MAX)
    return cudaErrorInvalidValue;
  // the kernel's shared-memory limit on each device, raised when a launch
  // needs more than the last one set
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(roi_pool_bwd_kernel<T, V, kGlobal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = smem_bytes;
  }
  const dim3 grid((C + cc - 1) / cc, (H + band_rows - 1) / band_rows, B);
  roi_pool_bwd_kernel<T, V, kGlobal><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(feat), rois, static_cast<const T*>(g), R, H, W, C, P, scale, cc,
      band_rows, static_cast<T*>(dfeat));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte vectors where every pointer is aligned and the channel count and
// the slice width are multiples of the vector, else one channel an item.
template <bool kGlobal>
cudaError_t dispatch(const void* feat, const float* rois, const void* g, int B, int R, int H,
                     int W, int C, int P, float scale, int dtype, int cc, int band_rows,
                     int smem_bytes, void* dfeat, cudaStream_t stream) {
  const bool aligned = aligned16(feat) && aligned16(g) && aligned16(dfeat);
  if (dtype == 0) {
    return aligned && C % 4 == 0 && cc % 4 == 0
               ? launch<float, 4, kGlobal>(feat, rois, g, B, R, H, W, C, P, scale, cc,
                                           band_rows, smem_bytes, dfeat, stream)
               : launch<float, 1, kGlobal>(feat, rois, g, B, R, H, W, C, P, scale, cc,
                                           band_rows, smem_bytes, dfeat, stream);
  }
  if (dtype == 1) {
    return aligned && C % 8 == 0 && cc % 8 == 0
               ? launch<__nv_bfloat16, 8, kGlobal>(feat, rois, g, B, R, H, W, C, P, scale, cc,
                                                   band_rows, smem_bytes, dfeat, stream)
               : launch<__nv_bfloat16, 1, kGlobal>(feat, rois, g, B, R, H, W, C, P, scale, cc,
                                                   band_rows, smem_bytes, dfeat, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// feat (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1); rois (B, R, 4)
// float32 image coordinates; g (B, R, P, P, C) in feat's dtype; dfeat
// (B, H, W, C) in feat's dtype, every element written.  cc channels (cc
// elements of feat's dtype a multiple of 16 bytes) and band_rows rows per
// block, smem_bytes of dynamic shared memory: H * W * cc elements of feat's
// dtype rounded up to 128 bytes, band_rows * W * cc floats and kChunkBytes
// (the wrapper's plan).  H and W are at most 255.
extern "C" cudaError_t trcnn_roi_pool_bwd(const void* feat, const float* rois, const void* g,
                                          int B, int R, int H, int W, int C, int P,
                                          float spatial_scale, int dtype, int cc, int band_rows,
                                          int smem_bytes, void* dfeat, cudaStream_t stream) {
  return dispatch<false>(feat, rois, g, B, R, H, W, C, P, spatial_scale, dtype, cc, band_rows,
                         smem_bytes, dfeat, stream);
}

// The large-map variant, same arguments: feat walked from global memory, so
// smem_bytes holds band_rows * W * cc floats and kChunkBytes only; any cc
// from 1 up; H and W at most 65535, H * W at most INT_MAX.
extern "C" cudaError_t trcnn_roi_pool_bwd_large(const void* feat, const float* rois,
                                                const void* g, int B, int R, int H, int W, int C,
                                                int P, float spatial_scale, int dtype, int cc,
                                                int band_rows, int smem_bytes, void* dfeat,
                                                cudaStream_t stream) {
  return dispatch<true>(feat, rois, g, B, R, H, W, C, P, spatial_scale, dtype, cc, band_rows,
                        smem_bytes, dfeat, stream);
}
