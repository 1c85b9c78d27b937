// K1: exact greedy NMS over score-sorted boxes, "+1" pixel convention,
// batched over images: one launch per batch.
//
// Replaces: trcnn/ops/nms_pallas.py:nms_padded_pallas (_suppression_kernel),
// the TPU kernel that solves each 256-box tile's greedy order by a Jacobi
// fixpoint, under jax.vmap in the JAX model (a batch grid dimension).  This
// is the bitmask design of the reference's CUDA NMS instead, with the batch
// written out:
//
//   pass 1 (trcnn_nms_mask_kernel): one 64-thread block per (image, row
//     block, column block >= row block): only the upper triangle is
//     launched.  Thread i writes the 64-bit mask of the later boxes j of the
//     column block that it would suppress: inter*(1+t) > t*area_i +
//     t*area_j, evaluated with __fmul_rn / __fadd_rn so that no
//     multiply-add is contracted (the JAX predicate,
//     trcnn/ops/boxes.py:box_overlap_gt).  With groups, only same-group
//     pairs count.
//   pass 2 (trcnn_nms_reduce_kernel): one block per image, all images at
//     once.  The `removed` bitmask lives in shared memory, invalid boxes and
//     the tail past n removed from the start.  Stripe by stripe (64 boxes):
//       a. one thread resolves the stripe's greedy decisions from its 64
//          diagonal words (staged in shared memory) in registers, visiting
//          only the boxes still standing, and writes the kept positions;
//       b. all threads OR the kept rows' words of the later column blocks
//          into `removed`, one word per thread: independent, coalesced loads;
//       c. meanwhile the next stripe's diagonal words arrive by cp.async.
//     It stops at max_out kept boxes, the early exit of
//     nms_pallas.py:186-201.  Invalid boxes are never kept and so never
//     suppress.
//
// What bounds it on the card: pass 1 is N^2/2 predicate evaluations per
// image and writes the B * N * ceil(N/64) * 8-byte mask (144 MB at B = 8,
// N = 12000, beyond the 50 MB L2).  Pass 2 reads, for each kept box, its
// row's later words; per stripe it waits about one memory latency for the
// diagonal words (hidden by the prefetch) and one or two for the ORs, so
// its time is ~2 latencies per stripe, with the B images side by side on B
// SMs.
//
// Sorting and the map back to input indices stay outside, in PyTorch, as in
// the JAX code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kReduceThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// the (row block, column block) of the t-th upper-triangle pair, row-major:
// row r holds column blocks r .. cb-1 and starts at r*cb - r*(r-1)/2
__device__ __forceinline__ void triangle_pair(int t, int cb, int* row, int* col) {
  const double b = 2.0 * cb + 1.0;
  int r = static_cast<int>((b - sqrt(b * b - 8.0 * t)) * 0.5);
  r = max(0, min(r, cb - 1));
  while (r > 0 && (long long)r * cb - (long long)r * (r - 1) / 2 > t) --r;
  while (r + 1 < cb && (long long)(r + 1) * cb - (long long)(r + 1) * r / 2 <= t) ++r;
  *row = r;
  *col = r + (t - (r * cb - r * (r - 1) / 2));
}

// The column block's boxes sit in shared memory as one 16-byte and one
// 8-byte word each, so that a thread reads a candidate in two loads.
template <bool kGroups>
__global__ void trcnn_nms_mask_kernel(const float* __restrict__ boxes_all,
                                      const int* __restrict__ groups_all, int n,
                                      int col_blocks, float t,
                                      unsigned long long* __restrict__ mask_all) {
  int row_block, col_block;
  triangle_pair(blockIdx.x, col_blocks, &row_block, &col_block);
  const size_t img = blockIdx.y;
  const float4* boxes = reinterpret_cast<const float4*>(boxes_all + img * n * 4);
  const int* groups = kGroups ? groups_all + img * n : nullptr;
  unsigned long long* mask = mask_all + img * n * col_blocks;

  __shared__ float4 sbox[kBlock];
  __shared__ float2 sext[kBlock];   // t * area, group id (as float bits)

  const float one_plus_t = __fadd_rn(1.0f, t);
  const int tid = threadIdx.x;
  const int col_start = col_block * kBlock;
  const int col_size = min(n - col_start, kBlock);
  if (tid < col_size) {
    const float4 b = boxes[col_start + tid];
    sbox[tid] = b;
    sext[tid] = make_float2(__fmul_rn(t, area_of(b.x, b.y, b.z, b.w)),
                            __int_as_float(kGroups ? groups[col_start + tid] : 0));
  }
  __syncthreads();

  const int i = row_block * kBlock + tid;
  if (i >= n) return;
  const float4 b = boxes[i];
  const float ta = __fmul_rn(t, area_of(b.x, b.y, b.z, b.w));
  const int g = kGroups ? groups[i] : 0;

  unsigned long long bits = 0ULL;
  const int start = (col_block == row_block) ? tid + 1 : 0;
  for (int j = start; j < col_size; ++j) {
    const float4 o = sbox[j];
    const float2 e = sext[j];
    if (kGroups && __float_as_int(e.y) != g) continue;
    const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(b.z, o.z), fmaxf(b.x, o.x)), 1.0f), 0.0f);
    const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(b.w, o.w), fmaxf(b.y, o.y)), 1.0f), 0.0f);
    const float inter = __fmul_rn(w, h);
    if (__fmul_rn(inter, one_plus_t) > __fadd_rn(ta, e.x)) bits |= 1ULL << j;
  }
  mask[(size_t)i * col_blocks + col_block] = bits;
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// the diagonal words of stripe blk (row blk*64 + k, column block blk)
__device__ __forceinline__ void prefetch_diag(const unsigned long long* mask, int n,
                                              int col_blocks, int blk,
                                              unsigned long long* sdiag) {
  const int k = threadIdx.x;
  const int i = blk * kBlock + k;
  if (k < kBlock && i < n) cp_async_8(sdiag + k, mask + (size_t)i * col_blocks + blk);
}

__global__ void __launch_bounds__(kReduceThreads)
trcnn_nms_reduce_kernel(const unsigned long long* __restrict__ mask_all,
                        const unsigned char* __restrict__ valid_all, int n,
                        int col_blocks, int max_out, int* __restrict__ keep_pos_all,
                        int* __restrict__ num_kept) {
  extern __shared__ unsigned long long removed[];   // [col_blocks]
  __shared__ unsigned long long sdiag[2][kBlock];
  __shared__ int klist[kBlock];
  __shared__ int s_nk, s_count;

  const size_t img = blockIdx.x;
  const unsigned long long* mask = mask_all + img * n * col_blocks;
  const unsigned char* valid = valid_all + img * n;
  int* keep_pos = keep_pos_all + img * max_out;
  const int tid = threadIdx.x;

  // invalid boxes and the tail past n start out removed
  for (int w = tid; w < col_blocks; w += kReduceThreads) {
    unsigned long long bits = 0ULL;
    for (int k = 0; k < kBlock; ++k) {
      const int i = w * kBlock + k;
      if (i >= n || !valid[i]) bits |= 1ULL << k;
    }
    removed[w] = bits;
  }
  if (tid == 0) s_count = 0;
  if (col_blocks > 0) prefetch_diag(mask, n, col_blocks, 0, sdiag[0]);

  for (int blk = 0; blk < col_blocks; ++blk) {
    cp_async_commit_wait_all();
    __syncthreads();  // this stripe's diagonal and removed[blk] are complete
    if (tid == 0) {
      // a. the stripe's greedy decisions, over the boxes still standing
      const unsigned long long* diag = sdiag[blk & 1];
      unsigned long long cur = removed[blk];
      int count = s_count, nk = 0;
      unsigned long long open = ~cur;
      while (open != 0ULL && count < max_out) {
        const int k = __ffsll(static_cast<long long>(open)) - 1;
        keep_pos[count++] = blk * kBlock + k;
        klist[nk++] = blk * kBlock + k;
        cur |= diag[k];
        open = ~cur & (~0ULL << k << 1);
      }
      s_nk = nk;
      s_count = count;
    }
    __syncthreads();
    const int nk = s_nk;
    if (s_count >= max_out) break;
    // c. the next stripe's diagonal, in flight during b
    if (blk + 1 < col_blocks) prefetch_diag(mask, n, col_blocks, blk + 1, sdiag[(blk + 1) & 1]);
    // b. the kept rows' later words
    for (int w = blk + 1 + tid; w < col_blocks; w += kReduceThreads) {
      unsigned long long acc = 0ULL;
      int j = 0;
      for (; j + kUnroll <= nk; j += kUnroll) {
        unsigned long long v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = mask[(size_t)klist[j + u] * col_blocks + w];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc |= v[u];
      }
      for (; j < nk; ++j) acc |= mask[(size_t)klist[j] * col_blocks + w];
      removed[w] |= acc;
    }
  }
  cp_async_commit_wait_all();  // no copy outlives the block
  __syncthreads();
  const int count = s_count;
  for (int k = count + tid; k < max_out; k += kReduceThreads) keep_pos[k] = 0;
  if (tid == 0) num_kept[img] = count;
}

}  // namespace

// boxes (B, n, 4) float32, each image's boxes in score order; groups (B, n)
// int32 or null; valid (B, n) bool; mask (B, n, ceil(n/64)) uint64 scratch;
// keep_pos (B, max_out) int32 and num_kept (B,) int32 outputs.
extern "C" cudaError_t trcnn_nms(const float* boxes, const int* groups,
                                 const unsigned char* valid, int batch, int n,
                                 float iou_thresh, int max_out, unsigned long long* mask,
                                 int* keep_pos, int* num_kept, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  const int col_blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    const long long pairs = (long long)col_blocks * (col_blocks + 1) / 2;
    if (pairs > 0x7fffffffLL || batch > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(pairs), batch);
    if (groups)
      trcnn_nms_mask_kernel<true><<<grid, kBlock, 0, stream>>>(boxes, groups, n, col_blocks,
                                                              iou_thresh, mask);
    else
      trcnn_nms_mask_kernel<false><<<grid, kBlock, 0, stream>>>(boxes, groups, n, col_blocks,
                                                               iou_thresh, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int smem = col_blocks * static_cast<int>(sizeof(unsigned long long));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trcnn_nms_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  trcnn_nms_reduce_kernel<<<batch, kReduceThreads, smem, stream>>>(
      mask, valid, n, col_blocks, max_out, keep_pos, num_kept);
  return cudaGetLastError();
}
