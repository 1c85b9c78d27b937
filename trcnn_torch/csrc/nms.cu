// K1: exact greedy NMS over score-sorted boxes, "+1" pixel convention.
//
// Replaces: trcnn/ops/nms_pallas.py:nms_padded_pallas (_suppression_kernel),
// the TPU kernel that solves each 256-box tile's greedy order by a Jacobi
// fixpoint.  This is the bitmask design of the reference's CUDA NMS instead:
//
//   pass 1 (trcnn_nms_mask_kernel): one 64-thread block per (row block,
//     column block >= row block); thread i writes the 64-bit mask of the
//     later boxes j of the column block that it would suppress:
//     inter*(1+t) > t*area_i + t*area_j, evaluated with __fmul_rn /
//     __fadd_rn so that no multiply-add is contracted (the JAX predicate,
//     trcnn/ops/boxes.py:box_overlap_gt).  With groups, only same-group
//     pairs count.
//   pass 2 (trcnn_nms_reduce_kernel): one warp walks the boxes in score
//     order with a `removed` bitmask in shared memory.  A box is kept if it
//     is valid and not removed; a kept box ORs its mask row into `removed`.
//     It writes the first max_out kept positions and stops there, the early
//     exit of nms_pallas.py:186-201.  Invalid boxes are never kept and so
//     never suppress.
//
// What bounds it on the card: pass 1 is N^2/2 predicate evaluations (18M at
// N = 6000, a few microseconds of ALU work spread over ~4.5k blocks).  Pass 2
// is one warp and serial in the kept boxes: each kept box waits for its mask
// row (ceil(N/64) words) from L2, so its time is ~max_out memory latencies.
// The mask is N * ceil(N/64) * 8 bytes: 4.5 MB at N = 6000, 18 MB at 12000,
// which sit in the 50 MB L2.  The COCO epilogue (80 classes x 1000 RoIs =
// 80,000 boxes) would need 800 MB; that shape is not solved here.
//
// Sorting and the map back to input indices stay outside, in PyTorch, as in
// the JAX code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__global__ void trcnn_nms_mask_kernel(const float* __restrict__ boxes,
                                      const int* __restrict__ groups, int n,
                                      int col_blocks, float t,
                                      unsigned long long* __restrict__ mask) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;

  __shared__ float sx1[kBlock], sy1[kBlock], sx2[kBlock], sy2[kBlock];
  __shared__ float sta[kBlock];
  __shared__ int sg[kBlock];

  const float one_plus_t = __fadd_rn(1.0f, t);
  const int tid = threadIdx.x;
  const int col_start = col_block * kBlock;
  const int col_size = min(n - col_start, kBlock);
  if (tid < col_size) {
    const float* b = boxes + 4 * (col_start + tid);
    sx1[tid] = b[0];
    sy1[tid] = b[1];
    sx2[tid] = b[2];
    sy2[tid] = b[3];
    sta[tid] = __fmul_rn(t, area_of(b[0], b[1], b[2], b[3]));
    sg[tid] = groups ? groups[col_start + tid] : 0;
  }
  __syncthreads();

  const int i = row_block * kBlock + tid;
  if (i >= n) return;
  const float* b = boxes + 4 * i;
  const float x1 = b[0], y1 = b[1], x2 = b[2], y2 = b[3];
  const float ta = __fmul_rn(t, area_of(x1, y1, x2, y2));
  const int g = groups ? groups[i] : 0;

  unsigned long long bits = 0ULL;
  const int start = (col_block == row_block) ? tid + 1 : 0;
  for (int j = start; j < col_size; ++j) {
    if (sg[j] != g) continue;
    const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(x2, sx2[j]), fmaxf(x1, sx1[j])), 1.0f), 0.0f);
    const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(y2, sy2[j]), fmaxf(y1, sy1[j])), 1.0f), 0.0f);
    const float inter = __fmul_rn(w, h);
    if (__fmul_rn(inter, one_plus_t) > __fadd_rn(ta, sta[j])) bits |= 1ULL << j;
  }
  mask[(size_t)i * col_blocks + col_block] = bits;
}

__global__ void trcnn_nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                        const unsigned char* __restrict__ valid,
                                        int n, int col_blocks, int max_out,
                                        int* __restrict__ keep_pos,
                                        int* __restrict__ num_kept) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;

  // invalid boxes and the tail past n start out removed
  for (int w = lane; w < col_blocks; w += 32) {
    unsigned long long bits = 0ULL;
    for (int k = 0; k < kBlock; ++k) {
      const int i = w * kBlock + k;
      if (i >= n || !valid[i]) bits |= 1ULL << k;
    }
    removed[w] = bits;
  }
  __syncwarp();

  int count = 0;
  for (int blk = 0; blk < col_blocks && count < max_out; ++blk) {
    unsigned long long cur = removed[blk];
    for (int k = 0; k < kBlock && count < max_out; ++k) {
      if ((cur >> k) & 1ULL) continue;
      const int i = blk * kBlock + k;
      if (lane == 0) keep_pos[count] = i;
      ++count;
      const unsigned long long* row = mask + (size_t)i * col_blocks;
      cur |= row[blk];
      for (int w = blk + 1 + lane; w < col_blocks; w += 32) removed[w] |= row[w];
    }
    // the next block's word was last written by another lane
    __syncwarp();
  }
  for (int k = count + lane; k < max_out; k += 32) keep_pos[k] = 0;
  if (lane == 0) *num_kept = count;
}

}  // namespace

// boxes (n, 4) float32 in score order; groups (n,) int32 or null; valid (n,)
// bool; mask (n, ceil(n/64)) uint64 scratch; keep_pos (max_out,) int32 and
// num_kept (1,) int32 outputs.
extern "C" cudaError_t trcnn_nms(const float* boxes, const int* groups,
                                 const unsigned char* valid, int n, float iou_thresh,
                                 int max_out, unsigned long long* mask, int* keep_pos,
                                 int* num_kept, cudaStream_t stream) {
  const int col_blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    const dim3 grid(col_blocks, col_blocks);
    trcnn_nms_mask_kernel<<<grid, kBlock, 0, stream>>>(boxes, groups, n, col_blocks,
                                                      iou_thresh, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  trcnn_nms_reduce_kernel<<<1, 32, col_blocks * sizeof(unsigned long long), stream>>>(
      mask, valid, n, col_blocks, max_out, keep_pos, num_kept);
  return cudaGetLastError();
}
