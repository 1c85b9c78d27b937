// K3: the fused VGG stem, conv1_1 (3->64, 3x3 SAME) + ReLU -> conv1_2
// (64->64, 3x3 SAME) + ReLU -> 2x2/2 max pool, forward only.
//
// Replaces: trcnn/ops/stem_pallas.py:fused_stem_block1 (_fused_impl ->
// _kernel), which packs two pixel columns into each 128-lane row so that
// the TPU's lanes are full.  Hopper has no such lane constraint; this is a
// direct convolution fused so that conv1_1's output never reaches device
// memory.
//
// Both kernels stage conv1_1's output for a tile of the image in shared
// memory (0 outside the image: conv1_2's SAME padding), then run conv1_2 on
// it.  Each convolution's sum is rounded to the compute dtype, then the bias
// is added and ReLU applied in that dtype (the rounding order of
// stem_pallas.py:stem_block1_reference); the 2x2 pool reads the results
// back from shared memory and writes NHWC.
//
// bfloat16 (the serving dtype), tensor cores: a tile is 16 x 16 conv1_2
// outputs.  conv1_1 is a GEMM over an im2col of the 27 taps (M = 18 x 18
// pixels, K = 27 padded to 32, N = 64); conv1_2 an implicit GEMM (M = 256
// pixels, K = 9 taps x 64 channels, N = 64) whose A fragments are strided
// views of conv1_1's (pixel, channel) array, so no im2col copy is made for
// it.  WMMA 16x16x16 bf16 fragments, float32 accumulators.  Each warp owns
// two tile rows of conv1_2 (two M fragments) and all 64 channels, so every
// B fragment serves twice.  Blocks are persistent, one per SM: the weights
// (74 KB for conv1_2) are staged once per block, which then walks over
// tiles.  Row strides of 80 bf16 (160 B) keep fragment pointers 32-byte
// aligned and spread rows over the banks.
//
// float32, CUDA cores (the tensor cores would round to TF32): a 256-thread
// block owns 8 x 16 conv1_2 outputs; conv1_1 is computed directly from a
// 12 x 20 x 3 input window; conv1_2 gives each thread one pixel x 32
// channels, with its weights staged 16 input channels at a time and read as
// float4 broadcasts.
//
// What bounds it on the card: conv1_2's 2.3e10 multiply-adds per 608x1024
// image.  On the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM at
// 700 W) that is 46 us at peak; this simple kernel has no load/compute
// overlap and one block of 8 warps per SM, so it runs far below that.  On
// the CUDA cores (67 TFLOP/s f32) it is 0.7 ms at peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                  // conv1 channels
constexpr int kCin = 3;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// round a float32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// conv sum rounded to T, + bias in T, ReLU in T (exact in float)
template <typename T>
__device__ __forceinline__ float bias_relu(float acc, float bias) {
  return fmaxf(round_to<T>(__fadd_rn(round_to<T>(acc), bias)), 0.0f);
}

// ------------------------------------------------------------ float32, CUDA cores

constexpr int kTy = 4, kTx = 8;         // pooled outputs per tile
constexpr int kOy = 2 * kTy, kOx = 2 * kTx;   // conv1_2 outputs: 8 x 16
constexpr int kAy = kOy + 2, kAx = kOx + 2;   // conv1_1 tile: 10 x 18
constexpr int kIy = kOy + 4, kIx = kOx + 4;   // input window: 12 x 20
constexpr int kPix = kOy * kOx;         // 128 conv1_2 pixels per tile
constexpr int kAPix = kAy * kAx;        // 180 conv1_1 pixels per tile
constexpr int kXinSize = kIy * kIx * kCin;    // 720
constexpr int kW1Size = 9 * kCin * kC;        // 1728
static_assert(kThreads == 2 * kPix, "f32: two 32-channel halves per pixel");

// The input window of the tile whose first conv1_2 output is (oy0, ox0).
__device__ __forceinline__ void stage_input(const float* __restrict__ xb, int H, int W,
                                            int oy0, int ox0, float* xin) {
  for (int i = threadIdx.x; i < kXinSize; i += kThreads) {
    const int ci = i % kCin;
    const int p = i / kCin;
    const int gy = oy0 - 2 + p / kIx;
    const int gx = ox0 - 2 + p % kIx;
    xin[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? xb[((size_t)gy * W + gx) * kCin + ci] : 0.0f;
  }
}

// conv1_1 at tile pixel p = ay * kAx + ax (image pixel (oy0-1+ay, ox0-1+ax)),
// channel co; 0 outside the image.
__device__ __forceinline__ float conv1_1_at(const float* xin, const float* w1s,
                                            const float* b1s, int H, int W, int oy0,
                                            int ox0, int p, int co) {
  const int ay = p / kAx, ax = p % kAx;
  const int gy = oy0 - 1 + ay, gx = ox0 - 1 + ax;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ci = 0; ci < kCin; ++ci)
        acc += xin[((ay + dy) * kIx + ax + dx) * kCin + ci] *
               w1s[((dy * 3 + dx) * kCin + ci) * kC + co];
  return bias_relu<float>(acc, b1s[co]);
}

constexpr int kCiChunk = 16;            // conv1_2 input channels staged at once
constexpr int kY2Stride = kPix + 1;     // padded: pool reads are conflict-free
constexpr int kActSize = kC * kAPix;    // 11520
constexpr int kW2Chunk = 9 * kCiChunk * kC;   // 9216 (>= kC * kY2Stride)
constexpr int kF32SmemFloats = kXinSize + kW1Size + 2 * kC + kActSize + kW2Chunk;
static_assert(kC * kY2Stride <= kW2Chunk, "y2 reuses the w2 stage");
static_assert((kXinSize + kW1Size + 2 * kC + kActSize) % 4 == 0, "w2 stage is float4-aligned");

__global__ void __launch_bounds__(kThreads)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int H, int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;                 // [kIy][kIx][kCin]
  float* w1s = xin + kXinSize;       // [tap][ci][co]
  float* b1s = w1s + kW1Size;
  float* b2s = b1s + kC;
  float* act = b2s + kC;             // [co][kAy][kAx]
  float* w2s = act + kActSize;       // [tap][cc][co], later y2 [co][kY2Stride]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * kOy;
  const int ox0 = blockIdx.x * kOx;

  stage_input(x + (size_t)n * H * W * kCin, H, W, oy0, ox0, xin);
  for (int i = tid; i < kW1Size; i += kThreads) w1s[i] = w1[i];
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  __syncthreads();

  // channel-major, so that neighbouring threads read neighbouring pixels
  for (int i = tid; i < kActSize; i += kThreads)
    act[i] = conv1_1_at(xin, w1s, b1s, H, W, oy0, ox0, i % kAPix, i / kAPix);

  // this thread's pixel (py, px) and output channels [c_half, +32)
  const int pix = tid % kPix;
  const int c_half = (tid / kPix) * 32;
  const int py = pix / kOx, px = pix % kOx;
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.0f;

  for (int c0 = 0; c0 < kC; c0 += kCiChunk) {
    __syncthreads();  // act is complete; the previous chunk's weights are consumed
    for (int i = tid; i < kW2Chunk; i += kThreads) {
      const int co = i % kC;
      const int cc = (i / kC) % kCiChunk;
      const int tap = i / (kC * kCiChunk);
      w2s[i] = w2[((size_t)tap * kC + c0 + cc) * kC + co];
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = act + (py + tap / 3) * kAx + px + tap % 3;
#pragma unroll 4
      for (int cc = 0; cc < kCiChunk; ++cc) {
        const float v = a[(c0 + cc) * kAPix];
        const float4* wv = reinterpret_cast<const float4*>(w2s + (tap * kCiChunk + cc) * kC + c_half);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 w = wv[q];
          acc[4 * q + 0] += v * w.x;
          acc[4 * q + 1] += v * w.y;
          acc[4 * q + 2] += v * w.z;
          acc[4 * q + 3] += v * w.w;
        }
      }
    }
  }
  __syncthreads();  // every thread is done with w2s

  float* y2 = w2s;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int co = c_half + q;
    y2[co * kY2Stride + pix] = bias_relu<float>(acc[q], b2s[co]);
  }
  __syncthreads();

  const int Hp = H / 2, Wp = W / 2;
  for (int i = tid; i < kTy * kTx * kC; i += kThreads) {
    const int co = i % kC;
    const int p = i / kC;
    const int ty = p / kTx, tx = p % kTx;
    const int gy = blockIdx.y * kTy + ty, gx = blockIdx.x * kTx + tx;
    if (gy < Hp && gx < Wp) {
      const float* yc = y2 + co * kY2Stride + (2 * ty) * kOx + 2 * tx;
      out[(((size_t)n * Hp + gy) * Wp + gx) * kC + co] =
          fmaxf(fmaxf(yc[0], yc[1]), fmaxf(yc[kOx], yc[kOx + 1]));
    }
  }
}

// ------------------------------------------------------- bfloat16, tensor cores

// A tensor-core tile is 16 x 16 conv1_2 outputs (8 x 8 pooled), so that each
// warp takes two tile rows and uses every B fragment twice.
constexpr int kTcO = 16;                // conv1_2 outputs per tile side
constexpr int kTcP = kTcO / 2;          // pooled outputs per tile side
constexpr int kTcA = kTcO + 2;          // conv1_1 tile side: 18
constexpr int kTcAPix = kTcA * kTcA;    // 324 conv1_1 pixels
constexpr int kTcAPixPad = 336;         // 21 M fragments of 16
constexpr int kK1 = 9 * kCin;           // conv1_1 GEMM depth 27, padded to 32
constexpr int kLd1 = 40;                // im2col row stride (80 B)
constexpr int kLd = 80;                 // bf16 row stride of act, w1, w2 (160 B)
constexpr int kYLd = kC + 4;            // f32 row stride of accumulator stages
constexpr int kK = 9 * kC;              // conv1_2 GEMM depth, 576
constexpr int kWarps = kThreads / 32;
constexpr size_t kW2Bytes = (size_t)kK * kLd * sizeof(bf16);             // 92160
constexpr size_t kW1Bytes = (size_t)32 * kLd * sizeof(bf16);             // 5120
constexpr size_t kA1Bytes = (size_t)kTcAPixPad * kLd1 * sizeof(bf16);    // 26880
constexpr size_t kActBytes = (size_t)kTcAPix * kLd * sizeof(bf16);       // 51840
constexpr size_t kStageBytes = (size_t)kWarps * 16 * kYLd * sizeof(float);  // 34816
constexpr size_t kY2Bytes = (size_t)kTcO * kTcO * kYLd * sizeof(float);      // 69632
constexpr size_t kTcSmemBytes =
    kW2Bytes + kW1Bytes + kA1Bytes + kActBytes + kStageBytes + 2 * kC * sizeof(float);
static_assert(kY2Bytes <= kActBytes + kStageBytes, "y2 reuses act and the stages");
static_assert(kW2Bytes % 128 == 0 && kW1Bytes % 128 == 0 && kA1Bytes % 128 == 0 &&
              kActBytes % 128 == 0 && kStageBytes % 128 == 0, "32-byte aligned regions");
static_assert(kTcAPixPad >= kTcAPix && kTcAPixPad % 16 == 0, "conv1_1 M padding");

__global__ void __launch_bounds__(kThreads)
stem_bf16_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, int B, int H, int W,
                    bf16* __restrict__ out) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ptr = smem_raw;
  bf16* w2h = reinterpret_cast<bf16*>(ptr);  ptr += kW2Bytes;     // [576][kLd]
  bf16* w1h = reinterpret_cast<bf16*>(ptr);  ptr += kW1Bytes;     // [32][kLd]
  bf16* a1 = reinterpret_cast<bf16*>(ptr);   ptr += kA1Bytes;     // im2col [336][kLd1]
  bf16* act = reinterpret_cast<bf16*>(ptr);  ptr += kActBytes;    // conv1_1 [324][kLd]
  float* stage = reinterpret_cast<float*>(ptr);  ptr += kStageBytes;  // [warp][16][kYLd]
  float* b1s = reinterpret_cast<float*>(ptr);
  float* b2s = b1s + kC;
  float* y2 = reinterpret_cast<float*>(act);  // [256][kYLd], once act is consumed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* my_stage = stage + warp * 16 * kYLd;

  // HWIO weights are (tap, ci) x co row-major: the GEMMs' B, staged once.
  // w1's rows 27..31 and im2col's pad rows and columns stay zero.
  for (int i = tid; i < kK * kC; i += kThreads) w2h[(i / kC) * kLd + i % kC] = w2[i];
  for (int i = tid; i < 32 * kC; i += kThreads)
    w1h[(i / kC) * kLd + i % kC] = i < kK1 * kC ? w1[i] : __float2bfloat16_rn(0.0f);
  for (int i = tid; i < kTcAPixPad * kLd1; i += kThreads) a1[i] = __float2bfloat16_rn(0.0f);
  if (tid < kC) {
    b1s[tid] = to_f(b1[tid]);
    b2s[tid] = to_f(b2[tid]);
  }

  const int Hp = H / 2, Wp = W / 2;
  const int tiles_x = (Wp + kTcP - 1) / kTcP;
  const int tiles_y = (Hp + kTcP - 1) / kTcP;
  const int tiles = B * tiles_x * tiles_y;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / (tiles_x * tiles_y);
    const int ty0 = (tile / tiles_x) % tiles_y * kTcP;   // first pooled row / col
    const int tx0 = tile % tiles_x * kTcP;
    const int oy0 = 2 * ty0, ox0 = 2 * tx0;
    const bf16* xb = x + (size_t)n * H * W * kCin;

    __syncthreads();  // the previous tile's pool has read y2; weights are staged
    // im2col for conv1_1: row p = conv1_1 pixel (oy0-1+ay, ox0-1+ax), column
    // k = (dy*3 + dx)*3 + ci, zero outside the image (SAME padding)
    for (int i = tid; i < kTcAPix * kK1; i += kThreads) {
      const int p = i / kK1, k = i % kK1;
      const int tap = k / kCin, ci = k % kCin;
      const int gy = oy0 - 2 + p / kTcA + tap / 3;
      const int gx = ox0 - 2 + p % kTcA + tap % 3;
      a1[p * kLd1 + k] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                             ? xb[((size_t)gy * W + gx) * kCin + ci]
                             : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();

    // conv1_1: M fragments round-robin over the warps; each goes through the
    // warp's f32 stage for rounding, bias and ReLU into act (bf16)
    for (int mt = warp; mt < kTcAPixPad / 16; mt += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c1[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(c1[nt], 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a1 + mt * 16 * kLd1 + k0, kLd1);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w1h + k0 * kLd + nt * 16, kLd);
          wmma::mma_sync(c1[nt], a, b, c1[nt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        wmma::store_matrix_sync(my_stage + nt * 16, c1[nt], kYLd, wmma::mem_row_major);
      __syncwarp();
      for (int j = lane; j < 16 * kC; j += 32) {
        const int r = j / kC, co = j % kC;
        const int p = mt * 16 + r;
        if (p < kTcAPix) {
          const int gy = oy0 - 1 + p / kTcA, gx = ox0 - 1 + p % kTcA;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          act[p * kLd + co] = __float2bfloat16_rn(
              inside ? bias_relu<bf16>(my_stage[r * kYLd + co], b1s[co]) : 0.0f);
        }
      }
      __syncwarp();  // the stage is read before the next fragment overwrites it
    }
    __syncthreads();

    // conv1_2: warp w owns tile rows w and w + 8 (two M fragments of 16
    // pixels) x 64 channels; each B fragment serves both
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(c[m][nt], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      // row i of A at this tap is conv1_1 pixel (row + dy, i + dx)
      const bf16* a_lo = act + ((warp + tap / 3) * kTcA + tap % 3) * kLd;
      const bf16* a_hi = a_lo + kWarps * kTcA * kLd;
#pragma unroll
      for (int c0 = 0; c0 < kC; c0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1f;
        wmma::load_matrix_sync(a0, a_lo + c0, kLd);
        wmma::load_matrix_sync(a1f, a_hi + c0, kLd);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w2h + (tap * kC + c0) * kLd + nt * 16, kLd);
          wmma::mma_sync(c[0][nt], a0, b, c[0][nt]);
          wmma::mma_sync(c[1][nt], a1f, b, c[1][nt]);
        }
      }
    }
    __syncthreads();  // every warp is done with act, which y2 overwrites
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        wmma::store_matrix_sync(y2 + (warp + m * kWarps) * kTcO * kYLd + nt * 16, c[m][nt],
                                kYLd, wmma::mem_row_major);
    __syncthreads();

    for (int i = tid; i < kTcP * kTcP * kC; i += kThreads) {
      const int co = i % kC;
      const int p = i / kC;
      const int ty = p / kTcP, tx = p % kTcP;
      const int gy = ty0 + ty, gx = tx0 + tx;
      if (gy < Hp && gx < Wp) {
        const float* yc = y2 + ((2 * ty) * kTcO + 2 * tx) * kYLd + co;
        const float b = b2s[co];
        const float m = fmaxf(fmaxf(bias_relu<bf16>(yc[0], b), bias_relu<bf16>(yc[kYLd], b)),
                              fmaxf(bias_relu<bf16>(yc[kTcO * kYLd], b),
                                    bias_relu<bf16>(yc[(kTcO + 1) * kYLd], b)));
        out[(((size_t)n * Hp + gy) * Wp + gx) * kC + co] = __float2bfloat16_rn(m);
      }
    }
  }
}

cudaError_t launch_f32(const float* x, const float* w1, const float* b1, const float* w2,
                       const float* b2, int B, int H, int W, float* out,
                       cudaStream_t stream) {
  const int smem = kF32SmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stem_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kTx - 1) / kTx, (H / 2 + kTy - 1) / kTy, B);
  stem_f32_kernel<<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, H, W, out);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                        const bf16* b2, int B, int H, int W, bf16* out,
                        cudaStream_t stream) {
  const int smem = static_cast<int>(kTcSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(stem_bf16_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_bf16_tc_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = B * ((W / 2 + kTcP - 1) / kTcP) * ((H / 2 + kTcP - 1) / kTcP);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  stem_bf16_tc_kernel<<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2, B, H, W, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, 3) NHWC, H and W even; w1 (3, 3, 3, 64) and w2 (3, 3, 64, 64)
// HWIO; b1, b2 (64,); all in the compute dtype, float32 (dtype 0) or
// bfloat16 (dtype 1).  out (B, H/2, W/2, 64).
extern "C" cudaError_t trcnn_stem_fwd(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, int B, int H, int W,
                                      int dtype, void* out, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), B, H, W, static_cast<float*>(out),
                      stream);
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                       static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                       static_cast<const bf16*>(b2), B, H, W, static_cast<bf16*>(out),
                       stream);
  return cudaErrorInvalidValue;
}
