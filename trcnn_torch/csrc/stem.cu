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
// stem_pallas.py:stem_block1_reference), and the 2x2 pool takes the max of
// those values; the output is NHWC.
//
// bfloat16 (the serving and training dtype), tensor cores.  Persistent
// blocks of two warpgroups, one per SM; a tile is 8 x 64 conv1_2 outputs.
//   - w2 (576 x 64 bf16, 72 KB) is staged once per block in wgmma's 128-byte
//     swizzled K-major layout: conv1_2's B.
//   - The tile's input window (12 x 68 x 3) arrives by cp.async into one of
//     two buffers while the previous tile computes.
//   - conv1_1 runs on mma.sync (K = 27 padded to 32) with A gathered from
//     the window; bias, rounding and ReLU are applied in registers and the
//     result goes straight into the activation tile: 128-byte pixel rows
//     (64 channels), 16-byte chunks XOR-swizzled by the column pair.
//   - conv1_2 is an implicit GEMM on wgmma m64n64k16 (M = pixels, N = 64
//     channels, K = 9 taps x 64): A comes from registers, loaded by ldmatrix
//     from the activation tile, because a tap's one-pixel shift breaks the
//     8-row swizzle atom that a shared-memory A descriptor needs.  Each
//     warpgroup takes a pair of conv rows as two M tiles (even and odd row),
//     with each warp's M rows ordered so that an accumulator thread holds a
//     whole 2x2 pooling window; one ldmatrix of an activation row serves
//     both tiles (at neighbouring taps).
//   - The epilogue (bias, rounding, ReLU, pool) runs on the accumulators and
//     writes each pooled pixel's 64 channels straight to device memory.
//
// float32, CUDA cores (the tensor cores would round to TF32): a 256-thread
// block owns 8 x 16 conv1_2 outputs; conv1_1 is computed directly from a
// 12 x 20 x 3 input window; conv1_2 gives each thread one pixel x 32
// channels, with its weights staged 16 input channels at a time and read as
// float4 broadcasts.
//
// What bounds it on the card: conv1_2's 2.3e10 multiply-adds per 608x1024
// image.  On the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM at
// 700 W) that is 46 us at peak, and wgmma m64n64 reads as many bytes of
// shared memory per cycle as the tensor cores consume (A by ldmatrix, B by
// descriptor), so shared-memory bandwidth sits at the same line.  conv1_1
// (1.3x the pixels for the halo, 32/576 of the depth) and each tile's
// barriers come on top: conv1_1 and conv1_2 of one block do not overlap.
// On the CUDA cores (67 TFLOP/s f32) it is 0.7 ms at peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                  // conv1 channels
constexpr int kCin = 3;
constexpr int kThreads = 256;

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

// A tile is 8 x 64 conv1_2 outputs (4 x 32 pooled).  conv1_1 covers the
// tile plus a one-pixel halo, 10 x 66 pixels; the input window adds one
// more, 12 x 68 x 3.
constexpr int kTcY = 8, kTcX = 64;                  // conv1_2 outputs per tile
constexpr int kAH = kTcY + 2, kAW = kTcX + 2;       // conv1_1 tile: 10 x 66
constexpr int kIH = kTcY + 4, kIW = kTcX + 4;       // input window: 12 x 68
constexpr int kAPixBf = kAH * kAW;                // 660 conv1_1 pixels
constexpr int kAFrags = (kAPixBf + 15) / 16;      // 42 conv1_1 M fragments
constexpr int kK1 = 9 * kCin;                     // conv1_1 GEMM depth 27, padded to 32
constexpr int kW1Ld = 40;                         // bf16 row stride of w1 [co][k]
constexpr int kXinElems = kIH * kIW * kCin;       // 2448
constexpr int kWarps = kThreads / 32;
constexpr int kTapBytes = kC * 128;               // one tap of w2: 64 rows of 128 B
constexpr int kW2Bytes = 9 * kTapBytes;           // 73728
constexpr int kActBytes = kAPixBf * 128;          // 84480
constexpr int kW1Bytes = kC * kW1Ld * 2;          // 5120
constexpr int kXinBytes = (kXinElems * 2 + 15) / 16 * 16;   // 4896
constexpr int kBf16SmemBytes =
    1024 + kW2Bytes + kActBytes + kW1Bytes + 2 * kXinBytes + 2 * kC * 4;
static_assert(kTcX == 64 && kThreads == 256, "two warpgroups, 16 conv columns per warp");
static_assert(kTcY % 4 == 0, "each warpgroup takes whole row pairs");
static_assert(kW1Bytes % 16 == 0 && kActBytes % 16 == 0, "16-byte aligned regions");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// 4 bytes, or 4 zero bytes when !inside
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The input window of a tile, zero outside the image (conv1_1's SAME
// padding), by 4-byte cp.async: H and W are even and so is the window's
// first column, so each 4-byte piece lies wholly inside or outside.
__device__ __forceinline__ void fetch_window(const bf16* __restrict__ x, int H, int W,
                                             int n, int oy0, int ox0, bf16* xin) {
  constexpr int kRowWords = kIW * kCin / 2;       // 102
  const bf16* xb = x + (size_t)n * H * W * kCin;
  for (int i = threadIdx.x; i < kIH * kRowWords; i += kThreads) {
    const int r = i / kRowWords, c = i % kRowWords;
    const int gy = oy0 - 2 + r;
    const int gx = ox0 - 2 + (2 * c) / kCin;      // the piece's first pixel
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = inside ? xb + ((size_t)gy * W + ox0 - 2) * kCin + 2 * c : x;
    cp_async_4(xin + r * kIW * kCin + 2 * c, src, inside);
  }
}

// the byte offset of (conv1_1 pixel p at tile column ax, 16-byte chunk c) in
// the activation tile: 128-byte pixel rows, chunks XOR-swizzled by the
// column pair, so that the 8 rows of an ldmatrix (columns 2 apart) and of a
// store (consecutive columns, 2-way) spread over the banks
__device__ __forceinline__ int act_offset(int p, int ax, int c) {
  return p * 128 + ((c ^ ((ax >> 1) & 7)) << 4);
}

__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr) {
  // K-major, 128-byte swizzle: LBO unused (1), SBO 1024 B between 8-row atoms
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared memory through desc)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                unsigned long long desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// conv1_1 on mma.sync: M = the tile's 660 conv1_1 pixels in fragments of
// 16 (round-robin over the warps), K = 27 taps x channels padded to 32,
// N = 64.  A is gathered from the input window (an implicit im2col), B
// (w1) is read from shared memory.  Sums are rounded, biased and ReLU'd in
// registers and written straight into the activation tile; pixels outside
// the image are 0 (conv1_2's SAME padding).
__device__ __forceinline__ void conv1_1_tile(const bf16* xin, const bf16* w1s,
                                             const float* b1s, int H, int W, int oy0,
                                             int ox0, unsigned char* act) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's 8 values of k in each 16-deep block: 2t, 2t+1, 2t+8, 2t+9
  int koff[2][4];
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kb * 16 + 2 * t + (e & 1) + (e >> 1) * 8;
      const int tap = k / kCin, ci = k % kCin;
      koff[kb][e] = k < kK1 ? ((tap / 3) * kIW + tap % 3) * kCin + ci : -1;
    }
  unsigned bw[8][2][2];   // B fragments: n-tile, k-block, register
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bw[j][kb][h] = *reinterpret_cast<const unsigned*>(
            w1s + (8 * j + g) * kW1Ld + kb * 16 + h * 8 + 2 * t);
  const bf16 zero = __float2bfloat16_rn(0.0f);

  for (int mt = warp; mt < kAFrags; mt += kWarps) {
    int pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(mt * 16 + g + 8 * h, kAPixBf - 1);
      pix[h] = ((p / kAW) * kIW + p % kAW) * kCin;
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      bf16 v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[h][e] = koff[kb][e] >= 0 ? xin[pix[h] + koff[kb][e]] : zero;
      // a0: row g, k 2t..; a1: row g+8; a2: row g, k 2t+8..; a3: row g+8
      const unsigned a[4] = {pack_bf16(v[0][0], v[0][1]), pack_bf16(v[1][0], v[1][1]),
                             pack_bf16(v[0][2], v[0][3]), pack_bf16(v[1][2], v[1][3])};
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_m16n8k16(acc[j], a, bw[j][kb][0], bw[j][kb][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      if (p >= kAPixBf) continue;
      const int ay = p / kAW, ax = p % kAW;
      const int gy = oy0 - 1 + ay, gx = ox0 - 1 + ax;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = 8 * j + 2 * t;
        const float y0 = inside ? bias_relu<bf16>(acc[j][2 * h], b1s[co]) : 0.0f;
        const float y1 = inside ? bias_relu<bf16>(acc[j][2 * h + 1], b1s[co + 1]) : 0.0f;
        *reinterpret_cast<unsigned*>(act + act_offset(p, ax, j) + 4 * t) =
            pack_bf16(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      }
    }
  }
}

// conv1_2 + bias + ReLU + 2x2 pool for one row pair of the tile (conv rows
// 2*pair and 2*pair+1, 64 columns), on the calling warpgroup.
//
// Two M tiles of 64: the even row and the odd row.  Within each, warp q
// takes columns 16q..16q+15, its M row m < 8 at column 16q+2m and m >= 8 at
// 16q+2(m-8)+1, so that an accumulator thread's rows g and g+8 are a
// horizontal pair and, with the odd tile's, a whole 2x2 window.  K = 9 taps
// x 64 channels: A from the activation tile by ldmatrix (one load of act
// row `a`, shift dx serves the even tile at tap (a, dx) and the odd tile at
// tap (a-1, dx)), B = w2 resident in shared memory in wgmma's swizzled
// K-major layout.  One commit group per act row, two in flight.
__device__ __forceinline__ void conv1_2_pair(const unsigned char* act, unsigned w2_addr,
                                             const float* b2s, int pair, int n, int Hp,
                                             int Wp, int py0, int px0, bf16* __restrict__ out) {
  const int wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int m = lane % 16, hi = lane / 16;
  const int xm = 16 * wq + (m < 8 ? 2 * m : 2 * (m - 8) + 1);
  const unsigned act_addr = smem_u32(act);

  float d0[32], d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.0f;
  fence_acc(d0);
  fence_acc(d1);

  unsigned af[2][3][4][4];   // [group parity][dx][k16 block][register]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ay = 2 * pair + a;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int col = xm + dx;
      const int p = ay * kAW + col;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldmatrix_x4(af[a & 1][dx][kc], act_addr + act_offset(p, col, 2 * kc + hi));
    }
    wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (a <= 2)
          wgmma_m64n64k16(d0, af[a & 1][dx][kc],
                          wgmma_desc(w2_addr + (a * 3 + dx) * kTapBytes + kc * 32));
        if (a >= 1)
          wgmma_m64n64k16(d1, af[a & 1][dx][kc],
                          wgmma_desc(w2_addr + ((a - 1) * 3 + dx) * kTapBytes + kc * 32));
      }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(d0);
  fence_acc(d1);

  // the 2x2 window of pooled pixel (py0 + pair, px0 + 8*wq + g), channels
  // 8j + 2t and +1: rows g, g+8 of both tiles
  const int g = lane / 4, t = lane % 4;
  const int gy = py0 + pair, gx = px0 + 8 * wq + g;
  if (gy >= Hp || gx >= Wp) return;
  bf16* o = out + (((size_t)n * Hp + gy) * Wp + gx) * kC;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = 8 * j + 2 * t;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = b2s[co + e];
      v[e] = fmaxf(fmaxf(bias_relu<bf16>(d0[4 * j + e], b), bias_relu<bf16>(d0[4 * j + 2 + e], b)),
                   fmaxf(bias_relu<bf16>(d1[4 * j + e], b), bias_relu<bf16>(d1[4 * j + 2 + e], b)));
    }
    *reinterpret_cast<unsigned*>(o + co) =
        pack_bf16(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stem_bf16_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, int B, int H, int W,
                    bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // w2's swizzle atoms need 1024-byte alignment
  unsigned char* ptr = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* w2s = ptr;                                ptr += kW2Bytes;
  unsigned char* act = ptr;                                ptr += kActBytes;
  bf16* w1s = reinterpret_cast<bf16*>(ptr);                ptr += kW1Bytes;
  bf16* xin[2] = {reinterpret_cast<bf16*>(ptr),
                  reinterpret_cast<bf16*>(ptr + kXinBytes)};
  ptr += 2 * kXinBytes;
  float* b1s = reinterpret_cast<float*>(ptr);
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  const int Hp = H / 2, Wp = W / 2;
  const int tiles_x = (W + kTcX - 1) / kTcX;
  const int tiles_y = (H + kTcY - 1) / kTcY;
  const int tiles = B * tiles_x * tiles_y;
  auto tile_origin = [&](int tile, int* n, int* oy0, int* ox0) {
    *n = tile / (tiles_x * tiles_y);
    *oy0 = (tile / tiles_x) % tiles_y * kTcY;
    *ox0 = tile % tiles_x * kTcX;
  };

  int n, oy0, ox0;
  if (blockIdx.x < tiles) {
    tile_origin(blockIdx.x, &n, &oy0, &ox0);
    fetch_window(x, H, W, n, oy0, ox0, xin[0]);
  }
  cp_async_commit();

  // weights, once per block.  HWIO w2 is [tap][ci][co]: tap t's B is
  // 64 rows (co) of 128 bytes (ci), 16-byte chunks swizzled by co % 8
  for (int i = tid; i < 9 * kC * kC; i += kThreads) {
    const int tap = i / (kC * kC), ci = (i / kC) % kC, co = i % kC;
    *reinterpret_cast<bf16*>(w2s + tap * kTapBytes + co * 128 +
                             (((ci / 8) ^ (co % 8)) << 4) + (ci % 8) * 2) = w2[i];
  }
  for (int i = tid; i < kC * 32; i += kThreads) {
    const int co = i / 32, k = i % 32;
    w1s[co * kW1Ld + k] = k < kK1 ? w1[k * kC + co] : __float2bfloat16_rn(0.0f);
  }
  if (tid < kC) {
    b1s[tid] = to_f(b1[tid]);
    b2s[tid] = to_f(b2[tid]);
  }
  // w2 is read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const unsigned w2_addr = smem_u32(w2s);
  const int wg = tid / 128;

  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    tile_origin(tile, &n, &oy0, &ox0);
    cp_async_wait_all();
    __syncthreads();  // the window has landed; the last tile's conv1_2 is done with act
    if (tile + gridDim.x < tiles) {
      int nn, ny, nx;
      tile_origin(tile + gridDim.x, &nn, &ny, &nx);
      fetch_window(x, H, W, nn, ny, nx, xin[buf ^ 1]);
    }
    cp_async_commit();
    conv1_1_tile(xin[buf], w1s, b1s, H, W, oy0, ox0, act);
    __syncthreads();
#pragma unroll 1
    for (int pair = wg; pair < kTcY / 2; pair += 2)
      conv1_2_pair(act, w2_addr, b2s, pair, n, Hp, Wp, oy0 / 2, ox0 / 2, out);
  }
  cp_async_wait_all();
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
  const int smem = kBf16SmemBytes;
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
  const int tiles = B * ((W + kTcX - 1) / kTcX) * ((H + kTcY - 1) / kTcY);
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
