// K7: ResNet-101's FrozenBN epilogue in one pass over a channels-last
// tensor: y = x * inv + shift, then (optionally) the residual add, then
// (optionally) the ReLU, in float32 or bfloat16.
//
// Replaces no Pallas kernel: the JAX package writes FrozenBN, the residual
// add and the ReLU as elementwise operations (trcnn/models/resnet.py:46-48,
// 70-80) that XLA fuses into one pass after each convolution.  Eager
// PyTorch runs each as a pass of its own over the convolution's output,
// about ten a bottleneck (the fold's small launches, the multiply, the add,
// the ReLUs, the residual add), and on channels-last tensors the (1, C, 1,
// 1) operands take TensorIterator's non-vectorised strided kernel.  K7 is
// the fusion XLA did.  The spec is
// trcnn_torch/ops/frozen_bn.py:frozen_bn_plain.
//
// Forms (the template's kForm): 0 bn(x); 1 bn(x) + residual; 2 bn(x) +
// bn_p(p), the projecting block's shortcut FrozenBN applied in the same
// pass, so its output is never written.  Each is followed by the ReLU; form
// 0 also runs without it (the bare affine, FrozenBatchNorm.forward).
//
// Arithmetic, identical to the plain version's operation by operation: the
// fold in float32, std = sqrt(var + eps), inv = scale / std, shift = bias -
// mean * inv, inv and shift each rounded to x's dtype; then x * inv rounded,
// + shift rounded, (+ the shortcut rounded), the ReLU.  Every step is an
// explicit __fsqrt_rn / __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts none of them into an FMA, and the build does not pass
// --use_fast_math.  A bfloat16 result is the float32 result rounded to
// nearest even (__float2bfloat16_rn), as PyTorch rounds each operation's
// float32 result.  The ReLU keeps a NaN, as torch.relu does.
//
// What bounds it on the card: bytes.  It does a few operations an element
// against 16-24 bytes moved in float32 (8-12 in bfloat16): x read once,
// the residual or p read once, the output written once, at 3.35 TB/s.
//
// Design: the tensor is (rows, C) with C contiguous and a multiple of 8;
// each thread moves 16-byte vectors along C (8 bfloat16 or 4 float32
// channels).  The grid strides over the vectors with a stride that is a
// multiple of the C / V vectors of a row, so a thread's channels never
// change: it folds its V channels once, into registers, and keeps them in
// x's dtype for the whole loop.  No shared memory, no barriers, no atomics,
// no scratch.  Each loop iteration issues its two items' loads before
// either's arithmetic, so each thread keeps up to four 16-byte loads in
// flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a float32 result rounded to T, as PyTorch rounds each operation's result
template <typename T>
__device__ __forceinline__ float rnd(float v) { return widen(narrow<T>(v)); }

// the channels of one 16-byte vector
template <typename T>
struct Lanes {
  static constexpr int V = 16 / sizeof(T);
};

template <typename T>
union Vec {
  uint4 u;
  T t[Lanes<T>::V];
};

// inv and shift of V channels from c, each rounded to T
template <typename T>
__device__ __forceinline__ void fold(const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ var, float eps, int c,
                                     Vec<T>& inv, Vec<T>& shift) {
#pragma unroll
  for (int k = 0; k < Lanes<T>::V; ++k) {
    const float sd = __fsqrt_rn(__fadd_rn(var[c + k], eps));
    const float i = __fdiv_rn(scale[c + k], sd);
    inv.t[k] = narrow<T>(i);
    shift.t[k] = narrow<T>(__fsub_rn(bias[c + k], __fmul_rn(mean[c + k], i)));
  }
}

template <typename T, int kForm, bool kRelu>
__device__ __forceinline__ uint4 epilogue(const Vec<T>& xv, const Vec<T>& sv,
                                          const Vec<T>& inv, const Vec<T>& shift,
                                          const Vec<T>& pinv, const Vec<T>& pshift) {
  Vec<T> o;
#pragma unroll
  for (int k = 0; k < Lanes<T>::V; ++k) {
    float y = rnd<T>(__fmul_rn(widen(xv.t[k]), widen(inv.t[k])));
    y = rnd<T>(__fadd_rn(y, widen(shift.t[k])));
    if (kForm == 1) {
      y = rnd<T>(__fadd_rn(y, widen(sv.t[k])));
    } else if (kForm == 2) {
      float q = rnd<T>(__fmul_rn(widen(sv.t[k]), widen(pinv.t[k])));
      q = rnd<T>(__fadd_rn(q, widen(pshift.t[k])));
      y = rnd<T>(__fadd_rn(y, q));
    }
    if (kRelu) y = (y > 0.f || y != y) ? y : 0.f;
    o.t[k] = narrow<T>(y);
  }
  return o.u;
}

// x, side (the residual or p; unused in form 0) and out: (n_vec, V) dense
template <typename T, int kForm, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_kernel(const T* __restrict__ x, const T* __restrict__ side,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ var, float eps,
                     const float* __restrict__ p_scale, const float* __restrict__ p_bias,
                     const float* __restrict__ p_mean, const float* __restrict__ p_var,
                     float p_eps, long long n_vec, int row_vecs, T* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_vec) return;
  const long long stride = (long long)gridDim.x * kThreads;  // a multiple of row_vecs
  const int c = (int)(tid % row_vecs) * Lanes<T>::V;
  Vec<T> inv, shift, pinv, pshift;
  fold(scale, bias, mean, var, eps, c, inv, shift);
  if (kForm == 2) fold(p_scale, p_bias, p_mean, p_var, p_eps, c, pinv, pshift);
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  const uint4* ss = reinterpret_cast<const uint4*>(side);
  uint4* os = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < n_vec; i += 2 * stride) {
    const long long j = i + stride;
    const bool two = j < n_vec;
    Vec<T> xa, xb, sa, sb;
    xa.u = __ldg(xs + i);
    if (kForm) sa.u = __ldg(ss + i);
    if (two) {
      xb.u = __ldg(xs + j);
      if (kForm) sb.u = __ldg(ss + j);
    }
    os[i] = epilogue<T, kForm, kRelu>(xa, sa, inv, shift, pinv, pshift);
    if (two) os[j] = epilogue<T, kForm, kRelu>(xb, sb, inv, shift, pinv, pshift);
  }
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kForm, bool kRelu>
int launch(const void* x, const void* side, const float* scale, const float* bias,
           const float* mean, const float* var, float eps, const float* p_scale,
           const float* p_bias, const float* p_mean, const float* p_var, float p_eps,
           long long rows, int c, int sms, void* out, cudaStream_t stream) {
  const auto kernel = frozen_bn_kernel<T, kForm, kRelu>;
  // the blocks resident at once, looked up once per instance
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const int row_vecs = c / Lanes<T>::V;
  const long long n_vec = rows * row_vecs;
  // two vectors a thread at least, no more blocks than are resident, and a
  // whole number of rows' vectors per grid stride
  long long blocks = (n_vec + 2LL * kThreads - 1) / (2LL * kThreads);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  const long long m = row_vecs / gcd(row_vecs, kThreads);
  blocks = (blocks + m - 1) / m * m;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(side), scale, bias, mean, var, eps,
      p_scale, p_bias, p_mean, p_var, p_eps, n_vec, row_vecs, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int form, int relu, const void* x, const void* side, const float* scale,
             const float* bias, const float* mean, const float* var, float eps,
             const float* p_scale, const float* p_bias, const float* p_mean,
             const float* p_var, float p_eps, long long rows, int c, int sms, void* out,
             cudaStream_t stream) {
#define TRCNN_FBN(F, R)                                                                   \
  return launch<T, F, R>(x, side, scale, bias, mean, var, eps, p_scale, p_bias, p_mean,  \
                         p_var, p_eps, rows, c, sms, out, stream)
  if (!relu) {
    if (form != 0) return cudaErrorInvalidValue;
    TRCNN_FBN(0, false);
  }
  if (form == 0) TRCNN_FBN(0, true);
  if (form == 1) TRCNN_FBN(1, true);
  TRCNN_FBN(2, true);
#undef TRCNN_FBN
}

}  // namespace

// x, side and out: contiguous (rows, c) of dtype (0 float32, 1 bfloat16),
// 16-byte aligned, c a multiple of 8; side is the residual (form 1) or p
// (form 2); the leaves: float32 (c,); relu 0 only with form 0.  sms: the
// device's multiprocessors.
extern "C" int trcnn_frozen_bn(const void* x, const void* side, const float* scale,
                               const float* bias, const float* mean, const float* var,
                               float eps, const float* p_scale, const float* p_bias,
                               const float* p_mean, const float* p_var, float p_eps,
                               long long rows, int c, int dtype, int form, int relu, int sms,
                               void* out, void* stream) {
  if (rows <= 0) return 0;
  if (c <= 0 || c % 8 != 0 || form < 0 || form > 2 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(form, relu, x, side, scale, bias, mean, var, eps, p_scale,
                                   p_bias, p_mean, p_var, p_eps, rows, c, sms, out, s);
  return dispatch<float>(form, relu, x, side, scale, bias, mean, var, eps, p_scale, p_bias,
                         p_mean, p_var, p_eps, rows, c, sms, out, s);
}
