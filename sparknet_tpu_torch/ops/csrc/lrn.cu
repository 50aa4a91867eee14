// Caffe ACROSS_CHANNELS LRN forward, with an optional ReLU folded in front,
// for Hopper (sm_90a): the inference form and the training form that also
// stores the `scale` residual.
//
// Replaces two TPU kernels of sparknet_tpu/ops/pallas_kernels.py:
// `_lrn_infer_kernel` (:72-80), the primal of `relu_lrn_across_channels`
// and of `lrn_across_channels` (:128-149, :177), and `_lrn_fwd_kernel`
// (:56-69), the forward of that function's custom VJP (`_fwd_call`
// :111-125 via `_lrn_vjp_fwd` :152).  It computes what they compute, per
// image n, channel c and position p:
//
//   a        = relu ? max(x, 0) : x
//   scale[c] = k + (alpha/size) * sum_{d = c-pre .. c+post} a[d]^2
//   y[c]     = a[c] * scale[c]^-beta
//
// with the window zero-padded, pre = (size-1)/2, post = size-1-pre, and the
// math in f32 whatever the I/O type (f32 or bf16).  The training form also
// writes scale, in the I/O type, as `_lrn_fwd_kernel` does; y is computed
// from the unrounded f32 scale in both forms, so they write the same y.
// The window is summed in ascending channel order, as the TPU kernel's
// shifted adds sum it, and square, sum and scale are rounded one by one
// (no contraction into an FMA), so the f32 result agrees with the plain
// PyTorch version to a few ulps (the powf may differ).
//
// Its bound is memory: it reads each input element once from device
// memory and writes each output once (y, and scale in the training form);
// its 2*size + 4 f32 operations per element are far below the card's f32
// rate.  Design: one thread per (image, position) and chunk of kChunk
// channels.  The thread issues all of its chunk's loads at once, the
// chunk and its halo of size - 1 channels, into a register array
// (compile-time chunk and size, fully unrolled), so it waits on device
// memory about once per chunk, not once per channel; each channel's window
// sum is then recomputed from registers in ascending channel order.  Out-
// of-range channels load as 0, and adding 0 leaves the sum's bits as they
// were.  Positions are flattened over (n, p), so the 32 threads of a warp
// read 32 neighbouring addresses of one channel plane (the (N, C, H*W)
// layout's contiguous axis) and a small plane still fills its warps; the
// grid is (ceil(N*HW / kThreads), ceil(C / kChunk)), with no limit on the
// batch below N*HW < 2^31.  The chunk, 4 or 8, comes from Python by
// shape (ops/cuda_kernels.py::lrn_plan): 4 at small batches, so that they
// still spread over the card, 8 at large ones, where the halo's reloads
// cost (longer chunks measured no faster on CaffeNet's norms).  Sizes 3, 4 and 5 are instantiated; another size takes a
// generic form that walks its window with a runtime loop.  Offsets are
// 64-bit.  Each entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "common.cuh"

namespace {

using sparknet::relu_of;
using sparknet::store;
using sparknet::to_f32;

constexpr int kThreads = 128;

template <typename T, bool kWithScale>
__device__ __forceinline__ void write_out(T* y, T* scale_out, int64_t at,
                                          float a, float sum, float coef,
                                          float neg_beta, float k) {
  const float scale = __fadd_rn(k, __fmul_rn(coef, sum));
  store(y + at, __fmul_rn(a, powf(scale, neg_beta)));
  if constexpr (kWithScale) store(scale_out + at, scale);
}

template <typename T, bool kWithScale, int kSize, int kChunk>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale_out, int C, int HW, int positions,
               float coef, float neg_beta, float k, int relu) {
  constexpr int kPre = (kSize - 1) / 2;
  constexpr int kSpan = kChunk + kSize - 1;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= positions) return;
  const int n = q / HW;
  const int64_t base = (int64_t)n * C * HW + (q - n * HW);
  const int c0 = blockIdx.y * kChunk;
  const T* xs = x + base;
  float a[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const int c = c0 - kPre + j;
    const float v = c >= 0 && c < C ? to_f32(xs[(int64_t)c * HW]) : 0.f;
    a[j] = relu ? relu_of(v) : v;
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (c0 + j >= C) break;
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < kSize; ++d)
      sum = __fadd_rn(sum, __fmul_rn(a[j + d], a[j + d]));
    write_out<T, kWithScale>(y, scale_out, base + (int64_t)(c0 + j) * HW,
                             a[j + kPre], sum, coef, neg_beta, k);
  }
}

// any window size: the same arithmetic, the window walked by a loop
template <typename T, bool kWithScale>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_generic_kernel(const T* __restrict__ x, T* __restrict__ y,
                       T* __restrict__ scale_out, int C, int HW,
                       int positions, int chunk, int pre, int post,
                       float coef, float neg_beta, float k, int relu) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= positions) return;
  const int n = q / HW;
  const int64_t base = (int64_t)n * C * HW + (q - n * HW);
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(c_begin + chunk, C);
  const T* xs = x + base;
  for (int c = c_begin; c < c_end; ++c) {
    float sum = 0.f;
    for (int d = max(c - pre, 0); d <= min(c + post, C - 1); ++d) {
      float v = to_f32(xs[(int64_t)d * HW]);
      if (relu) v = relu_of(v);
      sum = __fadd_rn(sum, __fmul_rn(v, v));
    }
    float a = to_f32(xs[(int64_t)c * HW]);
    if (relu) a = relu_of(a);
    write_out<T, kWithScale>(y, scale_out, base + (int64_t)c * HW, a, sum,
                             coef, neg_beta, k);
  }
}

struct Args {
  const void* x;
  void* y;
  void* scale;
  int c, hw, positions, chunk, size;
  float coef, neg_beta, k;
  int relu;
  dim3 grid;
  cudaStream_t s;
};

template <typename T, bool kWithScale, int kSize, int kChunk>
void launch_sized(const Args& a) {
  lrn_fwd_kernel<T, kWithScale, kSize, kChunk><<<a.grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y),
      static_cast<T*>(a.scale), a.c, a.hw, a.positions, a.coef, a.neg_beta,
      a.k, a.relu);
}

template <typename T, bool kWithScale, int kSize>
int launch_chunk(const Args& a) {
  switch (a.chunk) {
    case 4: launch_sized<T, kWithScale, kSize, 4>(a); break;
    case 8: launch_sized<T, kWithScale, kSize, 8>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kWithScale>
int launch_typed(const Args& a) {
  switch (a.size) {
    case 3: return launch_chunk<T, kWithScale, 3>(a);
    case 4: return launch_chunk<T, kWithScale, 4>(a);
    case 5: return launch_chunk<T, kWithScale, 5>(a);
    default: break;
  }
  const int pre = (a.size - 1) / 2;
  lrn_fwd_generic_kernel<T, kWithScale><<<a.grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y),
      static_cast<T*>(a.scale), a.c, a.hw, a.positions, a.chunk, pre,
      a.size - 1 - pre, a.coef, a.neg_beta, a.k, a.relu);
  return (int)cudaGetLastError();
}

template <bool kWithScale>
int launch(const void* x, void* y, void* scale, int n, int c, int hw,
           int size, float coef, float beta, float k, int relu, int bf16,
           int chunk, void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0) return 0;
  const int64_t positions = (int64_t)n * hw;
  const int64_t chunks = (c + (int64_t)chunk - 1) / chunk;
  if (size < 1 || chunk < 1 || positions > 0x7fffffff || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x, y, scale, c, hw, (int)positions, chunk, size, coef, -beta, k,
         relu, dim3((unsigned)((positions + kThreads - 1) / kThreads),
                    (unsigned)chunks),
         static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_typed<__nv_bfloat16, kWithScale>(a)
              : launch_typed<float, kWithScale>(a);
}

}  // namespace

// x, y: contiguous (n, c, hw) tensors of one dtype (bf16 != 0: bf16, else
// f32).  coef = alpha / size, rounded to f32 by the caller.  chunk:
// channels per thread, 4 or 8 (any >= 1 for a size other than 3, 4, 5).
extern "C" int sparknet_lrn_across_channels(const void* x, void* y, int n,
                                            int c, int hw, int size,
                                            float coef, float beta, float k,
                                            int relu, int bf16, int chunk,
                                            void* stream) {
  return launch<false>(x, y, nullptr, n, c, hw, size, coef, beta, k, relu,
                       bf16, chunk, stream);
}

// The training form: as above, and scale, a third contiguous (n, c, hw)
// tensor of the same dtype, receives k + coef * window sum.
extern "C" int sparknet_lrn_across_channels_fwd(const void* x, void* y,
                                                void* scale, int n, int c,
                                                int hw, int size, float coef,
                                                float beta, float k, int relu,
                                                int bf16, int chunk,
                                                void* stream) {
  return launch<true>(x, y, scale, n, c, hw, size, coef, beta, k, relu, bf16,
                      chunk, stream);
}
