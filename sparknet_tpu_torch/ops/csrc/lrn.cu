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
// rate.  This simple design does not reach that bound: each thread's
// channel walk is a chain of dependent loads, so it is bound by latency
// (times in PERF.md).  Design: one thread per spatial position, so the 32
// threads of a warp read 32 neighbouring addresses of one channel plane
// (the (N, C, H*W) layout's contiguous axis).  Each thread walks a chunk
// of kChannels channels; the `size` reloads of each value for the
// overlapping windows hit L1.  The grid is (ceil(HW / kThreads),
// ceil(C / kChannels), N), so a batch-64 CaffeNet norm2 (HW = 169) still
// launches over a thousand blocks.  Offsets are 64-bit.  Each entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

using sparknet::relu_of;
using sparknet::store;
using sparknet::to_f32;

constexpr int kThreads = 128;
constexpr int kChannels = 32;

template <typename T, bool kWithScale>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
               T* __restrict__ scale_out, int C, int HW, int pre, int post,
               float coef, float neg_beta, float k, int relu) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int c_begin = blockIdx.y * kChannels;
  const int c_end = min(c_begin + kChannels, C);
  const int64_t base = (int64_t)blockIdx.z * C * HW + p;
  const T* xs = x + base;
  for (int c = c_begin; c < c_end; ++c) {
    const int lo = max(c - pre, 0);
    const int hi = min(c + post, C - 1);
    float sum = 0.f;
    for (int d = lo; d <= hi; ++d) {
      float v = to_f32(xs[(int64_t)d * HW]);
      if (relu) v = relu_of(v);
      sum = __fadd_rn(sum, __fmul_rn(v, v));
    }
    float a = to_f32(xs[(int64_t)c * HW]);
    if (relu) a = relu_of(a);
    const float scale = __fadd_rn(k, __fmul_rn(coef, sum));
    store(y + base + (int64_t)c * HW, __fmul_rn(a, powf(scale, neg_beta)));
    if constexpr (kWithScale)
      store(scale_out + base + (int64_t)c * HW, scale);
  }
}

template <bool kWithScale>
int launch(const void* x, void* y, void* scale, int n, int c, int hw,
           int size, float coef, float beta, float k, int relu, int bf16,
           void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0) return 0;
  if (size < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const int pre = (size - 1) / 2;
  const int post = size - 1 - pre;
  const dim3 grid((hw + kThreads - 1) / kThreads,
                  (c + kChannels - 1) / kChannels, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lrn_fwd_kernel<__nv_bfloat16, kWithScale><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(scale), c, hw, pre, post, coef, -beta, k,
        relu);
  } else {
    lrn_fwd_kernel<float, kWithScale><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<float*>(scale), c, hw, pre, post, coef, -beta, k, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: contiguous (n, c, hw) tensors of one dtype (bf16 != 0: bf16, else
// f32).  coef = alpha / size, rounded to f32 by the caller.
extern "C" int sparknet_lrn_across_channels(const void* x, void* y, int n,
                                            int c, int hw, int size,
                                            float coef, float beta, float k,
                                            int relu, int bf16,
                                            void* stream) {
  return launch<false>(x, y, nullptr, n, c, hw, size, coef, beta, k, relu,
                       bf16, stream);
}

// The training form: as above, and scale, a third contiguous (n, c, hw)
// tensor of the same dtype, receives k + coef * window sum.
extern "C" int sparknet_lrn_across_channels_fwd(const void* x, void* y,
                                                void* scale, int n, int c,
                                                int hw, int size, float coef,
                                                float beta, float k, int relu,
                                                int bf16, void* stream) {
  return launch<true>(x, y, scale, n, c, hw, size, coef, beta, k, relu, bf16,
                      stream);
}
