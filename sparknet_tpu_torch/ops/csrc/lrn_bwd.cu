// Backward of Caffe's ACROSS_CHANNELS LRN, with an optional ReLU folded in
// front, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lrn_bwd_kernel` of
// sparknet_tpu/ops/pallas_kernels.py:83-102, reached through
// `_lrn_vjp_bwd` (:157-171), the backward of `relu_lrn_across_channels`'s
// custom VJP.  From the forward's input x, its residual `scale` and the
// output gradient dy, per image n, channel c and position p:
//
//   a     = relu ? max(x, 0) : x          (recomputed, not stored)
//   y[d]  = a[d] * scale[d]^-beta         (recomputed)
//   ratio = sum_{d = c-post .. c+pre} dy[d] * y[d] / scale[d]
//   dx[c] = dy[c] * scale[c]^-beta - (2*alpha*beta/size) * a[c] * ratio
//
// and, with relu, dx = 0 where x <= 0 (ties at 0 get no gradient, as
// relu_layer.cpp's backward).  The window of the sum is the forward's
// window reflected, (post, pre) in place of (pre, post), since channel d
// feeds channel c's gradient iff c lies in d's forward window; the two
// differ only at an even `size`.  The math is in f32 whatever the I/O type
// (f32 or bf16); the window is summed in ascending channel order with each
// step rounded, as the TPU kernel's shifted adds sum it.
//
// Its bound is memory: it reads x, scale and dy once each and writes dx
// once; its ~6*size + 8 f32 operations per element (with size + 1
// powf) are far below the card's f32 rate.  Design: the thread layout of
// the forward (csrc/lrn.cu): one thread per spatial position, coalesced
// along H*W, each walking a chunk of kChannels channels and recomputing
// y[d] for each window it meets (the reloads hit L1).  Simple before fast:
// each thread's walk is a chain of dependent loads, so it is bound by
// latency (times in PERF.md).  Offsets are 64-bit.  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

using sparknet::relu_of;
using sparknet::store;
using sparknet::to_f32;

constexpr int kThreads = 128;
constexpr int kChannels = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ dy, T* __restrict__ dx, int C, int HW,
               int pre, int post, float coef, float neg_beta, int relu) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int c_begin = blockIdx.y * kChannels;
  const int c_end = min(c_begin + kChannels, C);
  const int64_t base = (int64_t)blockIdx.z * C * HW + p;
  const T* xs = x + base;
  const T* ss = scale + base;
  const T* dys = dy + base;
  for (int c = c_begin; c < c_end; ++c) {
    const int lo = max(c - post, 0);  // the reflected window
    const int hi = min(c + pre, C - 1);
    float ratio = 0.f;
    for (int d = lo; d <= hi; ++d) {
      const int64_t o = (int64_t)d * HW;
      float a = to_f32(xs[o]);
      if (relu) a = relu_of(a);
      const float s = to_f32(ss[o]);
      const float y = __fmul_rn(a, powf(s, neg_beta));
      ratio = __fadd_rn(ratio, __fdiv_rn(__fmul_rn(to_f32(dys[o]), y), s));
    }
    const int64_t o = (int64_t)c * HW;
    const float xc = to_f32(xs[o]);
    const float a = relu ? relu_of(xc) : xc;
    const float s = to_f32(ss[o]);
    float da = __fsub_rn(__fmul_rn(to_f32(dys[o]), powf(s, neg_beta)),
                         __fmul_rn(__fmul_rn(coef, a), ratio));
    if (relu && !(xc > 0.f)) da = 0.f;
    store(dx + base + o, da);
  }
}

}  // namespace

// x, scale, dy, dx: contiguous (n, c, hw) tensors of one dtype (bf16 != 0:
// bf16, else f32).  coef = 2 * alpha * beta / size, rounded to f32 by the
// caller.
extern "C" int sparknet_lrn_across_channels_bwd(const void* x,
                                                const void* scale,
                                                const void* dy, void* dx,
                                                int n, int c, int hw,
                                                int size, float coef,
                                                float beta, int relu,
                                                int bf16, void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0) return 0;
  if (size < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const int pre = (size - 1) / 2;
  const int post = size - 1 - pre;
  const dim3 grid((hw + kThreads - 1) / kThreads,
                  (c + kChannels - 1) / kChannels, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lrn_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), c, hw, pre, post, coef, -beta,
        relu);
  } else {
    lrn_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(dy), static_cast<float*>(dx), c, hw, pre,
        post, coef, -beta, relu);
  }
  return (int)cudaGetLastError();
}
