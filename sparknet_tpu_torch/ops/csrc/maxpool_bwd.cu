// Backward of Caffe's MAX pooling, any stride and padding, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_maxpool_bwd_kernel_s1` (:203-265) and
// `_maxpool_bwd_kernel_strided` (:277-341) of
// sparknet_tpu/ops/pallas_kernels.py, dispatched by `_maxpool_bwd_call`
// (:360-376) under `max_pool_vmem_bwd` (:379-405), with one kernel pair
// for every stride.  It computes what they compute: each pooling window's
// gradient dy goes to the window's FIRST maximum in row-major order,
// re-derived from the forward's input x (Caffe's argmax scan,
// pooling_layer.cpp Forward_cpu MAX branch), and where windows overlap
// their contributions add.  The geometry is Caffe's ceil mode: window
// (oi, oj) covers input rows oi*sh - ph .. oi*sh - ph + kh - 1 (and the
// same for columns), clipped to the input; the padding never holds the
// maximum, as if it were -inf.
//
// Design: two passes on the caller's stream, no atomics.
//   1. argmax: one thread per window scans it once, row-major, and writes
//      the in-plane position of its first maximum to an int32 scratch
//      plane (the wrapper allocates it: oh*ow per plane).
//   2. gather: one thread per element of dx visits the windows that cover
//      its position, in row-major order, and adds each window's dy whose
//      argmax is its own position.  The sum is in f32 and dx is stored
//      once, in the I/O type (f32 or bf16).
// Every dx element is written by one thread in a fixed order, so the
// result is the same from run to run.  The TPU kernel's channel tile of
// at most 8, its one-hot MXU gathers and its bf16-min padding sentinel
// were workarounds for the TPU compiler and do not carry over.
//
// Its bound is memory: it must read x and dy once and write dx once.
// Pass 1 reads each x element once per window holding it (up to 4 at
// 3x3 stride 2, 9 at stride 1; the repeats hit L1/L2) and writes 4 bytes
// per window; pass 2 reads, per dx element, up to that many argmax
// entries and dy values, again mostly from cache.  Offsets are 64-bit.
// The entry point allocates nothing and returns cudaGetLastError().

#include "common.cuh"

namespace {

using sparknet::store;
using sparknet::to_f32;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_argmax_kernel(const T* __restrict__ x, int* __restrict__ argpos,
                      int64_t windows, int H, int W, int kh, int kw, int sh,
                      int sw, int ph, int pw, int OH, int OW) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= windows) return;
  const int oj = (int)(i % OW);
  const int64_t rest = i / OW;
  const int oi = (int)(rest % OH);
  const int64_t plane = rest / OH;  // n * C + c
  const T* xp = x + plane * H * W;
  const int hs = oi * sh - ph;
  const int ws = oj * sw - pw;
  const int h0 = max(hs, 0), h1 = min(hs + kh, H);
  const int w0 = max(ws, 0), w1 = min(ws + kw, W);
  // first maximum of the window, row-major; ties keep the earlier tap
  int best_pos = h0 * W + w0;
  float best = to_f32(xp[best_pos]);
  for (int h = h0; h < h1; ++h) {
    for (int w = (h == h0 ? w0 + 1 : w0); w < w1; ++w) {
      const float v = to_f32(xp[h * W + w]);
      if (v > best) {
        best = v;
        best_pos = h * W + w;
      }
    }
  }
  argpos[i] = best_pos;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_gather_kernel(const int* __restrict__ argpos,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      int64_t total, int H, int W, int kh, int kw, int sh,
                      int sw, int ph, int pw, int OH, int OW) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int iw = (int)(i % W);
  const int64_t rest = i / W;
  const int ih = (int)(rest % H);
  const int64_t plane = rest / H;
  const int* ap = argpos + plane * OH * OW;
  const T* dyp = dy + plane * OH * OW;
  const int pos = ih * W + iw;
  // the windows covering (ih, iw): oi * sh <= ih + ph <= oi * sh + kh - 1
  const int hp = ih + ph;
  const int wp = iw + pw;
  const int oi_lo = hp >= kh ? (hp - kh) / sh + 1 : 0;
  const int oi_hi = min(hp / sh, OH - 1);
  const int oj_lo = wp >= kw ? (wp - kw) / sw + 1 : 0;
  const int oj_hi = min(wp / sw, OW - 1);
  float acc = 0.f;
  for (int oi = oi_lo; oi <= oi_hi; ++oi) {
    for (int oj = oj_lo; oj <= oj_hi; ++oj) {
      const int o = oi * OW + oj;
      if (ap[o] == pos) acc = __fadd_rn(acc, to_f32(dyp[o]));
    }
  }
  store(dx + i, acc);
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, int* argpos,
           int64_t planes, int h, int w, int kh, int kw, int sh, int sw,
           int ph, int pw, int oh, int ow, cudaStream_t s) {
  const int64_t windows = planes * oh * ow;
  const int64_t total = planes * h * w;
  const int64_t wblocks = (windows + kThreads - 1) / kThreads;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || wblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  maxpool_argmax_kernel<T><<<(unsigned)wblocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), argpos, windows, h, w, kh, kw, sh, sw, ph,
      pw, oh, ow);
  maxpool_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      argpos, static_cast<const T*>(dy), static_cast<T*>(dx), total, h, w,
      kh, kw, sh, sw, ph, pw, oh, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dx: contiguous (planes, h, w) tensors and dy a contiguous
// (planes, oh, ow) tensor, all of one dtype (bf16 != 0: bf16, else f32),
// where planes = batch * channels; argpos: int32 scratch of planes * oh *
// ow elements.  The caller checks the geometry: kernel, stride >= 1,
// 0 <= pad < kernel, and (oh, ow) Caffe's ceil-mode output size; the
// launch refuses a geometry in which a window would hold no input element
// or a plane's positions overflow int32.
extern "C" int sparknet_max_pool_bwd(const void* x, const void* dy, void* dx,
                                     void* argpos, long long planes, int h,
                                     int w, int kh, int kw, int sh, int sw,
                                     int ph, int pw, int oh, int ow,
                                     int bf16, void* stream) {
  if ((int64_t)planes * h * w <= 0) return 0;
  if (kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 ||
      ph >= kh || pw >= kw || oh < 1 || ow < 1 ||
      (int64_t)(oh - 1) * sh - ph >= h || (int64_t)(ow - 1) * sw - pw >= w ||
      (int64_t)h * w > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ap = static_cast<int*>(argpos);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, dx, ap, planes, h, w, kh, kw, sh, sw,
                                 ph, pw, oh, ow, s);
  return launch<float>(x, dy, dx, ap, planes, h, w, kh, kw, sh, sw, ph, pw,
                       oh, ow, s);
}
