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
//   t[d]  = dy[d] * (a[d] * scale[d]^-beta) / scale[d]
//   ratio = sum_{d = c-post .. c+pre} t[d]
//   dx[c] = dy[c] * scale[c]^-beta - (2*alpha*beta/size) * a[c] * ratio
//
// and, with relu, dx = 0 where x <= 0 (ties at 0 get no gradient, as
// relu_layer.cpp's backward).  The window of the sum is the forward's
// window reflected, (post, pre) in place of (pre, post), since channel d
// feeds channel c's gradient iff c lies in d's forward window; the two
// differ only at an even `size`.  The math is in f32 whatever the I/O type
// (f32 or bf16); the window is summed in ascending channel order with each
// step rounded, as the TPU kernel's shifted adds sum it, and no step is
// contracted into an FMA, so the result matches the plain PyTorch version
// bit for bit wherever the two powf agree.
//
// Its bound is memory: it reads x, scale and dy once each and writes dx
// once; per element the function needs one powf, one division, a window
// sum of `size` adds and a few multiplies, far below the card's f32 rate.
// Design, after the forward's (csrc/lrn.cu): one thread per (image, position)
// and chunk of kChunk = 4 channels, positions flattened over (n, p), so the 32
// lanes of a warp read 32 neighbouring addresses of one channel plane, a small
// plane still fills its warps, and the batch is no grid dimension (any N with
// N*HW < 2^31).  The thread issues all of its loads at once, x, scale and dy of
// its chunk into register arrays (compile-time chunk and size, fully unrolled),
// so it waits on device memory about once.  It computes scale^-beta and t once
// for each of its channels, where a walk of each window would pay size + 1 powf
// and size divisions per element.  A window also needs t of size - 1 halo
// channels, post below the chunk and pre above (the reflected window).  A block
// stacks up to 8 warps, each one chunk of consecutive channels of the same 32
// positions; each warp hands the terms of its edge channels to its neighbours
// through shared memory, and only the block's first and last warps load and
// compute the halo beyond the block.  So per output element there are (4 *
// warps + size - 1) / (4 * warps) powf and divisions and as many loads (1.25 at
// size 5 and 4 warps), against (4 + size - 1) / 4 if each thread loaded its own
// halo.  A channel outside [0, C) contributes t = 0 explicitly, never t
// computed from its zero-filled loads (powf(0, -beta) is inf, and 0 * inf / 0
// is NaN), and adding that 0 leaves the sum's bits as the plain version's zero
// padding does.  The warps of a block come from Python by shape
// (ops/cuda_kernels.py::lrn_bwd_plan): 4, or fewer where the channels do not
// fill them.  What is left bounds it above the bytes: powf and the long-latency
// division, and the one __syncthreads (times in PERF.md). Sizes 3, 4 and 5 are
// instantiated; another size takes a generic form on the same grid that walks
// each window with a runtime loop.  Offsets are 64-bit.  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

using sparknet::relu_of;
using sparknet::store;
using sparknet::to_f32;

constexpr int kLanes = 32;     // positions of a block, one per lane
constexpr int kMaxWarps = 8;   // chunks of a block, one per warp
constexpr int kChunk = 4;      // channels of a thread

// t = dy * y / scale with y = a * scale^-beta, and scale^-beta in `p`
__device__ __forceinline__ float term(float a, float s, float g, float p) {
  return __fdiv_rn(__fmul_rn(g, __fmul_rn(a, p)), s);
}

// dx of channel c from its own a, dy, scale^-beta and window sum
__device__ __forceinline__ float grad(float xc, float a, float g, float p,
                                      float ratio, float coef, int relu) {
  const float da =
      __fsub_rn(__fmul_rn(g, p), __fmul_rn(__fmul_rn(coef, a), ratio));
  return relu && !(xc > 0.f) ? 0.f : da;
}

// A block is kLanes positions x (blockDim.x / kLanes) warps; warp w of
// block (bx, by) takes channels [c0, c0 + kChunk), c0 = (by * warps + w) *
// kChunk.  Span index j is channel c0 - kPost + j: the chunk is j in
// [kPost, kPost + kChunk), its halo the kPost channels below and the kPre
// above.  Only the block's first warp loads its lower halo and only its
// last warp its upper one; every other halo term is a neighbouring warp's
// own, passed through shared memory.
template <typename T, int kSize>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ dy, T* __restrict__ dx, int C, int HW,
               int positions, float coef, float neg_beta, int relu) {
  constexpr int kPre = (kSize - 1) / 2;
  constexpr int kPost = kSize - 1 - kPre;
  constexpr int kSpan = kChunk + kSize - 1;
  static_assert(kPre >= 1 && kPost <= kChunk, "sizes 3 to 5 only");
  // each warp's first kPre and last kPost terms, for its neighbours
  __shared__ float first_t[kMaxWarps][kPre][kLanes];
  __shared__ float last_t[kMaxWarps][kPost][kLanes];
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int q = blockIdx.x * kLanes + lane;
  const bool live = q < positions;
  const int n = q / HW;
  const int64_t base = (int64_t)n * C * HW + (q - n * HW);
  const int c0 = (blockIdx.y * warps + w) * kChunk;
  const bool lower = w == 0, upper = w == warps - 1;
  // every load this thread needs, issued before any use
  float xv[kSpan], sv[kSpan], gv[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const int c = c0 - kPost + j;
    const bool need = j < kPost ? lower : j < kPost + kChunk || upper;
    const bool in = need && live && c >= 0 && c < C;
    const int64_t o = base + (int64_t)c * HW;
    xv[j] = in ? to_f32(x[o]) : 0.f;
    sv[j] = in ? to_f32(scale[o]) : 0.f;
    gv[j] = in ? to_f32(dy[o]) : 0.f;
  }
  // scale^-beta and t once per channel; a channel outside [0, C), or past
  // the last position, contributes t = 0, never t of its zero-filled loads
  float av[kSpan], pv[kSpan], t[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const int c = c0 - kPost + j;
    if (j < kPost ? !lower : j >= kPost + kChunk && !upper) continue;
    av[j] = relu ? relu_of(xv[j]) : xv[j];
    pv[j] = powf(sv[j], neg_beta);
    t[j] = live && c >= 0 && c < C ? term(av[j], sv[j], gv[j], pv[j]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPre; ++j) first_t[w][j][lane] = t[kPost + j];
#pragma unroll
  for (int j = 0; j < kPost; ++j) last_t[w][j][lane] = t[kChunk + j];
  __syncthreads();
  if (!lower) {
#pragma unroll
    for (int j = 0; j < kPost; ++j) t[j] = last_t[w - 1][j][lane];
  }
  if (!upper) {
#pragma unroll
    for (int j = 0; j < kPre; ++j)
      t[kPost + kChunk + j] = first_t[w + 1][j][lane];
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (c0 + i >= C) break;
    // channel c0 + i: window span[i .. i + kSize), itself at span[i + kPost]
    float ratio = t[i];
#pragma unroll
    for (int d = 1; d < kSize; ++d) ratio = __fadd_rn(ratio, t[i + d]);
    const int j = i + kPost;
    store(dx + base + (int64_t)(c0 + i) * HW,
          grad(xv[j], av[j], gv[j], pv[j], ratio, coef, relu));
  }
}

// any window size, on the same grid: the same arithmetic, each window
// walked by a loop that recomputes its terms
template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
lrn_bwd_generic_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx, int C,
                       int HW, int positions, int pre, int post,
                       float coef, float neg_beta, int relu) {
  const int q = blockIdx.x * kLanes + threadIdx.x % kLanes;
  if (q >= positions) return;
  const int n = q / HW;
  const int64_t base = (int64_t)n * C * HW + (q - n * HW);
  const int c_begin =
      (blockIdx.y * (blockDim.x / kLanes) + threadIdx.x / kLanes) * kChunk;
  const int c_end = min(c_begin + kChunk, C);
  auto at = [&](const T* v, int c) {
    return to_f32(v[base + (int64_t)c * HW]);
  };
  for (int c = c_begin; c < c_end; ++c) {
    float ratio = 0.f;
    for (int d = max(c - post, 0); d <= min(c + pre, C - 1); ++d) {
      const float a = relu ? relu_of(at(x, d)) : at(x, d);
      const float s = at(scale, d);
      ratio = __fadd_rn(ratio, term(a, s, at(dy, d), powf(s, neg_beta)));
    }
    const float xc = at(x, c);
    const float s = at(scale, c);
    store(dx + base + (int64_t)c * HW,
          grad(xc, relu ? relu_of(xc) : xc, at(dy, c), powf(s, neg_beta),
               ratio, coef, relu));
  }
}

struct Args {
  const void* x;
  const void* scale;
  const void* dy;
  void* dx;
  int c, hw, positions, size;
  float coef, neg_beta;
  int relu;
  dim3 grid, block;
  cudaStream_t s;
};

template <typename T, int kSize>
int launch_sized(const Args& a) {
  lrn_bwd_kernel<T, kSize><<<a.grid, a.block, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.c, a.hw,
      a.positions, a.coef, a.neg_beta, a.relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const Args& a) {
  switch (a.size) {
    case 3: return launch_sized<T, 3>(a);
    case 4: return launch_sized<T, 4>(a);
    case 5: return launch_sized<T, 5>(a);
    default: break;
  }
  const int pre = (a.size - 1) / 2;
  lrn_bwd_generic_kernel<T><<<a.grid, a.block, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.c, a.hw,
      a.positions, pre, a.size - 1 - pre, a.coef, a.neg_beta, a.relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x, scale, dy, dx: contiguous (n, c, hw) tensors of one dtype (bf16 != 0:
// bf16, else f32).  coef = 2 * alpha * beta / size, rounded to f32 by the
// caller.  A block is 32 positions x `warps` (1 to 8) chunks of 4
// channels.
extern "C" int sparknet_lrn_across_channels_bwd(const void* x,
                                                const void* scale,
                                                const void* dy, void* dx,
                                                int n, int c, int hw,
                                                int size, float coef,
                                                float beta, int relu,
                                                int bf16, int warps,
                                                void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0) return 0;
  const int64_t positions = (int64_t)n * hw;
  const int64_t per_block = (int64_t)kChunk * warps;
  if (size < 1 || warps < 1 || warps > kMaxWarps ||
      positions > 0x7fffffff || (c + per_block - 1) / per_block > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x, scale, dy, dx, c, hw, (int)positions, size, coef, -beta, relu,
         dim3((unsigned)((positions + kLanes - 1) / kLanes),
              (unsigned)((c + per_block - 1) / per_block)),
         dim3(kLanes * warps), static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_typed<__nv_bfloat16>(a) : launch_typed<float>(a);
}
