// Backward of Caffe's MAX pooling, any stride and padding, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_maxpool_bwd_kernel_s1` (:203-265) and
// `_maxpool_bwd_kernel_strided` (:277-341) of
// sparknet_tpu/ops/pallas_kernels.py, dispatched by `_maxpool_bwd_call`
// (:360-376) under `max_pool_vmem_bwd` (:379-405), with one kernel for
// every stride.  It computes what they compute: each pooling window's
// gradient dy goes to the window's FIRST maximum in row-major order,
// re-derived from the forward's input x (Caffe's argmax scan,
// pooling_layer.cpp Forward_cpu MAX branch), and where windows overlap
// their contributions add.  The geometry is Caffe's ceil mode: window
// (oi, oj) covers input rows oi*sh - ph .. oi*sh - ph + kh - 1 (and the
// same for columns), clipped to the input; the padding never holds the
// maximum, as if it were -inf.
//
// Its bound is memory: it must read x and dy once and write dx once.
// Design: one launch, one trip through shared memory, as the TPU kernel
// keeps a plane in VMEM.  A block takes a group of whole planes (small
// planes are packed, so each block has a few thousand dx elements), or,
// for a plane too big for its shared memory, a band of dx rows.  It
//   1. stages the x rows its windows read, as 16-byte vector loads (four
//      in flight per thread) into a copy aligned as its source;
//   2. finds each window's first maximum from shared memory (row-major
//      scan, strict >, so a NaN after the first tap never wins and ties
//      keep the earlier tap) and packs it with the window's dy, read once
//      from device memory, as an int2;
//   3. after a barrier, gathers each dx element it owns from the windows
//      covering it, in row-major window order, in f32, and stores dx once,
//      coalesced, in the I/O type (f32 or bf16).
// A band owns its dx rows; it stages every input row of the windows that
// cover them (the halo) and recomputes the windows on its edges that its
// neighbour also computes.  There is no scratch in device memory and no
// atomic, and every dx element is summed by one thread in a fixed order,
// so the result is the same from run to run.  Threads walk rows of lanes
// (RowWalk), so no index needs a per-element division.  The zoo's square
// 3/2, 3/1 and 2/2 geometries are compiled with kernel and stride fixed:
// their scans unroll, and their gather goes by cells of stride x stride
// dx elements, each loading its covering windows once (at 3/2, four
// windows serve four elements, where each element alone would load up to
// four).  Other geometries take a run-time loop per element.  The launch
// plan (planes per block, band rows, shared bytes) is chosen in Python
// (ops/cuda_kernels.py::max_pool_bwd_plan); the entry point recomputes the
// shared bytes the plan needs and refuses a plan that gives less.  The TPU
// kernel's channel tile of at most 8, its one-hot MXU gathers and its
// bf16-min padding sentinel were workarounds for the TPU compiler and do
// not carry over.  The entry point allocates nothing and returns
// cudaGetLastError().

#include "common.cuh"

namespace {

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

using sparknet::store;
using sparknet::to_f32;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // 16-byte loads in flight per thread
constexpr int kSmemMax = 232448;        // what one block may opt in to
constexpr int kSmemDefault = 48 * 1024; // above this, opt in first

// n / d for 0 <= n < 2^22 and d >= 1: the float quotient is within one of
// the true one there, and one correction step makes it exact
__device__ __forceinline__ int div_small(int n, int d, float inv_d) {
  int q = __float2int_rz(__int2float_rn(n) * inv_d);
  const int r = n - q * d;
  if (r < 0) --q;
  else if (r >= d) ++q;
  return q;
}

// One band of dx rows of a plane: it owns rows [r0, r1), computes window
// rows oi0 .. oi0 + nwr - 1 (every window covering an owned row) and stages
// input rows [xr0, xr0 + nxr).  The last band stages down to the plane's
// last row, so a group of whole planes (one band) is one contiguous range.
struct Band {
  int r0, r1, oi0, nwr, xr0, nxr;
};

__host__ __device__ inline Band band_of(int band, int bands, int band_rows,
                                        int H, int kh, int sh, int ph,
                                        int OH) {
  Band b;
  b.r0 = band * band_rows;
  b.r1 = imin(b.r0 + band_rows, H);
  b.oi0 = b.r0 + ph >= kh ? (b.r0 + ph - kh) / sh + 1 : 0;
  const int oi1 = imin((b.r1 - 1 + ph) / sh, OH - 1);
  b.nwr = imax(oi1 - b.oi0 + 1, 0);
  b.xr0 = imax(b.oi0 * sh - ph, 0);
  const int xr1 = band == bands - 1 ? H : imin(oi1 * sh - ph + kh, H);
  b.nxr = imax(xr1 - b.xr0, 0);
  return b;
}

// shared bytes of one band of `np` planes: per window its argmax and dy
// (an int2), then the staged x rows in the I/O type, with 16 bytes of
// slack to align them as their source is aligned
inline int64_t band_bytes(const Band& b, int np, int W, int OW, int elt) {
  const int64_t wins = (int64_t)np * b.nwr * OW;
  return (8 * wins + 15) / 16 * 16 + 16 + (int64_t)elt * np * b.nxr * W;
}

// threads of a block: whole rows of min(W, kThreads) lanes
__host__ __device__ inline int block_threads(int W) {
  const int lanes = imin(W, kThreads);
  return kThreads / lanes * lanes;
}

// Copy n elements from src to shared memory at dst16 + (src mod 16
// bytes), so that source and copy share their alignment and the body moves
// in 16-byte vectors, kUnroll in flight per thread; returns the copy.
template <typename T>
__device__ __forceinline__ const T* stage(unsigned char* dst16,
                                          const T* __restrict__ src, int n) {
  const int shift = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  T* d = reinterpret_cast<T*>(dst16 + shift);
  const int head = imin(((16 - shift) & 15) / (int)sizeof(T), n);
  constexpr int kPer = 16 / sizeof(T);
  const int nvec = (n - head) / kPer;
  for (int i = threadIdx.x; i < head; i += blockDim.x) d[i] = src[i];
  for (int i = head + nvec * kPer + threadIdx.x; i < n; i += blockDim.x)
    d[i] = src[i];
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(d + head);
  for (int base = threadIdx.x; base < nvec; base += kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < nvec) v[u] = vs[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < nvec) vd[i] = v[u];
    }
  }
  return d;
}

// A block walks a (rows x cols) array a row of lanes at a time: thread
// (row0, col0) takes rows row0, row0 + step, ... and in each the columns
// col0, col0 + lanes, ...; rows are (plane, row in plane) pairs, advanced
// without a division.
struct RowWalk {
  int lanes, step, col0, i, rr, rows_per_plane;
  __device__ RowWalk(int cols, int rows_per_plane_)
      : lanes(min(cols, (int)blockDim.x)),
        step(blockDim.x / lanes),
        col0(threadIdx.x % lanes),
        i(threadIdx.x / lanes / rows_per_plane_),
        rr(threadIdx.x / lanes % rows_per_plane_),
        rows_per_plane(rows_per_plane_) {}
  __device__ bool active() const { return threadIdx.x < step * lanes; }
  __device__ void next() {
    rr += step;
    while (rr >= rows_per_plane) {
      rr -= rows_per_plane;
      ++i;
    }
  }
};

// K, S > 0 fix a square kernel and stride at compile time (the zoo's 3/2,
// 3/1 and 2/2): the scan unrolls and the gather goes by cells; K = S = 0
// takes any geometry at run time.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int planes, int H, int W, int kh_,
                   int kw_, int sh_, int sw_, int ph, int pw, int OH, int OW,
                   int ppb, int band_rows, int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = K ? K : kh_, kw = K ? K : kw_;
  const int sh = S ? S : sh_, sw = S ? S : sw_;
  const int group = blockIdx.x / bands;
  const int band = blockIdx.x - group * bands;
  const int p0 = group * ppb;
  const int np = min(ppb, planes - p0);
  const Band b = band_of(band, bands, band_rows, H, kh, sh, ph, OH);
  const int nwin = b.nwr * OW;     // windows per plane
  const int nx = b.nxr * W;        // staged x elements per plane
  int2* win = reinterpret_cast<int2*>(smem);   // (argmax, dy bits)
  unsigned char* xregion = smem + (8 * np * nwin + 15) / 16 * 16;

  // 1. stage x rows: np planes' rows are contiguous (np > 1 only with one
  // band)
  const int64_t plane0 = (int64_t)p0 * H * W;
  const T* xs = stage(xregion, x + plane0 + (int64_t)b.xr0 * W, np * nx);
  __syncthreads();

  // 2. each window's first maximum, as an in-plane position, beside its dy
  // read from device memory (the window rows of the group are contiguous)
  const T* dyg = dy + (int64_t)p0 * OH * OW + (int64_t)b.oi0 * OW;
  RowWalk wk(OW, max(b.nwr, 1));
  if (wk.active()) {
    for (int row = threadIdx.x / wk.lanes; row < np * b.nwr;
         row += wk.step, wk.next()) {
      const int hs = (b.oi0 + wk.rr) * sh - ph;
      const int h0 = max(hs, 0), h1 = min(hs + kh, H);
      const int xb = wk.i * nx - b.xr0 * W;   // position p at xs[xb + p]
      for (int oj = wk.col0; oj < OW; oj += wk.lanes) {
        const float g = to_f32(dyg[row * OW + oj]);
        const int ws = oj * sw - pw;
        const int w0 = max(ws, 0), w1 = min(ws + kw, W);
        // the first tap starts the scan; it cannot beat itself, so every
        // tap may be compared, and ties keep the earlier one
        int best_pos = h0 * W + w0;
        float best = to_f32(xs[xb + best_pos]);
        if constexpr (K > 0) {
#pragma unroll
          for (int dh = 0; dh < K; ++dh) {
#pragma unroll
            for (int dw = 0; dw < K; ++dw) {
              const int h = hs + dh, w = ws + dw;
              if (h >= h0 && h < h1 && w >= w0 && w < w1) {
                const float v = to_f32(xs[xb + h * W + w]);
                if (v > best) {
                  best = v;
                  best_pos = h * W + w;
                }
              }
            }
          }
        } else {
          for (int h = h0; h < h1; ++h) {
            for (int w = w0; w < w1; ++w) {
              const float v = to_f32(xs[xb + h * W + w]);
              if (v > best) {
                best = v;
                best_pos = h * W + w;
              }
            }
          }
        }
        win[row * OW + oj] = make_int2(best_pos, __float_as_int(g));
      }
    }
  }
  __syncthreads();

  // 3. gather: each owned dx element from the windows covering it, in
  // row-major window order
  // window (oi, oj) of plane i at win[i * nwin + wb0 + oi * OW + oj]
  const int wb0 = -b.oi0 * OW;
  if constexpr (K > 0) {
    // by cells of S x S dx elements: cell (ci, cj) holds rows ci*S - ph
    // + t and columns cj*S - pw + u (t, u < S); the windows covering it
    // are (ci - d, cj - e), d, e < kCover, and element (t, u) lies in
    // window (ci - d, cj - e) exactly when d*S + t < K and e*S + u < K,
    // so each cell loads its windows once and the pattern is fixed here
    constexpr int kCover = (K + S - 1) / S;
    const int ci0 = (b.r0 + ph) / S;
    const int ncr = (b.r1 - 1 + ph) / S - ci0 + 1;   // cell rows per plane
    const int ncc = (W - 1 + pw) / S + 1;            // cell columns
    const int oi_last = b.oi0 + b.nwr - 1;
    RowWalk cw(ncc, ncr);
    if (!cw.active()) return;
    for (int row = threadIdx.x / cw.lanes; row < np * ncr;
         row += cw.step, cw.next()) {
      const int ci = ci0 + cw.rr;
      const int wb = cw.i * nwin + wb0;
      T* outp = dx + plane0 + (int64_t)cw.i * H * W;
      for (int cj = cw.col0; cj < ncc; cj += cw.lanes) {
        int2 v[kCover][kCover];
#pragma unroll
        for (int d = 0; d < kCover; ++d) {
#pragma unroll
          for (int e = 0; e < kCover; ++e) {
            const int oi = ci - d, oj = cj - e;
            v[d][e] = oi >= b.oi0 && oi <= oi_last && oj >= 0 && oj < OW
                          ? win[wb + oi * OW + oj]
                          : make_int2(-1, 0);
          }
        }
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int r = ci * S - ph + t;
          if (r < b.r0 || r >= b.r1) continue;
#pragma unroll
          for (int u = 0; u < S; ++u) {
            const int c = cj * S - pw + u;
            if (c < 0 || c >= W) continue;
            const int pos = r * W + c;
            float acc = 0.f;
#pragma unroll
            for (int d = kCover - 1; d >= 0; --d) {     // oi ascending
#pragma unroll
              for (int e = kCover - 1; e >= 0; --e) {   // oj ascending
                if (d * S + t < K && e * S + u < K && v[d][e].x == pos)
                  acc = __fadd_rn(acc, __int_as_float(v[d][e].y));
              }
            }
            store(outp + pos, acc);
          }
        }
      }
    }
  } else {
    const int own = b.r1 - b.r0;
    const float inv_sh = 1.f / sh, inv_sw = 1.f / sw;
    T* out = dx + plane0 + (int64_t)b.r0 * W;
    RowWalk dk(W, own);
    if (!dk.active()) return;
    for (int row = threadIdx.x / dk.lanes; row < np * own;
         row += dk.step, dk.next()) {
      const int ih = b.r0 + dk.rr;
      // the windows covering row ih: oi*sh <= ih + ph <= oi*sh + kh - 1
      const int hp = ih + ph;
      const int oi_lo = hp >= kh ? div_small(hp - kh, sh, inv_sh) + 1 : 0;
      const int oi_hi = min(div_small(hp, sh, inv_sh), OH - 1);
      const int wb = dk.i * nwin + wb0;
      for (int iw = dk.col0; iw < W; iw += dk.lanes) {
        const int wp = iw + pw;
        const int oj_lo = wp >= kw ? div_small(wp - kw, sw, inv_sw) + 1 : 0;
        const int oj_hi = min(div_small(wp, sw, inv_sw), OW - 1);
        const int pos = ih * W + iw;
        float acc = 0.f;
        for (int oi = oi_lo; oi <= oi_hi; ++oi) {
          for (int oj = oj_lo; oj <= oj_hi; ++oj) {
            const int2 v = win[wb + oi * OW + oj];
            if (v.x == pos) acc = __fadd_rn(acc, __int_as_float(v.y));
          }
        }
        store(out + row * W + iw, acc);
      }
    }
  }
}

template <typename T, int K, int S>
int launch_geometry(const void* x, const void* dy, void* dx, int planes,
                    int h, int w, int kh, int kw, int sh, int sw, int ph,
                    int pw, int oh, int ow, int ppb, int band_rows, int bands,
                    unsigned blocks, int smem, cudaStream_t s) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        maxpool_bwd_kernel<T, K, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  maxpool_bwd_kernel<T, K, S><<<blocks, block_threads(w), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), planes, h, w, kh, kw, sh, sw, ph, pw, oh, ow, ppb,
      band_rows, bands);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, int planes, int h,
           int w, int kh, int kw, int sh, int sw, int ph, int pw, int oh,
           int ow, int ppb, int band_rows, int smem, cudaStream_t s) {
  const int bands = (h + band_rows - 1) / band_rows;
  if (ppb > 1 && bands > 1) return (int)cudaErrorInvalidValue;
  int64_t need = 0;
  for (int band = 0; band < bands; ++band) {
    const int64_t bytes = band_bytes(
        band_of(band, bands, band_rows, h, kh, sh, ph, oh), ppb, w, ow,
        (int)sizeof(T));
    if (bytes > need) need = bytes;
  }
  const int64_t blocks = ((int64_t)planes + ppb - 1) / ppb * bands;
  if (smem < need || smem > kSmemMax || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool square = kh == kw && sh == sw;
#define SPARKNET_POOL_LAUNCH(K, S)                                          \
  launch_geometry<T, K, S>(x, dy, dx, planes, h, w, kh, kw, sh, sw, ph, pw, \
                           oh, ow, ppb, band_rows, bands, (unsigned)blocks, \
                           smem, s)
  if (square && kh == 3 && sh == 2) return SPARKNET_POOL_LAUNCH(3, 2);
  if (square && kh == 3 && sh == 1) return SPARKNET_POOL_LAUNCH(3, 1);
  if (square && kh == 2 && sh == 2) return SPARKNET_POOL_LAUNCH(2, 2);
  return SPARKNET_POOL_LAUNCH(0, 0);
#undef SPARKNET_POOL_LAUNCH
}

}  // namespace

// x, dx: contiguous (planes, h, w) tensors and dy a contiguous
// (planes, oh, ow) tensor, all of one dtype (bf16 != 0: bf16, else f32),
// where planes = batch * channels.  The caller checks the geometry:
// kernel, stride >= 1, 0 <= pad < kernel, and (oh, ow) Caffe's ceil-mode
// output size.  The plan: `ppb` planes per block (more than 1 only when a
// plane is one band), bands of `band_rows` dx rows, `smem` dynamic shared
// bytes per block.  The launch refuses a geometry in which a window would
// hold no input element, positions beyond 2^22 rows or columns, more than
// 2^31 - 1 planes, and a plan whose shared bytes fall short.
extern "C" int sparknet_max_pool_bwd(const void* x, const void* dy, void* dx,
                                     long long planes, int h, int w, int kh,
                                     int kw, int sh, int sw, int ph, int pw,
                                     int oh, int ow, int ppb, int band_rows,
                                     int smem, int bf16, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  if (kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 ||
      ph >= kh || pw >= kw || oh < 1 || ow < 1 ||
      (int64_t)(oh - 1) * sh - ph >= h || (int64_t)(ow - 1) * sw - pw >= w ||
      h + ph >= (1 << 22) || w + pw >= (1 << 22) || planes > 0x7fffffff ||
      ppb < 1 || band_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, dx, (int)planes, h, w, kh, kw, sh,
                                 sw, ph, pw, oh, ow, ppb, band_rows, smem, s);
  return launch<float>(x, dy, dx, (int)planes, h, w, kh, kw, sh, sw, ph, pw,
                       oh, ow, ppb, band_rows, smem, s);
}
