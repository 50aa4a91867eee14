// JPEG decoding on the card (nvJPEG from the CUDA toolkit), the kernel
// that turns its YCbCr planes into RGB as libjpeg does, and the bilinear
// force-resize kernel that turns interleaved RGB into the port's planar
// float32 images.
//
// Replaces: the JPEG decode and force-resize of the JAX package's native
// data pipeline, sparknet_tpu/native/data_pipeline.cpp:202-276
// (sn_decode_jpeg_resize, reached through sparknet_tpu/native/__init__.py:
// 174-195).  No TPU kernel does this: the JAX package decodes on the host
// with libjpeg.
//
// Decode.  nvJPEG's default backend parses and Huffman-decodes on the
// calling thread and runs dequantisation and the IDCT on the card.  For a
// YCbCr JPEG sampled 4:4:4, 4:2:2 or 4:2:0 it returns the component planes
// (NVJPEG_OUTPUT_YUV), and ycc_to_rgb_kernel upsamples the chroma and
// converts to RGB exactly as libjpeg-turbo does (its fancy upsampling:
// jdsample.c h2v1_fancy_upsample, h2v2_fancy_upsample, the box upsampler
// for chroma at most 2 wide; jdcolor.c ycc_rgb_convert's fixed-point
// tables), so the card's pixels differ from the JAX package's libjpeg
// only where the two IDCTs round differently.  nvJPEG's own upsampling
// and conversion differ from libjpeg's by 2.5 on average on 4:2:0 images
// and sit 0.5 below it on every channel.  Gray JPEGs and other samplings
// take nvJPEG's own interleaved RGB (NVJPEG_OUTPUT_RGBI).  The output goes
// to device memory the caller allocates.  A nvjpegJpegState_t is not
// thread-safe, so each calling thread keeps its own (thread_local); the
// handle is shared.  The decode runs on the caller's stream and is
// synchronised before the call returns, so a thread's state is never
// reused while the card still works on its last image.
//
// Resize.  One thread per output pixel, all channels, threads along x, so
// the planar float32 stores are coalesced; the four source taps are byte
// loads from the interleaved image.  Bound: bytes (the source read once,
// the output written once) over 3.35 TB/s; at 500x375 -> 256x256 that is
// under 1 µs, so a launch is launch-bound.  The arithmetic is the native
// pipeline's, operation for operation, in float32 with round-to-nearest
// intrinsics that nvcc never contracts into an FMA, so the output equals
// the plain version (cuda_kernels.resize_bilinear_reference) and the JAX
// package's native resize bit for bit:
//   sy = (float)(H-1) / (out_h-1)   (0 when H or out_h is 1)
//   fy = y * sy; y0 = (int)fy; y1 = min(y0 + 1, H - 1); wy = fy - y0
//   v = (1-wy) * ((1-wx)*p00 + wx*p01) + wy * ((1-wx)*p10 + wx*p11)
// The gray form writes ((R + G) + B) / 3 of the three resized channels,
// numpy's mean over the channel axis in float32.
//
// Colour conversion.  One thread per output pixel, threads along x: the
// luma byte and, for each chroma plane, the up to four taps of libjpeg's
// triangle filter, integer arithmetic only; bound by bytes (the three
// planes read once, the RGB written once), launch-bound at these sizes.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <mutex>

namespace {

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_NOT_INITIALIZED;

// Return codes to Python: 0 decoded; 1 the bytes are no JPEG nvJPEG can
// read (the caller drops the image); 2 four components (CMYK or YCCK,
// which the native pipeline's JCS_RGB refuses: dropped too); below 0 the
// decoder itself failed: -(1000 + nvjpegStatus_t) or -(cudaError_t).
constexpr int kUndecodable = 1;
constexpr int kFourComponents = 2;

int nvjpeg_fault(nvjpegStatus_t s) { return -(1000 + (int)s); }

// The data's fault, not the decoder's.
bool data_fault(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         s == NVJPEG_STATUS_INCOMPLETE_BITSTREAM;
}

nvjpegHandle_t handle() {
  std::call_once(g_once, [] { g_handle_status = nvjpegCreateSimple(&g_handle); });
  return g_handle_status == NVJPEG_STATUS_SUCCESS ? g_handle : nullptr;
}

struct ThreadState {
  nvjpegJpegState_t state = nullptr;
  ~ThreadState() {
    if (state != nullptr) nvjpegJpegStateDestroy(state);
  }
};
thread_local ThreadState t_state;

__device__ __forceinline__ void tap(int n_in, int n_out, int i, int* i0,
                                    int* i1, float* w) {
  const float s = (n_in > 1 && n_out > 1)
                      ? __fdiv_rn((float)(n_in - 1), (float)(n_out - 1))
                      : 0.f;
  const float f = __fmul_rn((float)i, s);
  *i0 = (int)f;
  *i1 = *i0 + 1 < n_in ? *i0 + 1 : *i0;
  *w = __fsub_rn(f, (float)*i0);
}

__global__ void resize_bilinear_kernel(const uint8_t* __restrict__ src, int h,
                                       int w, int pitch,
                                       float* __restrict__ out, int out_h,
                                       int out_w, int gray) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= out_w) return;
  int y0, y1, x0, x1;
  float wy, wx;
  tap(h, out_h, y, &y0, &y1, &wy);
  tap(w, out_w, x, &x0, &x1, &wx);
  const float vy = __fsub_rn(1.f, wy), vx = __fsub_rn(1.f, wx);
  const uint8_t* r0 = src + (int64_t)y0 * pitch;
  const uint8_t* r1 = src + (int64_t)y1 * pitch;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p00 = r0[x0 * 3 + c], p01 = r0[x1 * 3 + c];
    const float p10 = r1[x0 * 3 + c], p11 = r1[x1 * 3 + c];
    const float top = __fadd_rn(__fmul_rn(vx, p00), __fmul_rn(wx, p01));
    const float bot = __fadd_rn(__fmul_rn(vx, p10), __fmul_rn(wx, p11));
    v[c] = __fadd_rn(__fmul_rn(vy, top), __fmul_rn(wy, bot));
  }
  const int64_t plane = (int64_t)out_h * out_w;
  const int64_t at = (int64_t)y * out_w + x;
  if (gray) {
    out[at] = __fdiv_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), 3.f);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * plane + at] = v[c];
  }
}

// libjpeg-turbo's upsampled chroma value at output (x, y) from a plane of
// cw x ch samples taken every sub_h-th column and sub_v-th row.
__device__ __forceinline__ int chroma_at(const uint8_t* c, int pitch, int ch,
                                         int cw, int sub_h, int sub_v, int x,
                                         int y) {
  if (sub_h == 1 && sub_v == 1) return c[(int64_t)y * pitch + x];
  const int i = x >> 1;
  if (cw <= 2)  // h2v1_upsample / h2v2_upsample: replicate
    return c[(int64_t)(y >> (sub_v - 1)) * pitch + i];
  if (sub_v == 1) {  // h2v1_fancy_upsample
    const uint8_t* row = c + (int64_t)y * pitch;
    if (x & 1) return i == cw - 1 ? row[i] : (row[i] * 3 + row[i + 1] + 2) >> 2;
    return i == 0 ? row[0] : (row[i] * 3 + row[i - 1] + 1) >> 2;
  }
  // h2v2_fancy_upsample: 3/4 of the nearer row plus 1/4 of the other (the
  // edge rows stand in for the rows past the image), then the same along x
  const int r = y >> 1;
  const int far = (y & 1) ? (r + 1 < ch ? r + 1 : r) : (r > 0 ? r - 1 : 0);
  const uint8_t* n = c + (int64_t)r * pitch;
  const uint8_t* f = c + (int64_t)far * pitch;
  const int here = n[i] * 3 + f[i];
  if (x & 1) {
    if (i == cw - 1) return (here * 4 + 7) >> 4;
    return (here * 3 + n[i + 1] * 3 + f[i + 1] + 7) >> 4;
  }
  if (i == 0) return (here * 4 + 8) >> 4;
  return (here * 3 + n[i - 1] * 3 + f[i - 1] + 8) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ yp, int y_pitch,
                                  const uint8_t* __restrict__ cbp,
                                  const uint8_t* __restrict__ crp,
                                  int c_pitch, int h, int w, int ch, int cw,
                                  int sub_h, int sub_v,
                                  uint8_t* __restrict__ out, int out_pitch) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int luma = yp[(int64_t)y * y_pitch + x];
  const int cb = chroma_at(cbp, c_pitch, ch, cw, sub_h, sub_v, x, y) - 128;
  const int cr = chroma_at(crp, c_pitch, ch, cw, sub_h, sub_v, x, y) - 128;
  // jdcolor.c: FIX(1.40200) = 91881, FIX(1.77200) = 116130,
  // FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 1 << 15; the
  // shifts are arithmetic (RIGHT_SHIFT), as on the host
  uint8_t* o = out + (int64_t)y * out_pitch + x * 3;
  o[0] = clamp255(luma + ((91881 * cr + 32768) >> 16));
  o[1] = clamp255(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  o[2] = clamp255(luma + ((116130 * cb + 32768) >> 16));
}

}  // namespace

// The JPEG's height, width, component count, nvjpegChromaSubsampling_t and
// its second component's height and width into info[0..5].
extern "C" int sparknet_jpeg_info(const void* data, long long len, void* info) {
  nvjpegHandle_t h = handle();
  if (h == nullptr) return nvjpeg_fault(g_handle_status);
  int n = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  const nvjpegStatus_t s = nvjpegGetImageInfo(
      h, (const unsigned char*)data, (size_t)len, &n, &ss, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return data_fault(s) ? kUndecodable : nvjpeg_fault(s);
  int* out = (int*)info;
  out[0] = heights[0];
  out[1] = widths[0];
  out[2] = n;
  out[3] = (int)ss;
  out[4] = n > 1 ? heights[1] : 0;
  out[5] = n > 1 ? widths[1] : 0;
  if (heights[0] <= 0 || widths[0] <= 0) return kUndecodable;
  return n == 4 ? kFourComponents : 0;
}

namespace {

int thread_state(nvjpegHandle_t h) {
  if (t_state.state != nullptr) return 0;
  const nvjpegStatus_t s = nvjpegJpegStateCreate(h, &t_state.state);
  if (s == NVJPEG_STATUS_SUCCESS) return 0;
  t_state.state = nullptr;
  return nvjpeg_fault(s);
}

// nvjpegDecode into ``img`` on ``stream``, waiting for the card to finish.
int decode(const void* data, long long len, nvjpegOutputFormat_t fmt,
           nvjpegImage_t* img, void* stream) {
  nvjpegHandle_t h = handle();
  if (h == nullptr) return nvjpeg_fault(g_handle_status);
  const int rc = thread_state(h);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const nvjpegStatus_t s = nvjpegDecode(
      h, t_state.state, (const unsigned char*)data, (size_t)len, fmt, img, st);
  const cudaError_t e = cudaStreamSynchronize(st);
  if (s != NVJPEG_STATUS_SUCCESS) return data_fault(s) ? kUndecodable : nvjpeg_fault(s);
  return e == cudaSuccess ? 0 : -(int)e;
}

}  // namespace

// Decode into interleaved RGB at dst (height rows of ``pitch`` bytes, the
// image's size from sparknet_jpeg_info) on ``stream``; returns once the
// card has finished.
extern "C" int sparknet_jpeg_decode_rgbi(const void* data, long long len,
                                         void* dst, int pitch, void* stream) {
  nvjpegImage_t img = {};
  img.channel[0] = (unsigned char*)dst;
  img.pitch[0] = (size_t)pitch;
  return decode(data, len, NVJPEG_OUTPUT_RGBI, &img, stream);
}

// Decode a three-component JPEG into its Y, Cb and Cr planes (luma rows of
// ``y_pitch`` bytes, chroma rows of ``c_pitch``, at their sampled sizes)
// on ``stream``; returns once the card has finished.
extern "C" int sparknet_jpeg_decode_planes(const void* data, long long len,
                                           void* y, int y_pitch, void* cb,
                                           void* cr, int c_pitch,
                                           void* stream) {
  nvjpegImage_t img = {};
  img.channel[0] = (unsigned char*)y;
  img.pitch[0] = (size_t)y_pitch;
  img.channel[1] = (unsigned char*)cb;
  img.pitch[1] = (size_t)c_pitch;
  img.channel[2] = (unsigned char*)cr;
  img.pitch[2] = (size_t)c_pitch;
  return decode(data, len, NVJPEG_OUTPUT_YUV, &img, stream);
}

// Decode a four-component JPEG (CMYK or YCCK) into its components as the
// file stores them (NVJPEG_OUTPUT_UNCHANGED), each a full-size plane of
// ``pitch``-byte rows, on ``stream``; returns once the card has finished.
// The conversion to RGB is the caller's (data/jpeg.py::cmyk_to_rgb).
extern "C" int sparknet_jpeg_decode_unchanged(const void* data, long long len,
                                              void* c0, void* c1, void* c2,
                                              void* c3, int pitch,
                                              void* stream) {
  nvjpegImage_t img = {};
  void* planes[4] = {c0, c1, c2, c3};
  for (int i = 0; i < 4; ++i) {
    img.channel[i] = (unsigned char*)planes[i];
    img.pitch[i] = (size_t)pitch;
  }
  return decode(data, len, NVJPEG_OUTPUT_UNCHANGED, &img, stream);
}

// Upsample the chroma planes (ch x cw, every sub_h-th column and sub_v-th
// row of the h x w image) and convert to interleaved RGB at ``out`` (h
// rows of ``out_pitch`` bytes), as libjpeg-turbo does.
extern "C" int sparknet_ycc_to_rgb(const void* y, int y_pitch, const void* cb,
                                   const void* cr, int c_pitch, int h, int w,
                                   int ch, int cw, int sub_h, int sub_v,
                                   void* out, int out_pitch, void* stream) {
  const int threads = 128;
  const dim3 grid((w + threads - 1) / threads, h);
  ycc_to_rgb_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, y_pitch, (const uint8_t*)cb, (const uint8_t*)cr,
      c_pitch, h, w, ch, cw, sub_h, sub_v, (uint8_t*)out, out_pitch);
  return (int)cudaGetLastError();
}

// Force-resize an interleaved uint8 RGB image (h rows of ``pitch`` bytes)
// to planar float32 (3 or, gray, 1, out_h, out_w) at ``out``.
extern "C" int sparknet_resize_bilinear(const void* src, int h, int w,
                                        int pitch, void* out, int out_h,
                                        int out_w, int gray, void* stream) {
  const int threads = 128;
  const dim3 grid((out_w + threads - 1) / threads, out_h);
  resize_bilinear_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, h, w, pitch, (float*)out, out_h, out_w, gray);
  return (int)cudaGetLastError();
}
