// Native host-side data pipeline of sparknet_tpu_torch.
//
// The port's own copy of sparknet_tpu/native/data_pipeline.cpp: the
// per-image crop-into-float-buffer loop (reference:
// src/main/java/libs/ByteImage.java:77-95 cropInto), CIFAR record parsing
// (reference: src/main/scala/loaders/CifarLoader.scala:65 readBatch), the
// batched Datum parse (caffe/src/caffe/data_reader.cpp with C++ protobuf),
// JPEG decode + force-resize (reference:
// src/main/scala/preprocessing/ScaleAndConvert.scala:16-27), and mean-image
// accumulation (reference: src/main/scala/preprocessing/ComputeMean.scala:
// 8-44).
//
// A plain C ABI over ctypes: no Python objects held in native code, every
// buffer a caller-owned numpy array, every call one batch-granular pass.
// Built without libjpeg (-DSN_NO_JPEG, where jpeglib.h is missing), the
// other four entries stay and sn_decode_jpeg_resize returns -4; the card
// decodes JPEGs with nvJPEG (data/jpeg.py) and does not need it.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <csetjmp>

#ifndef SN_NO_JPEG
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CIFAR-10 binary records: [label u8][3072 u8 CHW pixels] repeated.
// Splits into planar float images (0..255) and int32 labels.
// ---------------------------------------------------------------------------
int sn_decode_cifar(const uint8_t* records, int64_t n_records,
                    float* images_out, int32_t* labels_out) {
    const int64_t rec = 1 + 3 * 32 * 32;
    for (int64_t i = 0; i < n_records; ++i) {
        const uint8_t* r = records + i * rec;
        labels_out[i] = r[0];
        float* dst = images_out + i * 3072;
        for (int64_t j = 0; j < 3072; ++j) dst[j] = (float)r[1 + j];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Batched crop + mirror + mean-subtract, u8/f32 NCHW in -> f32 NCHW out.
// ys/xs/flips are per-image; mean may be null (skip), scalar (len 1), or a
// full C*crop*crop plane.  This is ByteImage.cropInto vectorized over the
// batch with the mean fused in.
// ---------------------------------------------------------------------------
static inline void crop_one(const float* src, int C, int H, int W,
                            float* dst, int crop, int y0, int x0, int flip,
                            const float* mean, int mean_len) {
    for (int c = 0; c < C; ++c) {
        const float* plane = src + (int64_t)c * H * W;
        float* dplane = dst + (int64_t)c * crop * crop;
        for (int y = 0; y < crop; ++y) {
            const float* srow = plane + (int64_t)(y0 + y) * W + x0;
            float* drow = dplane + (int64_t)y * crop;
            if (flip) {
                for (int x = 0; x < crop; ++x) drow[x] = srow[crop - 1 - x];
            } else {
                memcpy(drow, srow, sizeof(float) * crop);
            }
        }
    }
    if (mean) {
        int64_t plane = (int64_t)C * crop * crop;
        if (mean_len == 1) {
            for (int64_t j = 0; j < plane; ++j) dst[j] -= mean[0];
        } else {
            for (int64_t j = 0; j < plane; ++j) dst[j] -= mean[j];
        }
    }
}

int sn_crop_batch_f32(const float* src, int64_t n, int C, int H, int W,
                      float* dst, int crop,
                      const int32_t* ys, const int32_t* xs,
                      const int32_t* flips,
                      const float* mean, int64_t mean_len) {
    if (crop > H || crop > W) return -1;
    for (int64_t i = 0; i < n; ++i) {
        if (ys[i] < 0 || xs[i] < 0 || ys[i] + crop > H || xs[i] + crop > W)
            return -2;
        crop_one(src + i * (int64_t)C * H * W, C, H, W,
                 dst + i * (int64_t)C * crop * crop, crop,
                 ys[i], xs[i], flips[i], mean, (int)mean_len);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Batched Datum protobuf parse: n serialized Datum messages (wire format,
// caffe.proto fields: 1 channels, 2 height, 3 width, 4 data(bytes),
// 5 label, 6 float_data, 7 encoded) -> one f32 [n, c, h, w] batch +
// labels.  The native half of the reference's data_reader + C++ protobuf
// path; returns
//   0 ok; -1 malformed wire data; -2 shape mismatch vs (c,h,w);
//   -3 encoded/unsupported payload (caller falls back per-record).
// ---------------------------------------------------------------------------
static inline int dat_varint(const uint8_t* p, int64_t len, int64_t* pos,
                             uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < len && shift < 64) {
        uint8_t b = p[(*pos)++];
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = v; return 0; }
        shift += 7;
    }
    return -1;
}

int sn_parse_datum_batch(const uint8_t* buf, const int64_t* offsets,
                         const int64_t* sizes, int64_t n,
                         int c, int h, int w,
                         float* out, int32_t* labels) {
    const int64_t plane = (int64_t)c * h * w;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = buf + offsets[i];
        const int64_t len = sizes[i];
        int64_t pos = 0;
        int64_t ch = -1, hh = -1, ww = -1;
        const uint8_t* data = nullptr;
        int64_t dlen = 0;
        int64_t fcount = 0;
        bool encoded = false;
        float* dst = out + i * plane;
        labels[i] = 0;
        while (pos < len) {
            uint64_t key;
            if (dat_varint(p, len, &pos, &key)) return -1;
            const int field = (int)(key >> 3);
            const int wire = (int)(key & 7);
            if (wire == 0) {
                uint64_t v;
                if (dat_varint(p, len, &pos, &v)) return -1;
                switch (field) {
                    case 1: ch = (int64_t)v; break;
                    case 2: hh = (int64_t)v; break;
                    case 3: ww = (int64_t)v; break;
                    case 5: labels[i] = (int32_t)v; break;
                    case 7: encoded = v != 0; break;
                    default: break;
                }
            } else if (wire == 2) {
                uint64_t ln;
                if (dat_varint(p, len, &pos, &ln)) return -1;
                // overflow-safe bound: a huge ln must not wrap pos+ln
                if ((int64_t)ln < 0 || (int64_t)ln > len - pos) return -1;
                if (field == 4) {
                    data = p + pos;
                    dlen = (int64_t)ln;
                } else if (field == 6) {  // packed float_data
                    if (ln % 4) return -1;
                    int64_t cnt = (int64_t)ln / 4;
                    if (fcount + cnt > plane) return -2;
                    memcpy(dst + fcount, p + pos, ln);
                    fcount += cnt;
                }
                pos += (int64_t)ln;
            } else if (wire == 5) {
                if (pos + 4 > len) return -1;
                if (field == 6) {  // unpacked float_data element
                    if (fcount >= plane) return -2;
                    memcpy(dst + fcount, p + pos, 4);
                    ++fcount;
                }
                pos += 4;
            } else if (wire == 1) {
                if (pos + 8 > len) return -1;
                pos += 8;
            } else {
                return -1;  // groups/unknown wire types unsupported
            }
        }
        if (encoded) return -3;
        if (ch != c || hh != h || ww != w) return -2;
        if (data != nullptr) {
            if (dlen != plane) return -2;
            for (int64_t j = 0; j < plane; ++j) dst[j] = (float)data[j];
        } else if (fcount != plane) {
            return -2;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Mean-image accumulation: sum a u8/f32 batch into float64 accumulators
// (ComputeMean's per-partition pixel sums).
// ---------------------------------------------------------------------------
int sn_accumulate_mean(const float* images, int64_t n, int64_t plane,
                       double* acc) {
    for (int64_t i = 0; i < n; ++i) {
        const float* img = images + i * plane;
        for (int64_t j = 0; j < plane; ++j) acc[j] += img[j];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode + force-resize to out_h x out_w, planar RGB float output
// (ScaleAndConvert.convertImage semantics: ignore aspect ratio; failed
// decodes are reported, caller drops them like ScaleAndConvert:23-25).
// Bilinear sampling over the decoded image.
// ---------------------------------------------------------------------------
int sn_has_jpeg() {
#ifdef SN_NO_JPEG
    return 0;
#else
    return 1;
#endif
}

#ifdef SN_NO_JPEG
int sn_decode_jpeg_resize(const uint8_t*, int64_t, int, int, float*) {
    return -4;  // built without libjpeg
}
#else
struct sn_jpeg_err {
    struct jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void sn_jpeg_error_exit(j_common_ptr cinfo) {
    sn_jpeg_err* err = (sn_jpeg_err*)cinfo->err;
    longjmp(err->jump, 1);
}

int sn_decode_jpeg_resize(const uint8_t* buf, int64_t len,
                          int out_h, int out_w, float* out /*3*H*W*/) {
    jpeg_decompress_struct cinfo;
    sn_jpeg_err jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = sn_jpeg_error_exit;
    // volatile: must survive longjmp intact (cf. libjpeg example.c)
    uint8_t* volatile pixels = nullptr;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        delete[] pixels;
        return -1;  // undecodable -> caller drops the image
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int W = cinfo.output_width, H = cinfo.output_height;
    const int comps = cinfo.output_components;  // 3 after JCS_RGB
    pixels = new uint8_t[(int64_t)W * H * comps];
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = pixels + (int64_t)cinfo.output_scanline * W * comps;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    // bilinear force-resize to (out_h, out_w), interleaved -> planar
    const float sy = (H > 1 && out_h > 1) ? (float)(H - 1) / (out_h - 1) : 0.f;
    const float sx = (W > 1 && out_w > 1) ? (float)(W - 1) / (out_w - 1) : 0.f;
    for (int y = 0; y < out_h; ++y) {
        float fy = y * sy;
        int y0 = (int)fy;
        int y1 = y0 + 1 < H ? y0 + 1 : y0;
        float wy = fy - y0;
        for (int x = 0; x < out_w; ++x) {
            float fx = x * sx;
            int x0 = (int)fx;
            int x1 = x0 + 1 < W ? x0 + 1 : x0;
            float wx = fx - x0;
            for (int c = 0; c < 3; ++c) {
                float p00 = pixels[((int64_t)y0 * W + x0) * comps + c];
                float p01 = pixels[((int64_t)y0 * W + x1) * comps + c];
                float p10 = pixels[((int64_t)y1 * W + x0) * comps + c];
                float p11 = pixels[((int64_t)y1 * W + x1) * comps + c];
                float v = (1 - wy) * ((1 - wx) * p00 + wx * p01) +
                          wy * ((1 - wx) * p10 + wx * p11);
                out[(int64_t)c * out_h * out_w + (int64_t)y * out_w + x] = v;
            }
        }
    }
    delete[] pixels;
    return 0;
}
#endif  // SN_NO_JPEG

}  // extern "C"
