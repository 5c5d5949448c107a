// Native threaded image loader: JPEG decode + shortest-side-224 resize +
// center crop, C ABI for ctypes.
//
// Replaces the per-image host decode of the reference's read_image_data
// (lrcn.jl:750-773, ImageMagick via Images.jl) for the feature-extraction
// hot path: the TPU encoder sustains ~5k fc7 images/s, which a
// single-threaded Python/PIL decode (~200 images/s) cannot feed.  This
// loader uses libjpeg(-turbo) with DCT scaling (decode at 1/2, 3/8, ...
// resolution when the target is much smaller) and a thread pool.
//
// Geometry matches the reference exactly: new_size = (dim * 224) / min(dims)
// integer arithmetic (lrcn.jl:756), center crop offsets (lrcn.jl:757-759).
// Resampling is plain 2-tap bilinear — the reference's own resampler
// (Images.jl) differs from PIL's anyway; feature parity tolerances absorb it.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kCrop = 224;

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Decode a JPEG to RGB, using DCT scaling to land near (but not below)
// the target shortest side.  Also reports the ORIGINAL dimensions so the
// caller can compute the reference's resize geometry from them (the
// scaled dims can differ by a pixel of rounding).  The source is either
// a file path or an in-memory blob (the serving image endpoint decodes
// request bodies without touching disk).  Returns false on any decode
// error.
bool decode_jpeg(const char* path, const unsigned char* blob,
                 size_t blob_size, std::vector<unsigned char>* pixels,
                 int* width, int* height, int* orig_width,
                 int* orig_height) {
    FILE* f = nullptr;
    if (path != nullptr) {
        f = std::fopen(path, "rb");
        if (!f) return false;
    }

    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        if (f) std::fclose(f);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    if (f) {
        jpeg_stdio_src(&cinfo, f);
    } else {
        jpeg_mem_src(&cinfo, blob, blob_size);
    }
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK -> RGB (lrcn.jl:761)
    *orig_width = static_cast<int>(cinfo.image_width);
    *orig_height = static_cast<int>(cinfo.image_height);

    // Pick the smallest M/8 scale whose shortest side stays >= 224.
    const unsigned min_dim = cinfo.image_width < cinfo.image_height
                                 ? cinfo.image_width
                                 : cinfo.image_height;
    unsigned num = 8;
    if (min_dim > kCrop) {
        for (unsigned m = 1; m <= 8; ++m) {
            if (min_dim * m / 8 >= static_cast<unsigned>(kCrop)) {
                num = m;
                break;
            }
        }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;

    jpeg_start_decompress(&cinfo);
    *width = cinfo.output_width;
    *height = cinfo.output_height;
    pixels->resize(static_cast<size_t>(*width) * *height * 3);
    const size_t stride = static_cast<size_t>(*width) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* row = pixels->data() + cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    if (f) std::fclose(f);
    return true;
}

// Bilinear resize (H,W,3) -> (new_h,new_w,3), PIL-style half-pixel centers.
void resize_bilinear(const unsigned char* src, int h, int w, int new_h,
                     int new_w, unsigned char* dst) {
    const float sy = static_cast<float>(h) / new_h;
    const float sx = static_cast<float>(w) / new_w;
    for (int y = 0; y < new_h; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        int y0 = static_cast<int>(fy);
        int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
        const float wy = fy - y0;
        for (int x = 0; x < new_w; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            if (fx < 0) fx = 0;
            int x0 = static_cast<int>(fx);
            int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
            const float wx = fx - x0;
            for (int c = 0; c < 3; ++c) {
                const float v00 = src[(y0 * w + x0) * 3 + c];
                const float v01 = src[(y0 * w + x1) * 3 + c];
                const float v10 = src[(y1 * w + x0) * 3 + c];
                const float v11 = src[(y1 * w + x1) * 3 + c];
                const float top = v00 + (v01 - v00) * wx;
                const float bot = v10 + (v11 - v10) * wx;
                dst[(y * new_w + x) * 3 + c] =
                    static_cast<unsigned char>(top + (bot - top) * wy + 0.5f);
            }
        }
    }
}

// Full pipeline for one image -> out (224,224,3).  Returns 0 on success.
int load_one(const char* path, const unsigned char* blob, size_t blob_size,
             unsigned char* out) {
    std::vector<unsigned char> pixels;
    int w = 0, h = 0, ow = 0, oh = 0;
    if (!decode_jpeg(path, blob, blob_size, &pixels, &w, &h, &ow, &oh))
        return 1;
    if (w <= 0 || h <= 0 || ow <= 0 || oh <= 0) return 2;
    // reference integer arithmetic (lrcn.jl:756) computed from the
    // ORIGINAL dimensions — DCT-scaled dims round and would shift the
    // target (and thus the center crop) by +/-1 px on some sizes.
    const int m = ow < oh ? ow : oh;
    const int new_h = static_cast<int>(
        static_cast<long long>(oh) * kCrop / m);
    const int new_w = static_cast<int>(
        static_cast<long long>(ow) * kCrop / m);
    std::vector<unsigned char> resized(
        static_cast<size_t>(new_h) * new_w * 3);
    resize_bilinear(pixels.data(), h, w, new_h, new_w, resized.data());
    const int i0 = (new_h - kCrop) / 2;
    const int j0 = (new_w - kCrop) / 2;
    for (int y = 0; y < kCrop; ++y) {
        std::memcpy(out + static_cast<size_t>(y) * kCrop * 3,
                    resized.data() +
                        ((static_cast<size_t>(i0) + y) * new_w + j0) * 3,
                    static_cast<size_t>(kCrop) * 3);
    }
    return 0;
}

}  // namespace

extern "C" {

// Decode+resize+crop n images into out (n,224,224,3) uint8 using a thread
// pool.  status[i] = 0 on success.  Returns the number of failures.
int lrcn_load_images(const char** paths, int n, unsigned char* out,
                     int* status, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            const int rc =
                load_one(paths[i], nullptr, 0,
                         out + static_cast<size_t>(i) * kCrop * kCrop * 3);
            status[i] = rc;
            if (rc) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> threads;
    const int t = n_threads < n ? n_threads : n;
    threads.reserve(t);
    for (int i = 0; i < t; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return failures.load();
}

// In-memory variant for the serving image endpoint: n JPEG blobs
// (request bodies, already base64-decoded) -> out (n,224,224,3) uint8.
// status[i] = 0 on success; returns the number of failures.
int lrcn_load_images_mem(const unsigned char** blobs,
                         const long long* sizes, int n, unsigned char* out,
                         int* status, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) return;
            const int rc =
                load_one(nullptr, blobs[i], static_cast<size_t>(sizes[i]),
                         out + static_cast<size_t>(i) * kCrop * kCrop * 3);
            status[i] = rc;
            if (rc) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> threads;
    const int t = n_threads < n ? n_threads : n;
    threads.reserve(t);
    for (int i = 0; i < t; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return failures.load();
}

}  // extern "C"
