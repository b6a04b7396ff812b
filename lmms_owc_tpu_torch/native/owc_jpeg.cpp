// JPEG decode, alone or followed by the antialiased bicubic resize, on the host.
//
// The port's copy of the JPEG half of lmms_owc_tpu/native/owc_loader.cpp: the
// same libjpeg calls (RGB output), then the resize of owc_resize.cpp, included
// here so both libraries share one copy of its arithmetic. Exposed through
// ctypes; calls release the GIL.
//
// Build: g++ -O3 -shared -fPIC owc_jpeg.cpp -o libowcjpeg.so -ljpeg

#include <csetjmp>
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include "owc_resize.cpp"

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// The dimensions of a JPEG in memory. Returns 0 on success, 1 if it does not decode.
int owc_jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode + resize in one call: JPEG bytes -> uint8 CHW [3, out_h, out_w].
// Returns 0 on success, 1 if the JPEG does not decode.
int owc_decode_resize_jpeg(const uint8_t* data, size_t len, int out_h, int out_w, uint8_t* out_chw) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);

    const int in_h = cinfo.output_height;
    const int in_w = cinfo.output_width;
    std::vector<uint8_t> hwc(static_cast<size_t>(in_h) * in_w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* rowp = &hwc[static_cast<size_t>(cinfo.output_scanline) * in_w * 3];
        jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return owc_resize_u8(hwc.data(), in_h, in_w, 3, out_h, out_w, out_chw);
}

}  // extern "C"
