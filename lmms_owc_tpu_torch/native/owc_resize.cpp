// Antialiased bicubic resize of uint8 images, HWC in, CHW out, on the host.
//
// The port's copy of the resize in lmms_owc_tpu/native/owc_loader.cpp (the
// JPEG decode there is not used by the port and is left out, so this file
// needs no libjpeg). Same arithmetic, so the pixels equal the JAX package's.
//
// The resize implements the PIL convention: separable convolution with the bicubic
// kernel (a = -0.5), kernel support scaled by the downscale factor (antialiasing),
// per-output-pixel weight normalization — numerically within rounding of
// PIL.Image.resize(..., BICUBIC). Exposed through ctypes; calls release the GIL.
//
// Build: g++ -O3 -shared -fPIC owc_resize.cpp -o libowcresize.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double bicubic_filter(double x) {
    // PIL's bicubic: a = -0.5 (Catmull-Rom family).
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Precompute per-output-pixel taps for one axis (PIL precompute_coeffs).
struct AxisTaps {
    int ksize;
    std::vector<int> bounds;       // [out] start index
    std::vector<double> weights;   // [out * ksize]
};

AxisTaps compute_taps(int in_size, int out_size) {
    AxisTaps taps;
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 2.0 * filterscale;  // bicubic support = 2
    taps.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    taps.bounds.resize(out_size);
    taps.weights.assign(static_cast<size_t>(out_size) * taps.ksize, 0.0);

    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
        int xmax = static_cast<int>(std::min(static_cast<double>(in_size), std::ceil(center + support)));
        double total = 0.0;
        double* w = &taps.weights[static_cast<size_t>(xx) * taps.ksize];
        for (int x = xmin; x < xmax; ++x) {
            double weight = bicubic_filter((x + 0.5 - center) / filterscale);
            w[x - xmin] = weight;
            total += weight;
        }
        if (total != 0.0) {
            for (int x = 0; x < xmax - xmin; ++x) w[x] /= total;
        }
        taps.bounds[xx] = xmin;
    }
    return taps;
}

inline uint8_t clip8(double v) {
    return static_cast<uint8_t>(std::min(255.0, std::max(0.0, std::round(v))));
}

// Separable resize HWC uint8 -> HWC uint8.
void resize_bicubic(const uint8_t* src, int in_h, int in_w, int channels,
                    uint8_t* dst, int out_h, int out_w) {
    AxisTaps xt = compute_taps(in_w, out_w);
    AxisTaps yt = compute_taps(in_h, out_h);

    // Horizontal pass into a float intermediate [in_h, out_w, C].
    std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * channels);
    for (int y = 0; y < in_h; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * in_w * channels;
        float* out_row = &tmp[static_cast<size_t>(y) * out_w * channels];
        for (int xx = 0; xx < out_w; ++xx) {
            const double* w = &xt.weights[static_cast<size_t>(xx) * xt.ksize];
            int x0 = xt.bounds[xx];
            for (int c = 0; c < channels; ++c) {
                double acc = 0.0;
                for (int k = 0; k < xt.ksize; ++k) {
                    int x = x0 + k;
                    if (x >= in_w || w[k] == 0.0) continue;
                    acc += row[static_cast<size_t>(x) * channels + c] * w[k];
                }
                out_row[static_cast<size_t>(xx) * channels + c] = static_cast<float>(acc);
            }
        }
    }

    // Vertical pass to the output [out_h, out_w, C].
    for (int yy = 0; yy < out_h; ++yy) {
        const double* w = &yt.weights[static_cast<size_t>(yy) * yt.ksize];
        int y0 = yt.bounds[yy];
        uint8_t* out_row = dst + static_cast<size_t>(yy) * out_w * channels;
        for (int xx = 0; xx < out_w; ++xx) {
            for (int c = 0; c < channels; ++c) {
                double acc = 0.0;
                for (int k = 0; k < yt.ksize; ++k) {
                    int y = y0 + k;
                    if (y >= in_h || w[k] == 0.0) continue;
                    acc += tmp[(static_cast<size_t>(y) * out_w + xx) * channels + c] * w[k];
                }
                out_row[static_cast<size_t>(xx) * channels + c] = clip8(acc);
            }
        }
    }
}

}  // namespace

extern "C" {

// Resize raw uint8 HWC pixels (any channel count) -> uint8 CHW.
int owc_resize_u8(const uint8_t* src_hwc, int in_h, int in_w, int channels,
                  int out_h, int out_w, uint8_t* out_chw) {
    std::vector<uint8_t> resized(static_cast<size_t>(out_h) * out_w * channels);
    resize_bicubic(src_hwc, in_h, in_w, channels, resized.data(), out_h, out_w);
    for (int c = 0; c < channels; ++c) {
        uint8_t* plane = out_chw + static_cast<size_t>(c) * out_h * out_w;
        for (int y = 0; y < out_h; ++y) {
            for (int x = 0; x < out_w; ++x) {
                plane[static_cast<size_t>(y) * out_w + x] =
                    resized[(static_cast<size_t>(y) * out_w + x) * channels + c];
            }
        }
    }
    return 0;
}

}  // extern "C"
