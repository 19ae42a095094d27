// PNG scanline unfiltering (host runtime of msckf_tpu_torch/data/imageio.py).
//
// A PNG's inflated image data is one filter-type byte and `stride` filtered
// bytes per row. None, Sub and Up vectorize in numpy; Average and Paeth
// predict each byte from the byte to its left after that one is
// reconstructed, a serial chain that a Python loop runs at about a
// microsecond a byte. This is that loop in C++, for all five filters, so a
// frame is unfiltered in one call. imageio.py::unfilter_plain is the same
// arithmetic in numpy and Python, and the tests hold the two bitwise equal.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a);
    const int pb = std::abs(p - b);
    const int pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// in: h rows of (1 + stride) bytes (filter type, filtered bytes); out: h *
// stride reconstructed bytes; bpp: bytes per complete pixel (at least 1).
// Returns 0, or 1 + the first row whose filter type is not 0..4.
int64_t png_unfilter(const uint8_t* in, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t ft = in[r * (stride + 1)];
        const uint8_t* f = in + r * (stride + 1) + 1;
        uint8_t* cur = out + r * stride;
        const uint8_t* up = r > 0 ? cur - stride : nullptr;
        switch (ft) {
            case 0:
                std::memcpy(cur, f, stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(f[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(f[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    cur[i] = static_cast<uint8_t>(f[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(f[i] + paeth(a, b, c));
                }
                break;
            default:
                return r + 1;
        }
    }
    return 0;
}

}  // extern "C"
