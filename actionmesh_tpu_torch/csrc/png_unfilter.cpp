// PNG scanline unfiltering (PNG specification, section 9): the five filter
// types of filter method 0, applied row after row. A plain C interface,
// loaded with ctypes by utils/native.py; built with g++ at first use.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// `in`: `height` rows of 1 filter-type byte + `stride` filtered bytes;
// `out`: `height` rows of `stride` bytes; `bpp`: bytes per complete pixel
// (at least 1). Returns 0, or 1 + the first row whose filter type is not 0-4.
extern "C" int64_t png_unfilter(const uint8_t* in, int64_t height, int64_t stride, int64_t bpp,
                                uint8_t* out) {
  uint8_t* zero = static_cast<uint8_t*>(calloc(stride > 0 ? stride : 1, 1));
  if (zero == nullptr) return -1;
  const uint8_t* prev = zero;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* f = in + y * (stride + 1);
    const uint8_t type = f[0];
    ++f;
    uint8_t* x = out + y * stride;
    switch (type) {
      case 0:
        memcpy(x, f, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) x[i] = f[i] + (i >= bpp ? x[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) x[i] = f[i] + prev[i];
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i)
          x[i] = f[i] + static_cast<uint8_t>(((i >= bpp ? x[i - bpp] : 0) + prev[i]) >> 1);
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i)
          x[i] = f[i] + (i >= bpp ? paeth(x[i - bpp], prev[i], prev[i - bpp]) : paeth(0, prev[i], 0));
        break;
      default:
        free(zero);
        return y + 1;
    }
    prev = x;
  }
  free(zero);
  return 0;
}
