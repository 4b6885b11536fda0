// PNG scanline unfiltering (filter types 0-4 of the PNG specification,
// section 9) for spgan_tpu_torch/utils/png.py, built with g++ at first use.
//
// Sub and Up vectorise in numpy, but Avg and Paeth read the reconstructed
// byte to the left and the one above, so they run byte by byte: a Python
// loop would take seconds a batch of training panoramas.
//
//   raw:  h rows of 1 + stride bytes (the filter type, then the filtered
//         bytes), as zlib inflates them
//   out:  h rows of stride bytes, the reconstructed scanlines
//   bpp:  bytes per complete pixel (1 gray, 2 gray+alpha, 3 RGB, 4 RGBA,
//         1 palette index)
// Returns 0, or 1 + the index of the first row with a filter type above 4.
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* raw, int h, int stride, int bpp,
                            uint8_t* out) {
  for (int r = 0; r < h; ++r) {
    const uint8_t* src = raw + (size_t)r * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* cur = out + (size_t)r * stride;
    const uint8_t* up = r > 0 ? cur - stride : nullptr;
    switch (type) {
      case 0:
        for (int i = 0; i < stride; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          cur[i] = src[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = src[i] + (uint8_t)((a + b) >> 1);
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = src[i] + (uint8_t)pred;
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
