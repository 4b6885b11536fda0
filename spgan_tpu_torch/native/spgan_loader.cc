// The port's copy of the native data loader (the JAX package's
// native/spgan_loader.cc, the same arithmetic, so that both packages make
// the same batches from the same record file and seed).
//
// A single C++ library that memory-maps a packed record file ("SPR1":
// fixed-size uint8 RGB images) and assembles full training batches —
// center-square crop, bilinear resize to full_size, random horizontal flip,
// random patch crop with auxiliary-coordinate labels, [-1,1] float32
// normalization — in one pass.  It resizes once, bilinearly: it does not
// apply extra_pre_resize, nor the Python pipeline's Lanczos resize.
//
// Exposed as a C API (ctypes-bound from spgan_tpu_torch/data/native_loader.py).
//
// Behavioral parity (reference dataset.py):
//   - MaybeResize          :95-114  (center square + resize)
//   - RandomHorizontalFlip :490-497
//   - CropPatch            :117-270 (ac_coords with the (input-patch-1)
//                                    denominators, raw/sin/cos projection)
//   - Normalize to [-1,1]  :507-512
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x31525053;  // "SPR1"

struct Dataset {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  uint64_t n = 0;
  uint32_t h = 0, w = 0, c = 0;
  const uint8_t* img(uint64_t i) const {
    return base + 24 + static_cast<size_t>(i) * h * w * c;
  }
};

// xorshift128+ — fast, reproducible
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ull;
    s1 = (seed << 1) | 1;
    for (int i = 0; i < 8; i++) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  uint32_t below(uint32_t n) { return n ? next() % n : 0; }
  float uniform() { return (next() >> 11) * (1.0f / 9007199254740992.0f); }
};

// bilinear resize (align corners like cv2 INTER_LINEAR pixel-center model)
void resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 >= sh) y1 = sh - 1;
    if (y0 >= sh) y0 = sh - 1;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(floorf(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 >= sw) x1 = sw - 1;
      if (x0 >= sw) x0 = sw - 1;
      for (int k = 0; k < c; ++k) {
        float v00 = src[(y0 * sw + x0) * c + k];
        float v01 = src[(y0 * sw + x1) * c + k];
        float v10 = src[(y1 * sw + x0) * c + k];
        float v11 = src[(y1 * sw + x1) * c + k];
        float top = v00 * (1 - wx) + v01 * wx;
        float bot = v10 * (1 - wx) + v11 * wx;
        dst[(y * dw + x) * c + k] =
            static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle (or null on failure).
void* spr_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* ds = new Dataset();
  ds->fd = fd;
  ds->base = static_cast<const uint8_t*>(mem);
  ds->mapped = st.st_size;
  uint32_t magic;
  memcpy(&magic, ds->base, 4);
  memcpy(&ds->n, ds->base + 4, 8);
  memcpy(&ds->h, ds->base + 12, 4);
  memcpy(&ds->w, ds->base + 16, 4);
  memcpy(&ds->c, ds->base + 20, 4);
  if (magic != kMagic || ds->c != 3 ||
      ds->mapped < 24 + (size_t)ds->n * ds->h * ds->w * ds->c) {
    munmap(mem, st.st_size);
    close(fd);
    delete ds;
    return nullptr;
  }
  return ds;
}

void spr_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  if (!ds) return;
  munmap(const_cast<uint8_t*>(ds->base), ds->mapped);
  close(ds->fd);
  delete ds;
}

uint64_t spr_size(void* handle) {
  return static_cast<Dataset*>(handle)->n;
}

// Assemble one training batch.
//   patch_out: batch*patch*patch*3 float32 in [-1,1]
//   ac_out:    batch*3 float32 (raw x, sin(pi*y'), cos(pi*y'))
//   full_out:  batch*full*full*3 float32 in [-1,1], may be null
// Returns 0 on success.
int spr_make_batch(void* handle, int batch, int full_size, int patch_size,
                   uint64_t seed, float* patch_out, float* ac_out,
                   float* full_out) {
  auto* ds = static_cast<Dataset*>(handle);
  if (!ds || full_size <= 0 || patch_size > full_size) return 1;
  Rng rng(seed);
  const int H = ds->h, W = ds->w;
  const int side = H < W ? H : W;
  std::vector<uint8_t> square(static_cast<size_t>(side) * side * 3);
  std::vector<uint8_t> resized(static_cast<size_t>(full_size) * full_size * 3);

  const int span = full_size - patch_size;
  const float denom = static_cast<float>(full_size - patch_size - 1);
  for (int b = 0; b < batch; ++b) {
    const uint8_t* img = ds->img(rng.below(static_cast<uint32_t>(ds->n)));
    // center square crop
    const int ty = (H - side) / 2, tx = (W - side) / 2;
    for (int y = 0; y < side; ++y)
      memcpy(&square[static_cast<size_t>(y) * side * 3],
             img + ((ty + y) * W + tx) * 3, static_cast<size_t>(side) * 3);
    // resize
    resize_bilinear(square.data(), side, side, 3, resized.data(), full_size,
                    full_size);
    // random horizontal flip
    if (rng.uniform() < 0.5f) {
      for (int y = 0; y < full_size; ++y)
        for (int x = 0; x < full_size / 2; ++x)
          for (int k = 0; k < 3; ++k)
            std::swap(resized[(y * full_size + x) * 3 + k],
                      resized[(y * full_size + (full_size - 1 - x)) * 3 + k]);
    }
    // full image out
    if (full_out) {
      float* fo = full_out + static_cast<size_t>(b) * full_size * full_size * 3;
      for (size_t i = 0; i < resized.size(); ++i)
        fo[i] = resized[i] / 127.5f - 1.0f;
    }
    // random patch crop + ac coords
    const int xst = span > 0 ? static_cast<int>(rng.below(span)) : 0;
    const int yst = span > 0 ? static_cast<int>(rng.below(span)) : 0;
    float* po = patch_out + static_cast<size_t>(b) * patch_size * patch_size * 3;
    for (int y = 0; y < patch_size; ++y)
      for (int x = 0; x < patch_size; ++x)
        for (int k = 0; k < 3; ++k)
          po[(y * patch_size + x) * 3 + k] =
              resized[((xst + y) * full_size + (yst + x)) * 3 + k] / 127.5f -
              1.0f;
    const float rx = xst / denom * 2.0f - 1.0f;
    const float ry = yst / denom * 2.0f - 1.0f;
    ac_out[b * 3 + 0] = rx;
    ac_out[b * 3 + 1] = sinf(ry * static_cast<float>(M_PI));
    ac_out[b * 3 + 2] = cosf(ry * static_cast<float>(M_PI));
  }
  return 0;
}

// Write a SPR1 file from a raw (n,h,w,3) uint8 buffer.
int spr_write(const char* path, const uint8_t* data, uint64_t n, uint32_t h,
              uint32_t w) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  uint32_t magic = kMagic, c = 3;
  fwrite(&magic, 4, 1, f);
  fwrite(&n, 8, 1, f);
  fwrite(&h, 4, 1, f);
  fwrite(&w, 4, 1, f);
  fwrite(&c, 4, 1, f);
  size_t total = static_cast<size_t>(n) * h * w * 3;
  size_t written = fwrite(data, 1, total, f);
  fclose(f);
  return written == total ? 0 : 2;
}

}  // extern "C"
