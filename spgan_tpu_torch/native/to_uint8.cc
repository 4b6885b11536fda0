// The float32 -> uint8 quantisation of rendered images for
// spgan_tpu_torch/infer/managers.py::to_uint8, built with g++ at first use.
//
// Per element it is numpy's clip((x + 1) / 2, 0, 1) * 255 + 0.5, cast to
// uint8, in float32 and in numpy's order, so the bytes are numpy's: the
// halving is a multiplication by 0.5 (the same rounding), the clamps are
// maxps/minps with 0 and 1 second, so NaN becomes 0 as numpy's cast gives
// on x86, and the build passes -ffp-contract=off so no FMA fuses the scale
// and the offset.  The clamped value lies in [0.5, 255.5], so the
// truncating int32 conversion and the saturating packs are exact.
//
// numpy writes four float32 temporaries as large as the input before the
// cast; this is one pass that reads the input and writes the output once.
// The x86 path is SSE2 intrinsics, which every x86-64 CPU has, so the
// library needs no -march=native (GCC does not vectorise the plain loop at
// x86-64's baseline, nor at AVX2: the NaN-preserving clamps are a branch
// there).  Other CPUs take the plain loop.
//
//   x, out:   n contiguous elements
//   threads:  how many threads split the elements (the caller picks it
//             from the size); the calling thread takes the first part
// Returns the number of threads that ran (fewer than asked when the system
// refuses a thread, whose part then runs on the calling thread).
#include <cstddef>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

inline uint8_t quantise(float x) {
  float a = (x + 1.0f) * 0.5f;
  a = a > 0.0f ? a : 0.0f;
  a = a < 1.0f ? a : 1.0f;
  return static_cast<uint8_t>(static_cast<int32_t>(a * 255.0f + 0.5f));
}

#if defined(__SSE2__)
inline __m128i quantise4(const float* p) {
  const __m128 a = _mm_mul_ps(_mm_add_ps(_mm_loadu_ps(p), _mm_set1_ps(1.0f)),
                              _mm_set1_ps(0.5f));
  // max/min return their second operand when the first is NaN
  const __m128 c = _mm_min_ps(_mm_max_ps(a, _mm_setzero_ps()),
                              _mm_set1_ps(1.0f));
  return _mm_cvttps_epi32(
      _mm_add_ps(_mm_mul_ps(c, _mm_set1_ps(255.0f)), _mm_set1_ps(0.5f)));
}
#endif

void quantise_range(const float* x, uint8_t* out, int64_t n) {
  int64_t i = 0;
#if defined(__SSE2__)
  for (; i + 16 <= n; i += 16) {
    const __m128i lo = _mm_packs_epi32(quantise4(x + i), quantise4(x + i + 4));
    const __m128i hi =
        _mm_packs_epi32(quantise4(x + i + 8), quantise4(x + i + 12));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i),
                     _mm_packus_epi16(lo, hi));
  }
#endif
  for (; i < n; ++i) out[i] = quantise(x[i]);
}

}  // namespace

extern "C" int spgan_to_uint8(const float* x, uint8_t* out, int64_t n,
                              int threads) {
  if (threads < 1) threads = 1;
  // parts of whole 64-element blocks (a cache line of output), the last
  // part taking the rest
  const int64_t per = (n / threads) & ~int64_t{63};
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  int ran = 1;
  for (int t = 1; t < threads; ++t) {
    const int64_t lo = t * per, hi = t + 1 == threads ? n : lo + per;
    try {
      pool.emplace_back(quantise_range, x + lo, out + lo, hi - lo);
      ++ran;
    } catch (const std::system_error&) {
      quantise_range(x + lo, out + lo, hi - lo);
    }
  }
  quantise_range(x, out, threads == 1 ? n : per);
  for (std::thread& th : pool) th.join();
  return ran;
}
