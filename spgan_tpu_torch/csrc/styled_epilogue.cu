// The styled conv's epilogue for Hopper (sm_90a): demodulation, noise,
// bias, LeakyReLU and gain of an NHWC conv output in one pass.
//
// Replaces no TPU kernel: the JAX package leaves these five elementwise
// steps to XLA, which fuses them into the convolution's consumer
// (spgan_tpu/ops/modulated.py).  PyTorch runs each as a pass of its own
// over the full tensor, and the ones whose operand is broadcast (demod
// over (h, w), noise over channels, bias over (b, h, w)) take its
// non-vectorised elementwise loop.  The wrapper is
// ops/kernels/styled_epilogue.py; StyledConv.apply (ops/modulated.py)
// calls it outside autograd on a CUDA tensor.
//
// What it computes, for sample b, pixel (h, w), channel c:
//
//   t = y[b,h,w,c] * demod[b,c]
//   t = t + nw * noise[b,h,w]            (when a noise map is given)
//   t = t + bias[c]
//   out[b,h,w,c] = gain * (t > 0 ? t : slope * t)
//
// in float32, each step rounded as PyTorch's float32 ops round it (no
// FMA contraction), and one rounding to the output's dtype (float32 or
// bf16).  demod, bias and nw are float32 on the device: nothing is read
// back to the host.  out may be y (the wrapper writes in place).
//
// Bound on an H100 SXM: bytes.  About six float32 operations an element
// against one element read and one written; the noise map is 1/C of that
// and demod and bias are (B, C) and (C,).  So the least time is one read
// of y and one write of out at 3.35 TB/s (data sheet).
//
// Design, against that bound:
// 1. 16-byte vectors, channels innermost.  A thread owns one 16-byte
//    channel vector (8 bf16 or 4 float32 channels) of a pixel; the NV =
//    C / V threads of a pixel are consecutive, so a warp's loads and
//    stores are whole 128-byte lines.
// 2. The broadcast operands stay in registers.  A block serves one sample
//    b and a tile of its pixels; every thread keeps its channel vector
//    fixed, so it loads its V demod and V bias values once, and then
//    only the y vector and one noise scalar a pixel.  No division in the
//    loop: the block's sample is blockIdx.y.
// 3. Several vectors in flight.  A thread loads IT vectors (IT pixels,
//    PPB apart) before it computes any, and a block walks its tile in
//    steps of IT * PPB pixels.  y is loaded and out stored with the
//    streaming hint (ld/st.global.cs): each is touched once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;    // a block's threads when NV divides them
constexpr int MAX_THREADS = 1024;
constexpr int IT = 4;           // vectors a thread has in flight
constexpr int MAX_ROUNDS = 16;  // steps of IT * PPB pixels a block walks

template <int ES> struct Elem;
template <> struct Elem<4> {
  static constexpr int V = 4;
  __device__ static float noise(const void* p, size_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
};
template <> struct Elem<2> {
  static constexpr int V = 8;
  __device__ static float noise(const void* p, size_t i) {
    const unsigned short b = __ldg(static_cast<const unsigned short*>(p) + i);
    return __uint_as_float(static_cast<uint32_t>(b) << 16);  // exact
  }
};

__device__ __forceinline__ float finish(float t, float d, float n, float bias,
                                        float slope, float gain) {
  t = __fmul_rn(t, d);
  t = __fadd_rn(t, n);  // n is 0 without noise: t + 0 is t
  t = __fadd_rn(t, bias);
  t = t > 0.0f ? t : __fmul_rn(t, slope);
  return __fmul_rn(t, gain);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int ES>
__global__ void __launch_bounds__(MAX_THREADS)
styled_elementwise_epilogue(const uint4* y, uint4* out,
                            const float* __restrict__ demod,
                            const float* __restrict__ bias,
                            const void* __restrict__ noise,
                            const float* __restrict__ nw, int HW, int C,
                            int ppb, int tile, float slope, float gain) {
  constexpr int V = Elem<ES>::V;
  const int nv = C / V;
  const int cv = threadIdx.x % nv;
  const int py = threadIdx.x / nv;  // the block has nv * ppb threads
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, HW);

  float d[V], bs[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    d[e] = demod[static_cast<size_t>(b) * C + cv * V + e];
    bs[e] = bias[cv * V + e];
  }
  const float w = noise != nullptr ? *nw : 0.0f;
  const size_t pix0 = static_cast<size_t>(b) * HW;

  for (int p0 = t0 + py; p0 < t1; p0 += IT * ppb) {
    uint4 v[IT];
    float n[IT];
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int p = p0 + k * ppb;
      if (p < t1) {
        v[k] = __ldcs(y + (pix0 + p) * nv + cv);
        n[k] = noise != nullptr
                   ? __fmul_rn(w, Elem<ES>::noise(noise, pix0 + p))
                   : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int p = p0 + k * ppb;
      if (p >= t1) continue;
      const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (ES == 4) {
          r[i] = __float_as_uint(finish(__uint_as_float(u[i]), d[i], n[k],
                                        bs[i], slope, gain));
        } else {
          const float lo = finish(__uint_as_float(u[i] << 16), d[2 * i], n[k],
                                  bs[2 * i], slope, gain);
          const float hi = finish(__uint_as_float(u[i] & 0xffff0000u),
                                  d[2 * i + 1], n[k], bs[2 * i + 1], slope,
                                  gain);
          r[i] = bf16_bits(lo) | (bf16_bits(hi) << 16);
        }
      }
      __stcs(out + (pix0 + p) * nv + cv, make_uint4(r[0], r[1], r[2], r[3]));
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;  // an H100 SXM
  }
  return n;
}

}  // namespace

// y and out (B,H,W,C) contiguous and 16-byte aligned, both float32
// (dtype 0) or both bf16 (dtype 1); out may be y.  demod (B,C), bias (C,)
// and nw (one value) float32 on the device; noise (B,H,W) in y's dtype,
// or noise and nw both null.  HW = H * W.  Launches on `stream` and
// returns a cudaError_t.
extern "C" int styled_epilogue_launch(const void* y, void* out,
                                      const float* demod, const float* bias,
                                      const void* noise, const float* nw,
                                      int B, int HW, int C, int dtype,
                                      float slope, float gain, void* stream) {
  const int V = dtype == 1 ? 8 : 4;
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % V != 0 ||
      C / V > MAX_THREADS || (dtype != 0 && dtype != 1) || demod == nullptr ||
      bias == nullptr || (noise == nullptr) != (nw == nullptr) ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int nv = C / V;
  int ppb = nv >= THREADS ? 1 : THREADS / nv;  // pixels a block step
  const int threads = nv * ppb;
  // enough blocks for four waves of full SMs, each walking up to
  // MAX_ROUNDS steps of IT * ppb pixels
  const long long per_round = static_cast<long long>(IT) * ppb;
  const long long steps = (HW + per_round - 1) / per_round;
  const long long want = 4LL * sm_count() * (2048 / threads);
  long long rounds = (static_cast<long long>(B) * steps) / want;
  rounds = rounds < 1 ? 1 : (rounds > MAX_ROUNDS ? MAX_ROUNDS : rounds);
  int tile = static_cast<int>(per_round * rounds);
  const unsigned tiles = static_cast<unsigned>((HW + tile - 1) / tile);
  const uint4* yp = static_cast<const uint4*>(y);
  uint4* op = static_cast<uint4*>(out);
  void* args[] = {&yp, &op, &demod, &bias, &noise, &nw, &HW, &C, &ppb, &tile,
                  &slope, &gain};
  const void* fn = dtype == 1
                       ? reinterpret_cast<const void*>(
                             styled_elementwise_epilogue<2>)
                       : reinterpret_cast<const void*>(
                             styled_elementwise_epilogue<4>);
  cudaError_t e = cudaLaunchKernel(fn, dim3(tiles, static_cast<unsigned>(B)),
                                   dim3(threads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
