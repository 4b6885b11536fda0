// Spherical tap sampler (resample WITHOUT the conv) for Hopper (sm_90a).
//
// Replaces spgan_tpu/ops/pallas/sphere_sample.py::sphere_sample_taps
// (kernel body _kernel).  It feeds the training-time sphere convs: the
// sampled taps go through an einsum with the conv weight outside the
// kernel, so weight and style gradients flow exactly.
//
// What it computes, for sample b, tap t, output pixel (r, c), channel k:
//
//   out[b,t,r,c,k] = lerp(lerp(x[b,y0,c0,k], x[b,y1,c0,k], wy),
//                         lerp(x[b,y0,c1,k], x[b,y1,c1,k], wy), fx)
//   c0 = clamp(c + clamp(sx, -M, M-1), 0, W-1)
//   c1 = clamp(c + clamp(sx, -M, M-1) + 1, 0, W-1)
//
// with (y0, y1, wy, sx, fx) = tables[b, r, t] (one table per sample).
// Clamping the column index is exactly the TPU kernel's edge padding by M
// columns.  Numerics follow the TPU kernel: the row mix, then the column
// mix, both in float32 and rounded op by op (no FMA contraction, so the
// result equals the plain PyTorch version bit for bit), then one cast to
// x's dtype.  Output is tap-major (B, K2, H, W, C), contiguous.
//
// Bound on an H100 SXM: every input element becomes K2 = 9 output
// elements, so the op is write-bound: at least one read of x and nine
// writes, (1 + 9) * B*H*W*C * sizeof(T) bytes at 3.35 TB/s (data sheet);
// it does no arithmetic worth counting (6 flops per output element).
//
// Design: one block per output row (b, t, r); its 256 threads stride over
// the W*C contiguous output elements of that row, so neighbouring threads
// write neighbouring addresses and read neighbouring channels of the two
// input rows (which stay in L1/L2 across the row).  The five table
// entries of the row are loaded once into registers.  C is 259 on the
// training path (256 latent + 3 coordinate channels), so pixel rows are
// not 16-byte aligned: every access is one scalar element, with no
// alignment requirement on C.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, rounded op by op like the unfused reference
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sphere_sample_taps_kernel(const T* __restrict__ x, const int* __restrict__ y0t,
                          const int* __restrict__ y1t, const float* __restrict__ wyt,
                          const int* __restrict__ sxt, const float* __restrict__ fxt,
                          T* __restrict__ out, int H, int W, int C, int K2,
                          int margin) {
  const int r = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int ti = (b * H + r) * K2 + t;
  // rows come clamped from the table builder; clamp again so a bad table
  // cannot read out of bounds
  const int y0 = min(max(y0t[ti], 0), H - 1);
  const int y1 = min(max(y1t[ti], 0), H - 1);
  const int sx = min(max(sxt[ti], -margin), margin - 1);
  const float wy = wyt[ti];
  const float fx = fxt[ti];
  const size_t row = (size_t)W * C;
  const T* row0 = x + ((size_t)b * H + y0) * row;
  const T* row1 = x + ((size_t)b * H + y1) * row;
  T* o = out + (((size_t)b * K2 + t) * H + r) * row;
  const int n = W * C;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int c = e / C;
    const int k = e - c * C;
    const int c0 = min(max(c + sx, 0), W - 1);
    const int c1 = min(max(c + sx + 1, 0), W - 1);
    const size_t i0 = (size_t)c0 * C + k;
    const size_t i1 = (size_t)c1 * C + k;
    const float m0 = lerp_rn(to_f32(row0[i0]), to_f32(row1[i0]), wy);
    const float m1 = lerp_rn(to_f32(row0[i1]), to_f32(row1[i1]), wy);
    store(o + e, lerp_rn(m0, m1, fx));
  }
}

}  // namespace

// x (B,H,W,C) and out (B,K2,H,W,C) contiguous, both float32 (dtype 0) or
// both bf16 (dtype 1); tables (B,H,K2) contiguous int32/float32.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int sphere_sample_launch(const void* x, const void* y0, const void* y1,
                                    const void* wy, const void* sx, const void* fx,
                                    void* out, int B, int H, int W, int C, int K2,
                                    int margin, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K2 <= 0 || B > 65535 || K2 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, K2, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* iy0 = static_cast<const int*>(y0);
  const int* iy1 = static_cast<const int*>(y1);
  const float* fwy = static_cast<const float*>(wy);
  const int* isx = static_cast<const int*>(sx);
  const float* ffx = static_cast<const float*>(fx);
  if (dtype == 1) {
    sphere_sample_taps_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), iy0, iy1, fwy, isx, ffx,
        static_cast<__nv_bfloat16*>(out), H, W, C, K2, margin);
  } else if (dtype == 0) {
    sphere_sample_taps_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), iy0, iy1, fwy, isx, ffx,
        static_cast<float*>(out), H, W, C, K2, margin);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
