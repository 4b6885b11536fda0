// StyleGAN3's filtered LeakyReLU for Hopper (sm_90a): one layer's bias,
// demodulation, upsample, LeakyReLU with gain and clamp, and downsample
// in one pass over its NHWC conv output.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN3, and the port
// composed this op from PyTorch calls (ops/filtered_lrelu.py,
// filtered_lrelu_plain: polyphase depthwise convolutions, interleave
// copies and elementwise passes), which write and re-read the 2-D
// upsampled intermediate, up to 2.68 GB an image.  Here no intermediate
// touches device memory.  The wrapper is ops/kernels/filtered_lrelu.py;
// models/stylegan3.py calls it for each of L0-L13 through
// ops/filtered_lrelu.py::filtered_lrelu on a CUDA tensor.
//
// What it computes, per sample b and channel c (NVlabs'
// _filtered_lrelu_ref order, on the NHWC tensor):
//
//   v   = x[b,:,:,c] * scale[b,c] + bias[c]       (zero outside x)
//   u   = upfirdn(v, fu, up, pads)                (zero-insert, pad, FIR)
//   u   = clamp(u > 0 ? u : slope * u, +-clamp)
//   out = every 2nd sample of the valid FIR of u with fd
//
// The filters are separable, applied along W and then H.  The wrapper
// passes them flipped (a correlation), fu times `up` (gain up**2 over the
// two axes), fd times sqrt(gain) and the clamp divided by gain (the
// plain version folds the gain the same way).  Every step is float32;
// the output is rounded once, to x's dtype (float32 or float16).
//
// Bound on an H100 SXM: float32 FMA.  Per output sample of one channel
// the polyphase FIRs need 66 (up 4) or 72 (up 2) multiply-adds against
// one sample read and one written, so a 1024^2 StyleGAN3-T image takes
// 22.4 GMAC (10.7 ms a batch of 16 at 67 TFLOP/s) and 1.068 GB (5.1 ms
// at 3.35 TB/s; portbench/flops_sg3.py).
//
// Design, against that bound:
// 1. One block, one tile: 26 x 26 output samples of 4 channels.  Its
//    up-domain tile is 62 x 62 (2 * 25 + 12 taps) and its input tile 22
//    (up 4) or 37 (up 2) samples a side, with halo.  Threads take
//    (channel, line) items, channel fastest, so a warp's shared-memory
//    accesses fall on 32 banks.
// 2. Three passes through shared memory, each a register pipeline whose
//    loops the compiler unrolls, so every tap is a constant-bank operand
//    of an FFMA and every sample a register:
//    A  each input row (up 2; each half row for up 4, whose 22 rows
//       would leave most threads idle): scale and bias on load, the
//       polyphase up FIR along W (6 taps an output, only the non-zero
//       ones) -> 62 (31) values;
//    B  each of the 62 up-domain columns: the polyphase up FIR along H,
//       LeakyReLU, gain and clamp, then the down FIR along H into 26
//       accumulators, so the 62 x 62 up-domain tile never exists whole;
//    C  each half of the 26 output rows: the down FIR along W at the
//       kept samples, one rounding, one store.
//    Half rows give passes A and C more items than rows and fewer
//    registers a thread (at most 80, for three blocks an SM): on an H100
//    L0-L13 at a batch of 16 take 58.0 ms, against 64.4 with whole rows.
//    The up FIR's phase at a tile's first up-domain sample is a template
//    argument (0 or 1): the wrapper shifts the tile grid by one output
//    sample where that makes it so.
// 3. Indices are 64-bit: the 1024^2 layers' outputs pass 2^31 bytes at a
//    batch of 16.  One launch a layer, the whole batch.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int CG = 4;             // channels a block
constexpr int THREADS = 256;
constexpr int DOWN = 2;
constexpr int KD = 12;            // down taps at most
constexpr int MAX_KU = 24;        // up taps at most (6 a phase)
constexpr int TO = 26;            // output samples a tile side (even)
constexpr int U = DOWN * (TO - 1) + KD;  // up-domain samples a tile side
// a shared row of U samples of CG channels, padded so that the 8 rows
// a warp's (channel, row) items touch start in 8 different bank quads
constexpr int STRIDE = U * CG + 4;
static_assert((STRIDE / 4) % 2 == 1, "rows must fall on distinct banks");
static_assert(U * CG <= THREADS, "pass B takes a column a thread");

template <int UP>
struct Up {
  static constexpr int KU = 6 * UP;
  // input samples a tile side, the up FIR's phase at its start 0 or 1
  static constexpr int I = (U + KU - 1) / UP + 1;
  static constexpr int SMEM = (I + TO) * STRIDE * 4;
};

struct Params {
  const void* x;
  void* out;
  const float* scale;  // (B, C)
  const float* bias;   // (C,)
  int H, W, C, Ho, Wo;
  int tiles_x;
  int oy0, ox0;        // the first tile's output origin (0 or -1)
  int iy0, ix0;        // its first input sample
  int rby, rbx;        // its up FIR phase (0 or 1)
  float slope, clamp;
  float fu[MAX_KU];    // flipped, zero past the filter's taps
  float fd[KD];
};

__device__ __forceinline__ float load(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __half* p, size_t i) {
  return __half2float(__ldg(p + i));
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__half* p, size_t i, float v) {
  p[i] = __float2half_rn(v);
}

// Pass A: input row ii of the tile (channel c of the item), scaled and
// biased, upsampled along W into s1[ii][J0 .. J0 + NJ)[c]: the whole row
// (PARTS 1) or one of its two halves (PARTS 2, part P).
template <typename T, int UP, int RB, int PARTS, int P>
__device__ __forceinline__ void up_row_part(const Params& p, float* dst,
                                            const T* src, size_t base, int ix,
                                            int cc, float s, float bb,
                                            bool row) {
  constexpr int KU = Up<UP>::KU;
  constexpr int NJ = U / PARTS, J0 = P * NJ;
  constexpr int K0 = (RB + J0) / UP;
  constexpr int NK = (RB + J0 + NJ - 1 + KU - 1) / UP - K0 + 1;
  float in[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int xx = ix + K0 + k;
    in[k] = row && xx >= 0 && xx < p.W
                ? fmaf(load(src, (base + xx) * p.C + cc), s, bb)
                : 0.0f;
  }
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < KU; ++t)
      if ((RB + j + t) % UP == 0)
        v = fmaf(p.fu[t], in[(RB + j + t) / UP - K0], v);
    dst[j * CG] = v;
  }
}

template <typename T, int UP, int RB>
__device__ __forceinline__ void up_rows(const Params& p, float* s1, int b,
                                        int c0, int iy, int ix) {
  constexpr int I = Up<UP>::I;
  constexpr int PARTS = UP == 4 ? 2 : 1;  // up 4: 88 rows, two items each
  static_assert(U % PARTS == 0, "parts split the row evenly");
  for (int item = threadIdx.x; item < PARTS * CG * I; item += THREADS) {
    const int part = item / (CG * I), r = item - part * CG * I;
    const int c = r % CG, ii = r / CG;
    const int cc = c0 + c, y = iy + ii;
    const bool row = cc < p.C && y >= 0 && y < p.H;
    float s = 0.0f, bb = 0.0f;
    if (row) {
      s = p.scale[static_cast<size_t>(b) * p.C + cc];
      bb = p.bias[cc];
    }
    const T* src = static_cast<const T*>(p.x);
    const size_t base = (static_cast<size_t>(b) * p.H + (row ? y : 0)) * p.W;
    float* dst = s1 + ii * STRIDE + c;
    if (part == 0)
      up_row_part<T, UP, RB, PARTS, 0>(p, dst, src, base, ix, cc, s, bb, row);
    else if constexpr (PARTS == 2)
      up_row_part<T, UP, RB, PARTS, 1>(p, dst, src, base, ix, cc, s, bb, row);
  }
}

// Pass B: up-domain column (j, c) = threadIdx.x: upsampled along H,
// LeakyReLU and clamp, down FIR along H into s2[0 .. TO)[j][c].
template <int UP, int RB>
__device__ __forceinline__ void up_down_cols(const Params& p,
                                             const float* s1, float* s2) {
  constexpr int I = Up<UP>::I, KU = Up<UP>::KU;
  const int t0 = threadIdx.x;
  if (t0 >= U * CG) return;
  float col[I];
#pragma unroll
  for (int k = 0; k < I; ++k) col[k] = s1[k * STRIDE + t0];
  float acc[TO];
#pragma unroll
  for (int o = 0; o < TO; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < KU; ++t)
      if ((RB + j + t) % UP == 0) v = fmaf(p.fu[t], col[(RB + j + t) / UP], v);
    v = v > 0.0f ? v : v * p.slope;
    v = fminf(fmaxf(v, -p.clamp), p.clamp);
#pragma unroll
    for (int o = 0; o < TO; ++o) {
      const int t = j - DOWN * o;
      if (t >= 0 && t < KD) acc[o] = fmaf(p.fd[t], v, acc[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < TO; ++o) s2[o * STRIDE + t0] = acc[o];
}

// Pass C: output row o of the tile (channel c of the item), half P of
// its samples: the down FIR along W at the kept samples, rounded once to
// T and stored.
constexpr int QH = (TO + 1) / 2;  // output samples a half row

template <typename T, int P>
__device__ __forceinline__ void down_row_half(const Params& p,
                                              const float* src, T* dst,
                                              size_t base, int ox, int cc) {
  constexpr int Q0 = P * QH, NQ = TO - Q0 < QH ? TO - Q0 : QH;
  constexpr int J0 = DOWN * Q0, NJ = DOWN * (NQ - 1) + KD;
  float row[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) row[j] = src[(J0 + j) * CG];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < KD; ++t) v = fmaf(p.fd[t], row[DOWN * q + t], v);
    const int xx = ox + Q0 + q;
    if (xx >= 0 && xx < p.Wo) store(dst, (base + xx) * p.C + cc, v);
  }
}

template <typename T>
__device__ __forceinline__ void down_rows(const Params& p, const float* s2,
                                          int b, int c0, int oy, int ox) {
  for (int item = threadIdx.x; item < 2 * CG * TO; item += THREADS) {
    const int half = item / (CG * TO), r = item - half * CG * TO;
    const int c = r % CG, o = r / CG;
    const int cc = c0 + c, y = oy + o;
    if (cc >= p.C || y < 0 || y >= p.Ho) continue;
    const float* src = s2 + o * STRIDE + c;
    T* dst = static_cast<T*>(p.out);
    const size_t base = (static_cast<size_t>(b) * p.Ho + y) * p.Wo;
    if (half == 0)
      down_row_half<T, 0>(p, src, dst, base, ox, cc);
    else
      down_row_half<T, 1>(p, src, dst, base, ox, cc);
  }
}

template <typename T, int UP>
__global__ void __launch_bounds__(THREADS, 3)
filtered_lrelu_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  float* s1 = smem;
  float* s2 = smem + Up<UP>::I * STRIDE;
  const int c0 = blockIdx.x * CG;
  const int ty = blockIdx.y / p.tiles_x;
  const int tx = blockIdx.y - ty * p.tiles_x;
  const int b = blockIdx.z;
  // a tile is DOWN * TO up-domain samples, DOWN * TO / UP input samples
  constexpr int STEP = DOWN * TO / UP;
  static_assert(DOWN * TO % UP == 0, "tiles must keep the FIR's phase");
  const int iy = p.iy0 + ty * STEP, ix = p.ix0 + tx * STEP;
  if (p.rbx)
    up_rows<T, UP, 1>(p, s1, b, c0, iy, ix);
  else
    up_rows<T, UP, 0>(p, s1, b, c0, iy, ix);
  __syncthreads();
  if (p.rby)
    up_down_cols<UP, 1>(p, s1, s2);
  else
    up_down_cols<UP, 0>(p, s1, s2);
  __syncthreads();
  down_rows<T>(p, s2, b, c0, p.oy0 + ty * TO, p.ox0 + tx * TO);
}

template <typename T, int UP>
cudaError_t launch(const Params& p, int B, int tiles_y, cudaStream_t stream) {
  constexpr int SMEM = Up<UP>::SMEM;
  static bool ready[64] = {};  // the attribute is set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(filtered_lrelu_kernel<T, UP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const dim3 grid((p.C + CG - 1) / CG, tiles_y * p.tiles_x, B);
  filtered_lrelu_kernel<T, UP><<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,C) and out (B,Ho,Wo,C) contiguous, both float32 (dtype 0) or
// both float16 (dtype 1); scale (B,C) and bias (C,) float32 on the
// device.  fu (ku taps, ku <= 6 * up) and fd (kd <= 12 taps) on the host,
// flipped, gains folded in; clamp divided by the gain (or infinity).
// The tile plan along each axis (ops/kernels/filtered_lrelu.py::
// tile_plan): the first tile's output origin o0, its first input sample
// i0 and the up FIR's phase rb there, and the tiles.  Launches on
// `stream` and returns a cudaError_t.
extern "C" int filtered_lrelu_launch(
    const void* x, void* out, const float* scale, const float* bias, int B,
    int H, int W, int C, int Ho, int Wo, int dtype, int up, const float* fu,
    int ku, const float* fd, int kd, int oy0, int iy0, int rby, int tiles_y,
    int ox0, int ix0, int rbx, int tiles_x, float slope, float clamp,
    void* stream) {
  if (x == nullptr || out == nullptr || scale == nullptr || bias == nullptr ||
      fu == nullptr || fd == nullptr || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || (dtype != 0 && dtype != 1) ||
      (up != 2 && up != 4) || ku <= 0 || ku > 6 * up || kd <= 0 ||
      kd > KD || rby < 0 || rby > 1 || rbx < 0 || rbx > 1 || tiles_y <= 0 ||
      tiles_x <= 0 || static_cast<long long>(tiles_y) * tiles_x > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.out = out;
  p.scale = scale;
  p.bias = bias;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.tiles_x = tiles_x;
  p.oy0 = oy0;
  p.ox0 = ox0;
  p.iy0 = iy0;
  p.ix0 = ix0;
  p.rby = rby;
  p.rbx = rbx;
  p.slope = slope;
  p.clamp = clamp;
  for (int t = 0; t < ku; ++t) p.fu[t] = fu[t];
  for (int t = 0; t < kd; ++t) p.fd[t] = fd[t];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = up == 2 ? launch<float, 2>(p, B, tiles_y, s)
                : launch<float, 4>(p, B, tiles_y, s);
  else
    e = up == 2 ? launch<__half, 2>(p, B, tiles_y, s)
                : launch<__half, 4>(p, B, tiles_y, s);
  return (int)e;
}
