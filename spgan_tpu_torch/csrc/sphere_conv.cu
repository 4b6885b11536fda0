// Fused spherical resample + stride-3 conv for Hopper (sm_90a).
//
// Replaces spgan_tpu/ops/pallas/sphere_kernel.py::fused_sphere_conv_grouped
// (kernel body _kernel_grouped) and ::fused_sphere_conv (_kernel).  One
// kernel serves both: the offset tables are indexed by g = b / Bg, with
// Bg = B / G consecutive samples sharing a table (Bg = 1: per-sample).
//
// What it computes, for output pixel (b, r, c) and output channel o:
//
//   out[b,r,c,o] = sum_t sum_k tap_t[b,r,c,k] * w9[t,k,o]
//   tap_t = lerp_x(lerp_y(x[b,y0,:,k], x[b,y1,:,k], wy)[col0],
//                  lerp_y(...)[col1], fx)
//   col0 = clamp(c + clamp(sx, -M, M-1), 0, W-1)
//   col1 = clamp(c + clamp(sx, -M, M-1) + 1, 0, W-1)
//
// with (y0, y1, wy, sx, fx) = tables[g, r, t].  Clamping the column index
// is exactly the TPU kernel's edge padding by M columns.  Numerics follow
// the TPU kernel: both lerps in float32 (no FMA contraction, so the taps
// equal the plain PyTorch version's bit for bit), the tap rounded once to
// bf16 under bf16, taps accumulated in float32, the output cast to x's
// dtype.
//
// Design: an implicit GEMM with M = B*H*W output pixels, K = K2*C, N = Cout.
// A block owns BM = 64 consecutive pixels x BN = 128 output channels.  For
// each tap and each BK = 32 channel chunk it builds the A tile in shared
// memory from the two input rows (4 threads per pixel, 8 channels each,
// 16-byte loads), stages the w9[t] chunk, and multiplies:
//   bf16:  WMMA 16x16x16 bf16 tensor-core tiles, float32 accumulators;
//   f32:   float32 FMA on the CUDA cores (tensor cores would be TF32).
// Nothing is double-buffered yet: TMA / wgmma / a persistent grid are
// later work.
//
// Bound on an H100 SXM at the panorama engine's shapes (B=64, C=Cout=256,
// H=W in {35,29,23,17}, bf16): 2*B*H*W*9*C*Cout FLOPs per launch against
// ~9*C*Cout*2 + B*H*W*(C+Cout)*2 bytes, i.e. ~1,100 FLOPs per byte, far
// above the card's ~295 FLOP/byte balance point: compute-bound, 989
// TFLOP/s dense bf16 (data sheet).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

struct Params {
  const void* x;
  const int* y0;
  const int* y1;
  const float* wy;
  const int* sx;
  const float* fx;
  const void* w9;
  void* out;
  int B, H, W, C, Cout, K2, Bg, margin;
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, rounded op by op like the unfused reference
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

// Where one pixel reads for one tap.
template <typename T>
struct TapSrc {
  const T* r0c0;
  const T* r0c1;
  const T* r1c0;
  const T* r1c1;
  float wy, fx;
  bool valid;
};

template <typename T>
__device__ __forceinline__ TapSrc<T> tap_src(const Params& p, int m, int t) {
  TapSrc<T> s;
  const int HW = p.H * p.W;
  s.valid = m < p.B * HW;
  if (!s.valid) {
    s.r0c0 = s.r0c1 = s.r1c0 = s.r1c1 = nullptr;
    s.wy = s.fx = 0.f;
    return s;
  }
  const int b = m / HW;
  const int rem = m - b * HW;
  const int r = rem / p.W;
  const int c = rem - r * p.W;
  const int ti = ((b / p.Bg) * p.H + r) * p.K2 + t;
  // rows come clamped from the table builder; clamp again so a bad table
  // cannot read out of bounds
  const int y0 = min(max(p.y0[ti], 0), p.H - 1);
  const int y1 = min(max(p.y1[ti], 0), p.H - 1);
  const int sx = min(max(p.sx[ti], -p.margin), p.margin - 1);
  const int c0 = min(max(c + sx, 0), p.W - 1);
  const int c1 = min(max(c + sx + 1, 0), p.W - 1);
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * HW * p.C;
  s.r0c0 = xb + ((size_t)y0 * p.W + c0) * p.C;
  s.r0c1 = xb + ((size_t)y0 * p.W + c1) * p.C;
  s.r1c0 = xb + ((size_t)y1 * p.W + c0) * p.C;
  s.r1c1 = xb + ((size_t)y1 * p.W + c1) * p.C;
  s.wy = p.wy[ti];
  s.fx = p.fx[ti];
  return s;
}

// 8 tap values of channels [k, k+8) for one pixel (zeros out of range).
template <typename T>
__device__ __forceinline__ void tap8(const TapSrc<T>& s, int k, int C,
                                     float out[8]) {
  if (!s.valid || k >= C) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = 0.f;
    return;
  }
  float a0[8], a1[8], b0[8], b1[8];
  load8(s.r0c0 + k, a0);
  load8(s.r0c1 + k, a1);
  load8(s.r1c0 + k, b0);
  load8(s.r1c1 + k, b1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m0 = lerp_rn(a0[i], b0[i], s.wy);  // rows mixed at col0
    const float m1 = lerp_rn(a1[i], b1[i], s.wy);  // rows mixed at col1
    out[i] = lerp_rn(m0, m1, s.fx);
  }
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(THREADS)
sphere_conv_bf16(Params p) {
  using namespace nvcuda;
  constexpr int LDA = BK + 8;   // bf16 elements, multiple of 8
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;   // float elements, multiple of 4
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;          // 2 warps along M (32 rows each)
  const int wn = warp % 4;          // 4 warps along N (32 cols each)
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ap = tid / 4;           // A-build pixel
  const int ak = (tid % 4) * 8;     // A-build channel offset in the chunk
  const __nv_bfloat16* w9 = static_cast<const __nv_bfloat16*>(p.w9);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < p.K2; ++t) {
    const TapSrc<__nv_bfloat16> src = tap_src<__nv_bfloat16>(p, m0 + ap, t);
    const __nv_bfloat16* wt = w9 + (size_t)t * p.C * p.Cout;
    for (int kc = 0; kc < p.C; kc += BK) {
      float v[8];
      tap8(src, kc + ak, p.C, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[ap * LDA + ak + i] = __float2bfloat16_rn(v[i]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = tid / 16 + half * 16;
        const int nn = (tid % 16) * 8;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (kc + kk < p.C && n0 + nn < p.Cout)
          u = *reinterpret_cast<const uint4*>(wt + (size_t)(kc + kk) * p.Cout + n0 + nn);
        *reinterpret_cast<uint4*>(Bs + kk * LDB + nn) = u;
      }
      __syncthreads();
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + k16, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + k16 * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: fragments -> shared float tile -> bf16 NHWC rows
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const int M = p.B * p.H * p.W;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int chunk = tid; chunk < BM * BN / 8; chunk += THREADS) {
    const int row = chunk / (BN / 8);
    const int col = (chunk % (BN / 8)) * 8;
    if (m0 + row >= M || n0 + col >= p.Cout) continue;
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16_rn(Cs[row * LDC + col + i]);
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * p.Cout + n0 + col) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// ---------------------------------------------------------------- f32
__global__ void __launch_bounds__(THREADS)
sphere_conv_f32(Params p) {
  constexpr int LDA = BM + 4;   // A stored k-major: As[k][m]
  constexpr int LDB = BN + 4;
  __shared__ __align__(16) float As[BK * LDA];
  __shared__ __align__(16) float Bs[BK * LDB];

  const int tid = threadIdx.x;
  const int ty = tid / 16;          // rows ty*4 .. ty*4+3
  const int tx = tid % 16;          // cols tx*4 .. +3 and 64+tx*4 .. +3
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ap = tid / 4;
  const int ak = (tid % 4) * 8;
  const float* w9 = static_cast<const float*>(p.w9);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < p.K2; ++t) {
    const TapSrc<float> src = tap_src<float>(p, m0 + ap, t);
    const float* wt = w9 + (size_t)t * p.C * p.Cout;
    for (int kc = 0; kc < p.C; kc += BK) {
      float v[8];
      tap8(src, kc + ak, p.C, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[(ak + i) * LDA + ap] = v[i];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = tid / 16 + half * 16;
        const int nn = (tid % 16) * 8;
        float b[8];
        if (kc + kk < p.C && n0 + nn < p.Cout) {
          load8(wt + (size_t)(kc + kk) * p.Cout + n0 + nn, b);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) b[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[kk * LDB + nn + i] = b[i];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(As + k * LDA + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDB + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * LDB + 64 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int M = p.B * p.H * p.W;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= p.Cout) continue;
      *reinterpret_cast<float4*>(out + (size_t)m * p.Cout + n) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                      acc[i][h * 4 + 3]);
    }
  }
}

}  // namespace

// x (B,H,W,C), w9 (K2,C,Cout) and out (B,H,W,Cout) contiguous, all float32
// (dtype 0) or all bf16 (dtype 1); tables (G,H,K2) contiguous int32/float32
// with G = B / Bg.  C and Cout multiples of 8, pointers 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sphere_conv_launch(const void* x, const void* y0, const void* y1,
                                  const void* wy, const void* sx, const void* fx,
                                  const void* w9, void* out, int B, int H, int W,
                                  int C, int Cout, int K2, int Bg, int margin,
                                  int dtype, void* stream) {
  Params p;
  p.x = x;
  p.y0 = static_cast<const int*>(y0);
  p.y1 = static_cast<const int*>(y1);
  p.wy = static_cast<const float*>(wy);
  p.sx = static_cast<const int*>(sx);
  p.fx = static_cast<const float*>(fx);
  p.w9 = w9;
  p.out = out;
  p.B = B; p.H = H; p.W = W; p.C = C; p.Cout = Cout; p.K2 = K2;
  p.Bg = Bg; p.margin = margin;
  const int M = B * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    sphere_conv_bf16<<<grid, THREADS, 0, s>>>(p);
  } else if (dtype == 0) {
    sphere_conv_f32<<<grid, THREADS, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
