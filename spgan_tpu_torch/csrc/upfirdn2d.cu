// upfirdn2d for Hopper (sm_90a): zero-insert upsample, pad or crop, FIR
// filter and subsample of an NHWC tensor, in one pass.
//
// Replaces no TPU kernel: the JAX package runs upfirdn2d as XLA's
// depthwise convolution (spgan_tpu/ops/upfirdn.py).  The counterpart is
// the reference's models/custom_ops/upfirdn2d_kernel.cu.  The port needs
// it because a depthwise F.conv2d is slow twice over on this card: cuDNN
// runs float32 depthwise convs on an indexed implicit GEMM between layout
// transposes, and PyTorch's double backward of a grouped convolution (R1,
// PPL) issues one convolution per channel.  The wrapper
// (ops/kernels/upfirdn.py) makes the gradient this same kernel with the
// adjoint parameters, so any derivative is one more launch.
//
// What it computes, for sample b, output pixel (oy, ox), channel c:
//
//   y[b,oy,ox,c] = sum_{t<kh, s<kw} f[t][s] * xp[b, oy*down + t, ox*down + s, c]
//   xp[u, v]     = x[(u - py0)/up, (v - px0)/up]  where both divide evenly
//                  and lie inside the input, else 0
//
// f is the stencil flipped in both axes (the wrapper flips it), so this is
// the reference's convolution; up, down in {1, 2}; kh, kw <= 4; the pads
// may be negative (a crop).  The wrapper gives the output size, which
// fixes the high-side pads.  Sums in float32 with FMA, in tap order, and
// one rounding to the output's dtype (float32 or bf16).
//
// Bound on an H100 SXM: bytes.  At most 16 FMAs an output element against
// one input and one output element moved: 32 float32 operations per 8
// bytes, far below 67 TFLOP/s at 3.35 TB/s.  So the least time is one read
// of x and one write of y at 3.35 TB/s (data sheet).
//
// Design, against that bound:
// 1. One pass, no intermediate.  Zero insertion, padding and cropping are
//    index arithmetic; a block stages its input tile with the halo in
//    shared memory, zeros where the tile leaves the input.  Nothing is
//    written but y.
// 2. Channels innermost.  A block owns an output tile of TY x TX pixels
//    for a slice of CG 16-byte channel vectors (32 float32 or 64 bf16
//    channels).  Staging copies each pixel's slice, 128 contiguous bytes,
//    with 16-byte cp.async through L2 only (src-size 0 fills the zeros).
//    Eight neighbouring lanes own the slice's vectors of one pixel, so
//    their shared-memory reads and their global stores are 128 contiguous
//    bytes: no bank conflict, full sectors.
// 3. Register reuse.  A thread makes NY x NX output pixels of its vector.
//    It walks the input rows of its window once, loads each row's
//    (NX-1)*down + kw vectors into registers and adds them into every
//    output row the row reaches: (NY+3)(NX+3)/(NY*NX) shared loads an
//    output at 4x4 (4.4 at NY=4, NX=2), not 16.
// 4. Small C.  When C is not a multiple of a 16-byte vector, or a pointer
//    is not 16-byte aligned (the ToRGB skips: C = 3), the same kernel runs
//    with one element a "vector", staged by plain loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int KMAX = 4;      // largest stencil side
constexpr int CG = 8;        // channel vectors a block covers
constexpr int TYT = 4;       // thread rows of a block
constexpr int TXT = 8;       // thread columns of a block
constexpr int THREADS = CG * TYT * TXT;

struct Taps {
  float f[KMAX * KMAX];  // flipped stencil, row-major KMAX x KMAX, zero padded
};

// bits of one element in shared and global memory
template <int ES> struct Bits;
template <> struct Bits<4> { using type = uint32_t; };
template <> struct Bits<2> { using type = uint16_t; };

template <int ES>
__device__ __forceinline__ float to_f(uint32_t b) {
  return ES == 4 ? __uint_as_float(b) : __uint_as_float(b << 16);  // exact
}

template <int ES>
__device__ __forceinline__ uint32_t from_f(float v) {
  if (ES == 4) return __float_as_uint(v);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// V elements of ES bytes: one 16-byte vector, or one element (V = 1)
template <int ES, int V>
__device__ __forceinline__ void load_v(const unsigned char* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f<ES>(*reinterpret_cast<const typename Bits<ES>::type*>(p));
  } else {
    static_assert(V * ES == 16, "a vector is 16 bytes");
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (ES == 4) {
        v[i] = __uint_as_float(u[i]);
      } else {
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  }
}

template <int ES, int V>
__device__ __forceinline__ void store_v(unsigned char* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *reinterpret_cast<typename Bits<ES>::type*>(p) =
        static_cast<typename Bits<ES>::type>(from_f<ES>(v[0]));
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (ES == 4)
        u[i] = from_f<4>(v[i]);
      else
        u[i] = from_f<2>(v[2 * i]) | (from_f<2>(v[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ void cp_async_16_zfill(uint32_t dst, const void* src,
                                                  bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int floor_div(int a, int up) {
  return up == 1 ? a : (a >> 1);  // up in {1, 2}; arithmetic shift floors
}

// the launch geometry, shared by the kernel and the host
template <int ES, int V, int UP, int DOWN>
struct Shape {
  static constexpr int NY = DOWN == 2 ? 2 : 4;
  static constexpr int NX = (DOWN == 2 || (V == 8 && ES == 2)) ? 1 : 2;
  static constexpr int TY = NY * TYT, TX = NX * TXT;
  // input rows (cols) a tile can reach, the most over any pad
  static constexpr int NR = UP == 1 ? (TY - 1) * DOWN + KMAX
                                    : ((TY - 1) * DOWN + KMAX) / 2 + 2;
  static constexpr int NC = UP == 1 ? (TX - 1) * DOWN + KMAX
                                    : ((TX - 1) * DOWN + KMAX) / 2 + 2;
  static constexpr int SMEM = NR * NC * CG * V * ES;
};

template <int ES, int V, int UP, int DOWN>
__global__ void __launch_bounds__(THREADS, 2)
upfirdn2d_nhwc_kernel(const unsigned char* __restrict__ x,
                      unsigned char* __restrict__ y, const Taps taps,
                      int H, int W, int C, int OH, int OW, int kh, int kw,
                      int py0, int px0, int tiles_x, int tiles_y, int groups) {
  using S = Shape<ES, V, UP, DOWN>;
  constexpr int NY = S::NY, NX = S::NX, TY = S::TY, TX = S::TX, NC = S::NC;
  constexpr int VB = V * ES;  // bytes of a vector
  constexpr int RW = (NY - 1) * DOWN + KMAX;  // window rows of a thread
  constexpr int CW = (NX - 1) * DOWN + KMAX;  // window cols of a thread
  extern __shared__ __align__(16) unsigned char tile[];  // [NR][NC][CG] vectors

  int bid = blockIdx.x;
  const int g = bid % groups;
  bid /= groups;
  const int tx0 = (bid % tiles_x) * TX;
  bid /= tiles_x;
  const int ty0 = (bid % tiles_y) * TY;
  const int b = bid / tiles_y;
  const int nvec = C / V;
  const int cv0 = g * CG;
  const unsigned char* xb = x + static_cast<size_t>(b) * H * W * C * ES;

  // Rows are counted as w = u - py0 for xp's row u (output row oy, tap t:
  // w = oy*DOWN + t - py0); row w is input row w/UP when UP divides it.
  // The tile stages input rows iy0.. and cols ix0.. that the block reaches.
  const int wy0 = ty0 * DOWN - py0, wx0 = tx0 * DOWN - px0;
  const int iy0 = floor_div(wy0, UP), ix0 = floor_div(wx0, UP);
  const int nr = floor_div(wy0 + (TY - 1) * DOWN + kh - 1, UP) - iy0 + 1;
  const int nc = floor_div(wx0 + (TX - 1) * DOWN + kw - 1, UP) - ix0 + 1;
  for (int e = threadIdx.x; e < nr * nc * CG; e += THREADS) {
    const int cv = e % CG, p = e / CG;
    const int r = p / nc, c = p - r * nc;
    const int iy = iy0 + r, ix = ix0 + c;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && cv0 + cv < nvec;
    const unsigned char* src =
        ok ? xb + ((static_cast<size_t>(iy) * W + ix) * C + (cv0 + cv) * V) * ES : x;
    unsigned char* dst = tile + ((r * NC + c) * CG + cv) * VB;
    if constexpr (VB == 16) {
      cp_async_16_zfill(hopper::smem_u32(dst), src, ok);
    } else {
      using B = typename Bits<ES>::type;
      *reinterpret_cast<B*>(dst) = ok ? *reinterpret_cast<const B*>(src) : B(0);
    }
  }
  if constexpr (VB == 16) cp_async_wait_all();
  __syncthreads();

  const int cv = threadIdx.x % CG;
  const int txi = (threadIdx.x / CG) % TXT, tyi = threadIdx.x / (CG * TXT);
  if (cv0 + cv >= nvec) return;
  const int oy0 = ty0 + tyi * NY, ox0 = tx0 + txi * NX;
  const int wy = oy0 * DOWN - py0, wx = ox0 * DOWN - px0;
  const int rows = (NY - 1) * DOWN + kh, cols = (NX - 1) * DOWN + kw;

  float acc[NY][NX][V];
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int q = 0; q < NX; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][q][e] = 0.0f;

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int w = wy + r;
    if (r >= rows || (UP == 2 && (w & 1))) continue;  // past the stencil, or a zero row
    const int sr = floor_div(w, UP) - iy0;
    float win[CW][V];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int u = wx + c;
      if (c < cols && (UP == 1 || !(u & 1))) {
        load_v<ES, V>(tile + ((sr * NC + floor_div(u, UP) - ix0) * CG + cv) * VB,
                      win[c]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) win[c][e] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < NY; ++j) {
      const int t = r - j * DOWN;  // the tap row this input row is for output row j
      if (t < 0 || t >= KMAX || t >= kh) continue;
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        if (s >= kw) continue;
        const float f = taps.f[t * KMAX + s];
#pragma unroll
        for (int q = 0; q < NX; ++q)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[j][q][e] = fmaf(f, win[q * DOWN + s][e], acc[j][q][e]);
      }
    }
  }

  unsigned char* yb = y + static_cast<size_t>(b) * OH * OW * C * ES;
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int q = 0; q < NX; ++q) {
      const int oy = oy0 + j, ox = ox0 + q;
      if (oy < OH && ox < OW)
        store_v<ES, V>(yb + ((static_cast<size_t>(oy) * OW + ox) * C
                             + (cv0 + cv) * V) * ES, acc[j][q]);
    }
}

using KernelFn = void (*)(const unsigned char*, unsigned char*, const Taps, int,
                          int, int, int, int, int, int, int, int, int, int, int);

template <int ES, int V>
KernelFn pick(int up, int down) {
  if (up == 1) return down == 1 ? upfirdn2d_nhwc_kernel<ES, V, 1, 1>
                                : upfirdn2d_nhwc_kernel<ES, V, 1, 2>;
  return down == 1 ? upfirdn2d_nhwc_kernel<ES, V, 2, 1>
                   : upfirdn2d_nhwc_kernel<ES, V, 2, 2>;
}

template <int ES, int V>
void geometry(int up, int down, int* ty, int* tx, int* smem) {
#define UPFIRDN2D_SHAPE(U, D)                                        \
  if (up == U && down == D) {                                        \
    using S = Shape<ES, V, U, D>;                                    \
    *ty = S::TY; *tx = S::TX; *smem = S::SMEM;                       \
  }
  UPFIRDN2D_SHAPE(1, 1) UPFIRDN2D_SHAPE(1, 2) UPFIRDN2D_SHAPE(2, 1)
  UPFIRDN2D_SHAPE(2, 2)
#undef UPFIRDN2D_SHAPE
}

// Above 48 KB a launch needs the opt-in; every variant stays below it
// (46,208 bytes at float32, up 1, down 1), and this holds it so.
static_assert(Shape<4, 4, 1, 1>::SMEM <= 48 * 1024, "tile under 48 KB");
static_assert(Shape<4, 4, 1, 2>::SMEM <= 48 * 1024, "tile under 48 KB");
static_assert(Shape<2, 8, 1, 1>::SMEM <= 48 * 1024, "tile under 48 KB");
static_assert(Shape<2, 8, 1, 2>::SMEM <= 48 * 1024, "tile under 48 KB");

}  // namespace

// x (B,H,W,C) and y (B,OH,OW,C) contiguous, both float32 (dtype 0) or both
// bf16 (dtype 1); `taps` a host array of kh*kw floats, the stencil already
// flipped, row-major.  Launches on `stream` and returns a cudaError_t.
extern "C" int upfirdn2d_launch(const void* x, void* y, const float* taps,
                                int B, int H, int W, int C, int OH, int OW,
                                int up, int down, int kh, int kw, int py0,
                                int px0, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0 ||
      (up != 1 && up != 2) || (down != 1 && down != 2) || kh < 1 || kw < 1 ||
      kh > KMAX || kw > KMAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < KMAX * KMAX; ++i) t.f[i] = 0.0f;
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) t.f[i * KMAX + j] = taps[i * kw + j];
  const int es = dtype == 1 ? 2 : 4;
  const bool vec = C % (16 / es) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  KernelFn fn;
  int ty = 0, tx = 0, smem = 0, v = 1;
  if (dtype == 0 && vec) {
    fn = pick<4, 4>(up, down); geometry<4, 4>(up, down, &ty, &tx, &smem); v = 4;
  } else if (dtype == 0) {
    fn = pick<4, 1>(up, down); geometry<4, 1>(up, down, &ty, &tx, &smem);
  } else if (vec) {
    fn = pick<2, 8>(up, down); geometry<2, 8>(up, down, &ty, &tx, &smem); v = 8;
  } else {
    fn = pick<2, 1>(up, down); geometry<2, 1>(up, down, &ty, &tx, &smem);
  }
  int tiles_y = (OH + ty - 1) / ty, tiles_x = (OW + tx - 1) / tx;
  int groups = (C / v + CG - 1) / CG;
  const long long blocks = static_cast<long long>(B) * tiles_y * tiles_x * groups;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  unsigned char* yp = static_cast<unsigned char*>(y);
  void* args[] = {&xp, &yp, &t, &H, &W, &C, &OH, &OW, &kh, &kw, &py0, &px0,
                  &tiles_x, &tiles_y, &groups};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                                   dim3(static_cast<unsigned>(blocks)),
                                   dim3(THREADS), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
