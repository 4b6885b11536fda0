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
// Bound on an H100 SXM at the panorama engine's shapes (B=64, C=Cout=256,
// H=W in {35,29,23,17}, bf16): 2*B*H*W*9*C*Cout FLOPs per launch against
// ~9*C*Cout*2 + B*H*W*(C+Cout)*2 bytes, i.e. ~1,100 FLOPs per byte, far
// above the card's ~295 FLOP/byte balance point: compute-bound, 989
// TFLOP/s dense bf16 (data sheet).
//
// bf16 design: an implicit GEMM (M = B*H*W pixels, K = K2*C, N = Cout) on
// warpgroup MMA.
// - Block: 2 consumer warpgroups (232 registers a thread) + 1 producer
//   warpgroup (40; one thread issues TMA), 384 threads, one block per SM,
//   persistent.  ptxas reports the 168 registers of the kernel's entry;
//   without setmaxnreg the consumers spill and run ~2.5x slower.  Each
//   consumer warpgroup owns a unit of 64 consecutive pixels x all 256
//   output channels (wgmma m64n256k16, bf16 in, 128 float32 accumulators a
//   thread), so every tap of every pixel is built once (grid.y =
//   ceil(Cout/256) = 1 at the engine's shapes).
// - K runs in stages of 64 channels (one 128-byte swizzle row) of one tap,
//   channel chunk outer, tap inner: 36 stages at C = 256.  Taps of one
//   kernel row read nearly the same input columns, so consecutive stages
//   hit L1.
// - Weights: the producer thread streams w9[t, k:k+64, n0:n0+256] (32 KB,
//   four 64x64 TMA boxes, 128-byte swizzle) into a ring of NB = 3 stages
//   (2 to 4 timed alike) with full/empty mbarriers; TMA's zero fill covers
//   ragged C and Cout.  The weights are the same for every unit, so the
//   ring runs on across units.  (A 2-block cluster multicasting each box
//   timed slower.)
// - A (taps): each consumer warpgroup builds its own 64x64 tile into one of
//   two swizzled buffers while its wgmma on the other runs.  A thread owns 8
//   channels of a strip of 4 consecutive pixels, whose one or two row
//   segments (W >= 4) are found once per unit, so the stage loop does no
//   divide.  The strip's table scalars for the next stage are read while
//   the current one goes to the MMA.  Per stage all of the strip's 16-byte
//   loads are in flight together; it mixes the two source rows once per
//   source column and slides along the strip (col0 of pixel c+1 is col1 of
//   pixel c, clamps included): a pixel costs two loads and two lerps, not
//   four and three.  No branch but the rare row crossing: pixels past the
//   valid ones read valid columns and are zeroed.  The input goes through
//   L1 with plain loads; staging it in shared memory with cp.async,
//   prefetching the next stage into L1, and loading the next stage into
//   registers a stage early all timed slower.
// - Tile choice: flat units of 64 pixels in (b, r, c) order, rows of a unit
//   taking their own table scalars, so one kernel serves Bg = 16 and Bg = 1
//   alike and only the last unit pads.  Padding waste: 0 rows at B = 64
//   (64*H*W is a multiple of 64) and 48 rows at B = 16 (0.2-1.0%).
// - Filling the card: persistent grid of P = min(#SMs, units) blocks; round
//   r gives unit r*2P + w*P + block to warpgroup w, so a partial last round
//   spreads over all SMs one warpgroup each, and with fewer units than SMs
//   every unit has an SM to itself.  At B = 64 the units are 1225 / 841 /
//   529 / 289 (H = 35/29/23/17): 4.64 / 3.19 / 2.00 / 1.09 rounds of 264
//   warpgroups.  At B = 16 (307 / 211 / 133 / 73 units) most launches are
//   one unit deep, so their time is one unit's 36-stage chain.
// - What bounds it now: building A, not the MMA or the weight stream
//   (PERF.md).
// f32 design (the tiny cuda-vs-cpu parity runs): BM = 64 pixels x BN = 128
// channels per block, float32 FMA on the CUDA cores (tensor cores would be
// TF32), A built per BK = 32 chunk, nothing pipelined.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16
constexpr int UNIT = 64;           // pixels per consumer warpgroup (wgmma M)
constexpr int KC = 64;             // channels per stage
constexpr int NT = 256;            // output channels per block (wgmma N)
constexpr int NB = 3;              // weight ring stages
constexpr int CONSUMERS = 2;       // consumer warpgroups per block
constexpr int THREADS_BF16 = (CONSUMERS + 1) * 128;
// registers a thread after setmaxnreg: consumers hold 128 accumulators
// plus a strip's loads; 128 * (2 * 232 + 40) = 64,512 of the SM's 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int B_STAGE = KC * NT * 2;          // 32 KB
constexpr int B_BOX = KC * 64 * 2;            // one 64x64 TMA box, 8 KB
constexpr int A_BUF = UNIT * KC * 2;          // 8 KB
constexpr int SMEM_BF16 =
    1024 + NB * B_STAGE + CONSUMERS * 2 * A_BUF + 2 * NB * 8;
static_assert(SMEM_BF16 <= 232448, "more shared memory than a block gets");

struct ConvParams {
  const __nv_bfloat16* x;
  const int* y0;
  const int* y1;
  const float* wy;
  const int* sx;
  const float* fx;
  __nv_bfloat16* out;
  int B, H, W, C, Cout, K2, Bg, margin;
  int M, units, stages;  // stages per unit: ceil(C / KC) * K2
};

// A thread's strip of 4 consecutive pixels: n valid (0..4); segment A
// from pixel 0 (sample bA, group gA, row rA, column cA) and, from pixel jb
// (4: none), segment B at column 0 of the next image row (bB, gB, rB).
// W >= 4, so a strip crosses at most one image row.
struct Strip {
  int n, jb, bA, gA, rA, cA, bB, gB, rB;
};

__device__ __forceinline__ Strip strip_at(const ConvParams& p, int pix) {
  Strip s;
  s.n = max(0, min(4, p.M - pix));
  const int HW = p.H * p.W;
  const int q = min(pix, p.M - 1);
  s.bA = q / HW;
  const int rem = q - s.bA * HW;
  s.rA = rem / p.W;
  s.cA = rem - s.rA * p.W;
  s.gA = s.bA / p.Bg;
  s.jb = min(4, p.W - s.cA);
  s.rB = s.rA + 1;
  s.bB = s.bA;
  if (s.rB == p.H) { s.rB = 0; ++s.bB; }
  s.gB = s.bB / p.Bg;
  return s;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, rounded op by op like the unfused reference
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// 8 channels of two source rows at one column, mixed by wy.
__device__ __forceinline__ void rowmix(uint4 a, uint4 b, float wy, float m[8]) {
  const uint32_t ua[4] = {a.x, a.y, a.z, a.w};
  const uint32_t ub[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[2 * i] = lerp_rn(bf_lo(ua[i]), bf_lo(ub[i]), wy);
    m[2 * i + 1] = lerp_rn(bf_hi(ua[i]), bf_hi(ub[i]), wy);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One table row (g, r) of tap t: element offsets of the two source rows
// (channel 0), the clamped column shift and the two weights.
struct Seg {
  int row0, row1, sx;
  float wy, fx;
};

__device__ __forceinline__ Seg seg_at(const ConvParams& p, int b, int g, int r,
                                      int t) {
  const int ti = (g * p.H + r) * p.K2 + t;
  // rows come clamped from the table builder; clamp again so a bad table
  // cannot read out of bounds
  const int y0 = min(max(__ldg(p.y0 + ti), 0), p.H - 1);
  const int y1 = min(max(__ldg(p.y1 + ti), 0), p.H - 1);
  Seg sg;
  sg.sx = min(max(__ldg(p.sx + ti), -p.margin), p.margin - 1);
  sg.wy = __ldg(p.wy + ti);
  sg.fx = __ldg(p.fx + ti);
  sg.row0 = (b * p.H + y0) * p.W * p.C;
  sg.row1 = (b * p.H + y1) * p.W * p.C;
  return sg;
}

// The segments of a strip for tap t (B = A when the strip stays in one
// image row; every strip's A exists, so a past-the-end strip reads valid
// table entries and is zeroed later).
__device__ __forceinline__ void strip_segs(const ConvParams& p, const Strip& s,
                                           int t, Seg& A, Seg& B) {
  A = seg_at(p, s.bA, s.gA, s.rA, t);
  B = A;
  if (s.jb < s.n) B = seg_at(p, s.bB, s.gB, s.rB, t);
}

// Tap t, channels [k, k+8) of the thread's strip, rounded once to bf16,
// into rows dst, dst+128, ... of a 128-byte-swizzled A buffer (16-byte
// chunk `chunk` of row m lands in slot chunk ^ (m % 8); swz = row % 8 of
// the strip's first row).  Rows are mixed once per source column and the
// column mix slides: col0 of pixel j+1 is col1 of pixel j, clamps included.
// All loads are in flight together and the code has no branch but the rare
// row crossing: pixels past the strip's valid ones (and channels past C)
// read valid columns of pixel 0's rows and are zeroed.
__device__ __forceinline__ void build_strip(const ConvParams& p, const Strip& s,
                                            int k, const Seg& A, const Seg& B,
                                            uint32_t dst, int chunk, int swz) {
  const int n = k < p.C ? s.n : 0;
  const int kk = min(k, p.C - 8);  // in bounds when k >= C (zeroed anyway)
  const int c0A = min(max(s.cA + A.sx, 0), p.W - 1) * p.C + kk;
  const int c0B = min(max(B.sx, 0), p.W - 1) * p.C + kk;
  const uint4 h0 = ldg16(p.x + A.row0 + c0A);
  const uint4 h1 = ldg16(p.x + A.row1 + c0A);
  const uint4 e0 = ldg16(p.x + B.row0 + c0B);
  const uint4 e1 = ldg16(p.x + B.row1 + c0B);
  uint4 v0[4], v1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool a = j < s.jb;
    const int cb = a ? s.cA + A.sx + j + 1 : B.sx + (j - s.jb) + 1;
    const int c1 = min(max(cb, 0), p.W - 1) * p.C + kk;
    v0[j] = ldg16(p.x + (a ? A.row0 : B.row0) + c1);
    v1[j] = ldg16(p.x + (a ? A.row1 : B.row1) + c1);
  }
  float mp[8];
  rowmix(h0, h1, A.wy, mp);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool a = j < s.jb;
    const float wy = a ? A.wy : B.wy;
    const float f = a ? A.fx : B.fx;
    if (j == s.jb) rowmix(e0, e1, wy, mp);  // the strip crossed a row
    float mc[8];
    rowmix(v0[j], v1[j], wy, mc);
    uint4 o;
    o.x = pack_bf16(lerp_rn(mp[0], mc[0], f), lerp_rn(mp[1], mc[1], f));
    o.y = pack_bf16(lerp_rn(mp[2], mc[2], f), lerp_rn(mp[3], mc[3], f));
    o.z = pack_bf16(lerp_rn(mp[4], mc[4], f), lerp_rn(mp[5], mc[5], f));
    o.w = pack_bf16(lerp_rn(mp[6], mc[6], f), lerp_rn(mp[7], mc[7], f));
    if (j >= n) o = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) mp[i] = mc[i];
    const uint32_t at = dst + 128 * j + (((chunk ^ (swz + j)) & 7) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
                 :: "r"(at), "r"(o.x), "r"(o.y), "r"(o.z), "r"(o.w) : "memory");
  }
}

__global__ void __launch_bounds__(THREADS_BF16, 1)
sphere_conv_bf16(const __grid_constant__ CUtensorMap wmap, const ConvParams p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_ring = base;
  const uint32_t a_bufs = b_ring + NB * B_STAGE;
  const uint32_t bars = a_bufs + CONSUMERS * 2 * A_BUF;
  // full[i] at bars + 8i (one TMA stage landed), empty[i] at bars + 8(NB+i)
  // (both consumer warpgroups done with it)
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (NB + i), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int P = gridDim.x;
  const int n0 = blockIdx.y * NT;

  if (warp >= CONSUMERS * 4) {
    // ---- producer: one thread streams the weight stages of every round
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      uint32_t g = 0;
      for (int rd = 0; rd * 2 * P + (int)blockIdx.x < p.units; ++rd) {
        int kc = 0, t = 0;
        for (int i = 0; i < p.stages; ++i, ++g) {
          const uint32_t slot = g % NB;
          mbar_wait(bars + 8 * (NB + slot), ((g / NB) & 1) ^ 1);
          mbar_arrive_expect_tx(bars + 8 * slot, B_STAGE);
#pragma unroll
          for (int j = 0; j < NT / 64; ++j)
            tma_load_3d(b_ring + slot * B_STAGE + j * B_BOX, &wmap,
                        bars + 8 * slot, n0 + 64 * j, kc, t);
          if (++t == p.K2) { t = 0; kc += KC; }
        }
      }
    }
  } else {
    // ---- consumers: build A, multiply, write the unit
    setmaxnreg_inc<CONSUMER_REGS>();
    // warpgroup index through a shuffle, so the compiler sees it (and all
    // that follows from it) as warp-uniform: wgmma on a divergent path is
    // serialized
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int q = threadIdx.x % 128;
    const int chunk = q & 7;
    const int strip = q >> 3;
    const uint32_t my_a = a_bufs + wg * 2 * A_BUF;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t g = 0;
    for (int rd = 0; rd * 2 * P + (int)blockIdx.x < p.units; ++rd) {
      const int unit = rd * 2 * P + wg * P + blockIdx.x;
      const bool valid = unit < p.units;
      const int m0 = unit * UNIT;
      const Strip s = strip_at(p, m0 + strip * 4);
      Seg A, B;  // the table entries of the stage being built
      if (valid) strip_segs(p, s, 0, A, B);
      int kc = 0, t = 0;
      for (int i = 0; i < p.stages; ++i, ++g) {
        const uint32_t slot = g % NB;
        const uint32_t full = bars + 8 * slot;
        const int tn = t + 1 == p.K2 ? 0 : t + 1;
        const int kn = tn == 0 ? kc + KC : kc;
        if (valid) {
          const uint32_t abuf = my_a + (g & 1) * A_BUF;
          build_strip(p, s, kc + chunk * 8, A, B, abuf + strip * 4 * 128,
                      chunk, (strip & 1) * 4);
          // the next stage's table reads fly through the MMA hand-off
          if (i + 1 < p.stages) strip_segs(p, s, tn, A, B);
          fence_proxy_async_smem();
          named_bar_sync(1 + wg, 128);
          mbar_wait(full, (g / NB) & 1);
          const uint64_t da = desc_sw128(abuf, 16, 1024);
          const uint64_t db = desc_sw128(b_ring + slot * B_STAGE, B_BOX, 1024);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            // A: +32 bytes along the swizzled row; B: +16 rows of 128 bytes
            wgmma_m64n256k16_bf16(acc, da + 2 * kk, db + 128 * kk,
                                  (i > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's MMA is done
          fence_regs(acc);
          mbar_arrive_if(bars + 8 * (NB + (g - 1) % NB), i > 0 && q == 0);
        } else {
          // no unit this round: keep the ring in step; the barrier holds
          // every thread within one phase of the ring
          mbar_wait(full, (g / NB) & 1);
          named_bar_sync(1 + wg, 128);
          mbar_arrive_if(bars + 8 * (NB + slot), q == 0);
        }
        kc = kn;
        t = tn;
      }
      if (!valid) continue;
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_if(bars + 8 * (NB + (g - 1) % NB), q == 0);
      // epilogue: registers -> bf16 NHWC rows (16 bytes per lane quad)
      const int lane = q & 31;
      const int row = m0 + (q >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int n8 = 0; n8 < NT / 8; ++n8) {
        const int col = n0 + n8 * 8 + (lane & 3) * 2;
        if (col >= p.Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row + 8 * h < p.M)
            *reinterpret_cast<uint32_t*>(p.out + (size_t)(row + 8 * h) * p.Cout + col) =
                pack_bf16(acc[n8 * 4 + 2 * h], acc[n8 * 4 + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32
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

// Where one pixel reads for one tap.
struct TapSrc {
  const float* r0c0;
  const float* r0c1;
  const float* r1c0;
  const float* r1c1;
  float wy, fx;
  bool valid;
};

__device__ __forceinline__ TapSrc tap_src(const Params& p, int m, int t) {
  TapSrc s;
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
  const float* xb = static_cast<const float*>(p.x) + (size_t)b * HW * p.C;
  s.r0c0 = xb + ((size_t)y0 * p.W + c0) * p.C;
  s.r0c1 = xb + ((size_t)y0 * p.W + c1) * p.C;
  s.r1c0 = xb + ((size_t)y1 * p.W + c0) * p.C;
  s.r1c1 = xb + ((size_t)y1 * p.W + c1) * p.C;
  s.wy = p.wy[ti];
  s.fx = p.fx[ti];
  return s;
}

// 8 tap values of channels [k, k+8) for one pixel (zeros out of range).
__device__ __forceinline__ void tap8(const TapSrc& s, int k, int C, float out[8]) {
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
    const TapSrc src = tap_src(p, m0 + ap, t);
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

// w9 (K2, C, Cout) as a 3-D tensor map, innermost first, 64x64 boxes.  A
// map holds only the address and the shape, so maps are kept for the last
// few weights (the engine cycles through one per SS layer).
bool weight_map(const void* w9, int C, int Cout, int K2, CUtensorMap* map) {
  struct Entry {
    const void* w9;
    int C, Cout, K2;
    CUtensorMap map;
  };
  static Entry cache[8];
  static int next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : cache)
    if (e.w9 == w9 && e.C == C && e.Cout == Cout && e.K2 == K2) {
      *map = e.map;
      return true;
    }
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, (cuuint64_t)K2};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2};
  const cuuint32_t box[3] = {64, KC, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w9),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = Entry{w9, C, Cout, K2, *map};
  next = (next + 1) % 8;
  return true;
}

int launch_bf16(const void* x, const void* y0, const void* y1, const void* wy,
                const void* sx, const void* fx, const void* w9, void* out,
                int B, int H, int W, int C, int Cout, int K2, int Bg,
                int margin, cudaStream_t s) {
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.y0 = static_cast<const int*>(y0);
  p.y1 = static_cast<const int*>(y1);
  p.wy = static_cast<const float*>(wy);
  p.sx = static_cast<const int*>(sx);
  p.fx = static_cast<const float*>(fx);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W; p.C = C; p.Cout = Cout; p.K2 = K2;
  p.Bg = Bg; p.margin = margin;
  p.M = B * H * W;
  p.units = (p.M + UNIT - 1) / UNIT;
  p.stages = (C + KC - 1) / KC * K2;
  if (p.M == 0) return (int)cudaSuccess;

  CUtensorMap wmap;
  if (!weight_map(w9, C, Cout, K2, &wmap)) return (int)cudaErrorInvalidValue;

  // per device, once: the shared-memory opt-in and the SM count
  static int sm_count[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    e = cudaFuncSetAttribute(sphere_conv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
    int sms = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev] = sms;
  }
  const int sms = sm_count[dev];
  // persistent, one block per SM; with fewer units than SMs each unit gets
  // a block of its own (its second warpgroup idles)
  dim3 grid(p.units < sms ? p.units : sms, (Cout + NT - 1) / NT);
  sphere_conv_bf16<<<grid, THREADS_BF16, SMEM_BF16, s>>>(wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,H,W,C), w9 (K2,C,Cout) and out (B,H,W,Cout) contiguous, all float32
// (dtype 0) or all bf16 (dtype 1); tables (G,H,K2) contiguous int32/float32
// with G = B / Bg.  C and Cout multiples of 8, pointers 16-byte aligned;
// bf16: x has fewer than 2^31 elements.  Launches on `stream` and returns
// a cudaError_t.
extern "C" int sphere_conv_launch(const void* x, const void* y0, const void* y1,
                                  const void* wy, const void* sx, const void* fx,
                                  const void* w9, void* out, int B, int H, int W,
                                  int C, int Cout, int K2, int Bg, int margin,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(x, y0, y1, wy, sx, fx, w9, out, B, H, W, C, Cout, K2,
                       Bg, margin, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
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
  sphere_conv_f32<<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Registers and local-memory (spill) bytes a thread, and the dynamic shared
// memory a block, of the bf16 (dtype 1) or f32 (dtype 0) kernel.
extern "C" int sphere_conv_attributes(int dtype, int* regs, int* local_bytes,
                                      int* dynamic_smem) {
  cudaFuncAttributes a;
  const cudaError_t e = dtype == 1 ? cudaFuncGetAttributes(&a, sphere_conv_bf16)
                                   : cudaFuncGetAttributes(&a, sphere_conv_f32);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *dynamic_smem = dtype == 1 ? SMEM_BF16 : 0;
  return 0;
}
