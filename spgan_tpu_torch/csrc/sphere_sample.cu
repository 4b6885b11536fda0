// Spherical tap sampler (resample WITHOUT the conv) for Hopper (sm_90a).
//
// Replaces spgan_tpu/ops/pallas/sphere_sample.py::sphere_sample_taps
// (pl.pallas_call at :81, kernel body _kernel).  It feeds the training-time
// sphere convs: the sampled taps go through an einsum with the conv weight
// outside the kernel, so weight and style gradients flow exactly.
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
// elements, so the op moves bytes: at least one read of x, nine writes and
// the tables, (1 + 9) * B*H*W*C * sizeof(T) + 5 * B*H*K2 * 4 bytes at
// 3.35 TB/s (data sheet); its 12 float32 operations an output element
// are far below 67 TFLOP/s.  At the training shapes (B=16, C=259, float32,
// H = W in {35, 29, 23, 17}): 0.0606 / 0.0416 / 0.0262 / 0.0143 ms.
//
// Design, against that bound:
// 1. Input rows staged once per tap row, not read once per tap.  A block
//    owns one unit (b, r, tap row): the 3 taps of one row of the 3x3
//    kernel at output row r.  Those taps reference 2-3 input rows at the
//    sphere tables, which the block copies once into shared-memory slots
//    with 16-byte cp.async through L2 only, from the 16-byte aligned
//    address at or below the row start (the offset is kept).  Slots are
//    keyed by row.  A tap whose rows are resident reads them; one whose
//    rows are not (any table in range is taken) loads them into a free
//    slot, or, after a barrier, into one its own rows do not use.  So
//    about 0.7 input elements cross from L2 per output element, not 2.
// 2. No division in the inner loop.  A thread walks a strip in chunks of
//    16 bytes with (pixel, channel) counters advanced by a stride split
//    once per block.  An output element is four shared-memory reads and
//    three lerps.  Chunks whose columns need no clamp (all but the edge
//    pixels) read at e + sx*C directly.  Offsets are 32-bit: the wrapper
//    refuses outputs of 2^31 elements or more.
// 3. 16-byte streaming stores.  A tap's strip (b, t, r) is W*C contiguous
//    elements: a scalar head up to 16-byte alignment, a body of one
//    16-byte st.global.cs per chunk (4 float32 or 8 bf16; evict-first,
//    since the output is written once and outgrows the 50 MB L2), and a
//    scalar tail.  Each thread computes the elements of its chunk rotated
//    by its lane's octet, so the 32 lanes' shared-memory reads fall in 32
//    distinct banks; selects put the words back in order for the store.
// 4. Filling the card.  B*H*3 units (1680 at H=35, 816 at H=17) of 256
//    threads; 3 row slots a block (2 when 3 do not fit), so 2 (H=35, 29)
//    to 4 (H=17) blocks an SM.  Warps run from tap to tap without a
//    barrier unless a tap has to evict.  The grid runs along each sample
//    (unit = (b*H + r)*3 + tap row), so a sample's rows are read from L2
//    by neighbouring blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNIT_TAPS = 3;  // taps a block samples: one row of the 3x3 kernel
constexpr int MAX_SLOTS = 3;  // input rows a block keeps in shared memory

__device__ __forceinline__ float lerp_rn(float a, float b, float w, float one_minus_w) {
  // a * (1 - w) + b * w, rounded op by op like the unfused reference
  return __fadd_rn(__fmul_rn(a, one_minus_w), __fmul_rn(b, w));
}

// element loads from shared memory (32-bit addresses) and the bits of the
// stored elements, by dtype; VEC elements make one 16-byte store
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float load(uint32_t a) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    return v;
  }
  __device__ static uint32_t word(const float (&v)[VEC], int i) {
    return __float_as_uint(v[i]);
  }
  __device__ static void store(float* p, float v) {
    asm volatile("st.global.cs.f32 [%0], %1;" :: "l"(p), "f"(v));
  }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float load(uint32_t a) {
    unsigned short h;
    asm volatile("ld.shared.b16 %0, [%1];" : "=h"(h) : "r"(a));
    return __uint_as_float(static_cast<uint32_t>(h) << 16);  // exact
  }
  __device__ static uint32_t word(const float (&v)[VEC], int i) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])))
         | static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16;
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(h));
  }
};

__device__ __forceinline__ void store_cs_16(void* p, const uint32_t (&w)[4]) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copies the 16-byte granules that cover `row_bytes` bytes at `row` into
// the slot at shared address `slot`; element 0 lands at (row & 15).
__device__ __forceinline__ void stage_row(const void* row, int row_bytes,
                                          uint32_t slot) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(row) & ~uintptr_t(15);
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(row) + row_bytes + 15) & ~uintptr_t(15);
  const int n = static_cast<int>((hi - lo) >> 4);
  for (int i = threadIdx.x; i < n; i += THREADS)
    cp_async_16(slot + 16 * i, lo + 16 * static_cast<uintptr_t>(i));
}

__device__ __forceinline__ bool resident(const int (&slot_row)[MAX_SLOTS], int y) {
  bool found = false;
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) found |= slot_row[s] == y;
  return found;
}

__device__ __forceinline__ int slot_of(const int (&slot_row)[MAX_SLOTS], int y) {
  int slot = 0;
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s)
    if (slot_row[s] == y) slot = s;
  return slot;
}

__device__ __forceinline__ void assign(int (&slot_row)[MAX_SLOTS], int slot, int y) {
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s)
    if (s == slot) slot_row[s] = y;
}

// WIDE: C >= VEC, so a chunk of VEC elements spans at most two pixels.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 4)
sphere_sample_taps_kernel(const T* __restrict__ x, const int* __restrict__ y0t,
                          const int* __restrict__ y1t, const float* __restrict__ wyt,
                          const int* __restrict__ sxt, const float* __restrict__ fxt,
                          T* __restrict__ out, int H, int W, int C, int K2,
                          int margin, int nslot, int slot_bytes) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  constexpr int SZ = sizeof(T);
  extern __shared__ __align__(16) char smem[];
  const uint32_t smem0 = hopper::smem_u32(smem);
  const int tid = threadIdx.x;

  const int units = (K2 + UNIT_TAPS - 1) / UNIT_TAPS;
  const int br = blockIdx.x / units;  // b*H + r
  const int t0 = (blockIdx.x - br * units) * UNIT_TAPS;
  const int ntap = min(UNIT_TAPS, K2 - t0);
  const int b = br / H;
  const int r = br - b * H;
  const int n = W * C;  // elements of an input row and of an output strip
  const int row_bytes = n * SZ;
  const T* xb = x + b * H * n;
  const int tab = br * K2 + t0;

  // Stage, in tap order, every row of the unit that finds a free slot.
  int slot_row[MAX_SLOTS];
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) slot_row[s] = -1;
#pragma unroll
  for (int i = 0; i < UNIT_TAPS; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (i < ntap) {
        const int y = min(max((h ? y1t : y0t)[tab + i], 0), H - 1);
        int free_slot = -1;
#pragma unroll
        for (int s = MAX_SLOTS - 1; s >= 0; --s)
          if (s < nslot && slot_row[s] < 0) free_slot = s;
        if (!resident(slot_row, y) && free_slot >= 0) assign(slot_row, free_slot, y);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s)
    if (slot_row[s] >= 0)
      stage_row(xb + slot_row[s] * n, row_bytes, smem0 + s * slot_bytes);

  // Counters of element tid*VEC of a strip, and of the stride between a
  // thread's chunks: the only divisions by C, once a block.
  const int stride = THREADS * VEC;
  const int dc = stride / C, dk = stride - dc * C;
  const int c_tid = tid * VEC / C, k_tid = tid * VEC - c_tid * C;
  // the lane's rotation of its chunk: 4-byte words (g + i) & 3 first
  const int g = (tid >> 3) & 3;
  cp_async_wait_all();
  __syncthreads();

  for (int i = 0; i < ntap; ++i) {
    const int ti = tab + i;
    const int y0 = min(max(y0t[ti], 0), H - 1);
    const int y1 = min(max(y1t[ti], 0), H - 1);
    if (!resident(slot_row, y0) || !resident(slot_row, y1)) {
      // the same branch on every thread: tables are read alike
      __syncthreads();  // nobody reads the slots about to be replaced
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = h ? y1 : y0;
        if (!resident(slot_row, y)) {
          int victim = 0;  // a slot holding neither row of this tap
#pragma unroll
          for (int s = MAX_SLOTS - 1; s >= 0; --s)
            if (s < nslot && slot_row[s] != y0 && slot_row[s] != y1) victim = s;
          assign(slot_row, victim, y);
          stage_row(xb + y * n, row_bytes, smem0 + victim * slot_bytes);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const T* row0 = xb + y0 * n;
    const T* row1 = xb + y1 * n;
    const uint32_t a0 = smem0 + slot_of(slot_row, y0) * slot_bytes
                      + static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row0) & 15);
    const uint32_t a1 = smem0 + slot_of(slot_row, y1) * slot_bytes
                      + static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row1) & 15);
    const int sx = min(max(sxt[ti], -margin), margin - 1);
    const float wy = wyt[ti], fx = fxt[ti];
    const float wy1 = __fsub_rn(1.0f, wy), fx1 = __fsub_rn(1.0f, fx);

    // element (cc, kk) of the strip, any column
    auto sample = [&](int cc, int kk) {
      const int c0 = min(max(cc + sx, 0), W - 1);
      const int c1 = min(max(cc + sx + 1, 0), W - 1);
      const uint32_t i0 = (c0 * C + kk) * SZ, i1 = (c1 * C + kk) * SZ;
      return lerp_rn(lerp_rn(E::load(a0 + i0), E::load(a1 + i0), wy, wy1),
                     lerp_rn(E::load(a0 + i1), E::load(a1 + i1), wy, wy1), fx, fx1);
    };

    T* strip = out + ((b * K2 + t0 + i) * H + r) * n;
    const int head = min(static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(strip) & 15)) & 15) / SZ), n);
    const int nchunk = (n - head) / VEC;
    const int body_end = head + nchunk * VEC;

    // scalar head and tail: fewer than 2*VEC elements
    const int nscalar = head + n - body_end;
    if (tid < nscalar) {
      const int e = tid < head ? tid : body_end + tid - head;
      const int cc = e / C;
      E::store(strip + e, sample(cc, e - cc * C));
    }

    // body: chunk q starts at element head + q*VEC, at pixel c, channel k
    int c = c_tid, k = k_tid + head;
    while (k >= C) { k -= C; ++c; }
    for (int q = tid; q < nchunk; q += THREADS) {
      float v[VEC];  // v[j]: element (j + g*VEC/4) % VEC of the chunk
      if (WIDE && c + sx >= 0 && c + sx + 2 <= W - 1) {
        // no clamp: the chunk's columns sit at a constant offset sx*C
        const uint32_t base = ((c + sx) * C + k) * SZ;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const uint32_t i0 = base + ((j + g * (VEC / 4)) & (VEC - 1)) * SZ;
          const uint32_t i1 = i0 + C * SZ;
          v[j] = lerp_rn(lerp_rn(E::load(a0 + i0), E::load(a1 + i0), wy, wy1),
                         lerp_rn(E::load(a0 + i1), E::load(a1 + i1), wy, wy1), fx, fx1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          int kk = k + ((j + g * (VEC / 4)) & (VEC - 1)), cc = c;
          if (WIDE) {
            if (kk >= C) { kk -= C; ++cc; }
          } else {
            while (kk >= C) { kk -= C; ++cc; }
          }
          v[j] = sample(cc, kk);
        }
      }
      // computed word i is word (i + g) & 3 of the chunk
      uint32_t w[4], o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) w[m] = E::word(v, m);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        o[m] = g == 0 ? w[m] : g == 1 ? w[(m + 3) & 3] : g == 2 ? w[(m + 2) & 3] : w[(m + 1) & 3];
      store_cs_16(strip + head + q * VEC, o);
      k += dk;
      c += dc;
      if (k >= C) { k -= C; ++c; }
    }
  }
}

// Bytes of a row slot: the 16-byte granules covering any row of W*C
// elements; 0 when that exceeds what an int holds.
long long slot_bytes_for(int W, int C, int dtype) {
  const long long row = static_cast<long long>(W) * C * (dtype == 1 ? 2 : 4);
  return (row / 16 + 2) * 16;
}

// per device, once: the shared-memory opt-in limit, granted to every
// instantiation
int optin_smem[64] = {0};

cudaError_t device_limit(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (optin_smem[dev] == 0) {
    int v = 0;
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    const void* kernels[] = {
        reinterpret_cast<const void*>(sphere_sample_taps_kernel<float, true>),
        reinterpret_cast<const void*>(sphere_sample_taps_kernel<float, false>),
        reinterpret_cast<const void*>(sphere_sample_taps_kernel<__nv_bfloat16, true>),
        reinterpret_cast<const void*>(sphere_sample_taps_kernel<__nv_bfloat16, false>)};
    for (const void* k : kernels) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
      if (e != cudaSuccess) return e;
    }
    optin_smem[dev] = v;
  }
  *limit = optin_smem[dev];
  return cudaSuccess;
}

// Row slots a block gets for rows of W*C elements: 3, or 2 when 3 do not
// fit; 0 when 2 do not fit (the kernel does not take that shape).
cudaError_t plan(int W, int C, int dtype, int* nslot, int* smem) {
  int limit = 0;
  const cudaError_t e = device_limit(&limit);
  if (e != cudaSuccess) return e;
  const long long slot = slot_bytes_for(W, C, dtype);
  const long long fit = slot > 0 ? limit / slot : 0;
  *nslot = fit >= 2 ? static_cast<int>(fit < MAX_SLOTS ? fit : MAX_SLOTS) : 0;
  *smem = static_cast<int>(*nslot * slot);
  return cudaSuccess;
}

const void* kernel_for(int dtype, int C) {
  if (dtype == 1)
    return C >= Elem<__nv_bfloat16>::VEC
        ? reinterpret_cast<const void*>(sphere_sample_taps_kernel<__nv_bfloat16, true>)
        : reinterpret_cast<const void*>(sphere_sample_taps_kernel<__nv_bfloat16, false>);
  return C >= Elem<float>::VEC
      ? reinterpret_cast<const void*>(sphere_sample_taps_kernel<float, true>)
      : reinterpret_cast<const void*>(sphere_sample_taps_kernel<float, false>);
}

}  // namespace

// Row slots, dynamic shared-memory bytes and resident blocks an SM of a
// launch on the current device for rows of W*C elements of float32
// (dtype 0) or bf16 (dtype 1).  *nslot is 0 when the rows do not fit.
extern "C" int sphere_sample_plan(int W, int C, int dtype, int* nslot,
                                  int* smem, int* blocks_per_sm) {
  if (W <= 0 || C <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = plan(W, C, dtype, nslot, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks_per_sm = 0;
  if (*nslot == 0) return 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_for(dtype, C), THREADS, *smem);
}

// x (B,H,W,C) and out (B,K2,H,W,C) contiguous, both float32 (dtype 0) or
// both bf16 (dtype 1), out under 2^31 elements; tables (B,H,K2) contiguous
// int32/float32.  Launches on `stream` and returns a cudaError_t.
extern "C" int sphere_sample_launch(const void* x, const void* y0, const void* y1,
                                    const void* wy, const void* sx, const void* fx,
                                    void* out, int B, int H, int W, int C, int K2,
                                    int margin, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K2 <= 0 || margin < 1 ||
      (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * K2 * H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int nslot = 0, smem = 0;
  cudaError_t e = plan(W, C, dtype, &nslot, &smem);
  if (e != cudaSuccess) return (int)e;
  if (nslot == 0) return (int)cudaErrorInvalidValue;
  int slot = static_cast<int>(slot_bytes_for(W, C, dtype));
  void* args[] = {&x, &y0, &y1, &wy, &sx, &fx, &out, &H, &W, &C, &K2,
                  &margin, &nslot, &slot};
  e = cudaLaunchKernel(kernel_for(dtype, C),
                       dim3(B * H * ((K2 + UNIT_TAPS - 1) / UNIT_TAPS)),
                       dim3(THREADS), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
