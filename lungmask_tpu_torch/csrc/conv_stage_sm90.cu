// K4's Hopper route: the U-Net's bf16 convolution stage as an implicit GEMM
// on wgmma, fed by TMA (sm_90a):
//
//   y = cast( epilogue( conv(x, w) accumulated in float32 + b ) )
//
// the same function, layouts and epilogues as csrc/conv_stage.cu (whose
// header says which XLA computation of the JAX U-Net it replaces:
// lungmask_tpu/models/unet.py:61-81, 107-114, 167-172), for a stage whose
// cin is a multiple of 64 and whose x and weight start on 16-byte
// boundaries: 21 of the U-Net's 22 stages, and every band of them. The
// rest (the first conv's cin = 1, other cins, unaligned views) takes
// csrc/conv_stage.cu's mma.sync kernel; ops/kernels/conv_stage.py chooses
// by shape, never by a failure.
//
// What bounds it on this card: operations. A 32-slice chunk's 3x3 stages
// do 3.08 TFLOP in bf16 (3.1 ms at the H100's 989 TFLOP/s) against 2.0 GB
// of activations (0.6 ms at 3.35 TB/s). The tensor cores reach that rate
// only through wgmma fed from shared memory, and only if each SM's tiles
// reuse their operands enough that L2 keeps up, so:
//
// * Implicit GEMM: M = output pixels, N = cout, K = (ky, kx, c), walked in
//   slices of 64 channels of one tap. A tile is BM = 256 output pixels,
//   tw x th of one image (tw the power of two >= wo, at most 256), by BN =
//   128 channels (64 where cout <= 64): 48 KB of operands a slice for 4.2
//   MFLOP, where a 128-pixel tile moves 32 KB for 2.1 MFLOP.
// * TMA loads, the padding for free: x is a 4-D tensor map (c, w, h, n)
//   with a (64, tw, th, 1) box. Tap (ky, kx) of a tile at (w0, h0) is the
//   same box at (c0, w0 + kx - pw, h0 + ky - ph, n): TMA fills what lies
//   outside the image with zeros, which is the zero padding, and a band's
//   (0, 1) padding is only other coordinates. A tile that runs past the
//   output's edge reads pixels of its own image or zeros; the epilogue
//   drops those rows, so any shape tiles and a band takes the route of
//   its whole image. With the 128-byte swizzle each pixel's 64 channels
//   are one 128-byte row of the K-major layout wgmma reads. The weights,
//   (cout, kh * kw * cin) K-major, are a 2-D map with a (64, BN) box.
// * Warp specialisation: one producer thread issues the TMA loads into a
//   ring of 4 (BN 128) or 5 (BN 64) slices, each with a full and an empty
//   mbarrier (its warpgroup's setmaxnreg down to 40); two consumer
//   warpgroups, 128 rows of the tile each as two m64 blocks, run
//   wgmma.mma_async m64nBNk16 on them (setmaxnreg up to 232). The grid is
//   persistent (one block per SM walks tiles in steps of the grid), so the
//   producer loads the next tile while the consumers run the epilogue of
//   this one.
// * Two kernels by shape: conv_stage_tma_kernel loads x's box once per tap
//   and slice; conv_stage_halo_kernel, for the 3x3 stages at wo >= 64 with
//   cout <= 64 (the U-Net's 256^2 stages), loads the tile with its halo
//   once per slice and takes the nine taps as shifted views of it.
//
// Numerics, the contract of K4: every output sums its K products in one
// order, whatever its tile or band. The tensor cores' own accumulator does
// not round to nearest, so a sum of thousands of products chained through
// it drifts (the whole K so chained fails K4's gate at the deep stages).
// Here each 64-channel slice's partial of a block
// (four k16 wgmmas chained from scale-d = 0, CHAIN) is added to the
// float32 accumulator with __fadd_rn in K order: at every U-Net stage
// within the gate, and no further from the plain version than the k16
// partials of the mma.sync route. PERF.md has the agreement and times of
// both, and of a k16 build of this kernel.
//
// Epilogue, as the mma.sync kernel's: (acc + b), [max(., 0) * s + t], one
// rounding, each as __fadd_rn / __fmul_rn in the plain version's order;
// in the ReLU + affine mode, given z, also the float32 pre-activation
// acc + b (the backward's input). Stores go from registers, 4 bytes (two
// bf16 channels) or 8 bytes (two float32 channels) at a time.
//
// Tensor maps are encoded on the host at each call by
// cuTensorMapEncodeTiled, taken from the driver library torch has loaded
// (dlopen of libcuda.so.1), and travel as __grid_constant__ parameters.
// C interface for ctypes; the launcher returns 0, a cudaError_t, or
// ENCODE_FAILED + the CUresult of a failed encode (NO_ENCODER without the
// driver's entry point).

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

struct DeviceGuard {
  int prev = -1;
  bool moved = false;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      moved = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (moved) cudaSetDevice(prev);
  }
};

constexpr int CONSUMERS = 2;                // warpgroups running wgmma
constexpr int MB = 2;                       // m64 blocks per consumer warpgroup
constexpr int BM = 64 * MB * CONSUMERS;     // output pixels per tile: 256
constexpr int BK = 64;                      // channels per K slice: 128 bytes
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;        // one slice of the x tile: 32 KB
// Slices in the ring: as many as fit in shared memory (48 KB a slice at BN
// 128, 40 KB at BN 64).
template <int BN>
constexpr int STAGES = BN == 128 ? 4 : 5;
// k16 products chained in the tensor cores per round-to-nearest add: one
// 64-channel slice's partial (PERF.md has its agreement beside k16's).
constexpr int CHAIN = 4;
constexpr int ENCODE_FAILED = 100000;
constexpr int NO_ENCODER = 200000;

// Epilogues (as csrc/conv_stage.cu).
constexpr int BIAS_BF16 = 0;
constexpr int RELU_AFFINE_BF16 = 1;
constexpr int BIAS_F32 = 2;

struct Params {
  const float* b;
  const float* s;
  const float* t;
  void* y;
  float* z;           // acc + b, float32, or null (ReLU + affine mode only)
  int ho, wo, cout, cin, kw, ph, pw;
  int tw, th;         // a tile's output pixels: tw columns by th rows
  int tiles_w, tiles_hw, ntiles;  // tiles along wo, per image, along cout
  long long tiles;    // all of them
  int kslices;        // kh * kw * cin / BK
  int cslices;        // cin / BK
  int taps;           // kh * kw
  int hw;             // the halo kernel's box: hw = tw + kw - 1 pixels a row
  int halo_bytes;     // ... and hw * (th + kh - 1) pixels of 128 bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A development guard: a wait that lasts WAIT_NS (five minutes, far beyond
// any wait of a correct run, even one slowed by a debugger or heavy
// time-slicing) traps, so a fault in the pipeline ends the launch with an
// error instead of holding the card forever.
constexpr uint64_t WAIT_NS = 300000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > WAIT_NS) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The shared-memory descriptor of a K-major operand in the 128-byte swizzle
// TMA writes: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride byte offset); the leading byte offset is unused in this layout.
// Every buffer starts on a 1024-byte boundary, and wgmma unswizzles by the
// address as TMA swizzled by it, so an operand may start at any 128-byte
// row of a buffer (the halo kernel's shifted taps) with base offset 0: a
// base offset of r % 8 there reads the wrong chunks. The k16 steps inside a
// slice add 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of `r` above the wgmma.wait_group
// that makes its asynchronous result visible.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A (64 x 16, K-major in shared memory, descriptor da) * B (16 x 64,
// K-major, db); d is read when scale_d is 1, else overwritten.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16, K-major in shared memory, descriptor da) * B (16 x 128,
// K-major, db); d is read when scale_d is 1, else overwritten.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db, scale_d);
  } else {
    wgmma_n64(d, da, db, scale_d);
  }
}

// acc += part, element by element, rounding to nearest.
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], float (&part)[N]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// The slice at descriptors (da, db): CHAIN k16 wgmmas, the first with
// scale-d = 0, into `part`, committed.
template <int BN>
__device__ __forceinline__ void issue(float (&part)[BN / 2], uint64_t da, uint64_t db) {
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CHAIN; ++c) {
    const int k = 2 * c;  // 32 bytes per k16 step, in 16-byte units
    wgmma<BN>(part, da + k, db + k, c > 0);
  }
  wgmma_commit();
}

struct Tile {
  int img, h0, w0, n0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, long long tile, int bn) {
  Tile t;
  const long long mt = tile / p.ntiles;
  t.n0 = (int)(tile - mt * p.ntiles) * bn;
  t.img = (int)(mt / p.tiles_hw);
  const int r = (int)(mt - (long long)t.img * p.tiles_hw);
  const int ty = r / p.tiles_w;
  t.h0 = ty * p.th;
  t.w0 = (r - ty * p.tiles_w) * p.tw;
  return t;
}

// The epilogue of one tile: this consumer warpgroup's MB fragments through
// (acc + b), [ReLU, affine], one rounding, and z, to global memory.
template <int BN, int MODE>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& tl,
                                           float (&acc)[MB][BN / 2], int wg, int warp,
                                           int lane) {
  const bool pairs = (p.cout & 1) == 0;
  // Epilogue: element 4 j + 2 h + e of block mb's fragment is row
  // 64 (MB wg + mb) + 16 warp + lane / 4 + 8 h of the tile, channel
  // 8 j + 2 (lane % 4) + e. A thread's rows, then its channels, each
  // channel's bias, scale and shift read once for its 2 MB rows.
  long long row[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * MB + mb) * 64 + warp * 16 + lane / 4 + 8 * h;
      const int hh = r / p.tw;
      const int oy = tl.h0 + hh, ox = tl.w0 + (r - hh * p.tw);
      row[mb][h] = (oy < p.ho && ox < p.wo)
                       ? (((long long)tl.img * p.ho + oy) * p.wo + ox) * p.cout
                       : -1;
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = tl.n0 + 8 * j + 2 * (lane % 4);
    if (n >= p.cout) continue;
    const bool two = n + 1 < p.cout;
    float vb[2], vs[2] = {0.f, 0.f}, vt[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = two ? n + e : n;
      vb[e] = __ldg(p.b + c);
      if (MODE == RELU_AFFINE_BF16) {
        vs[e] = __ldg(p.s + c);
        vt[e] = __ldg(p.t + c);
      }
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[mb][h] < 0) continue;
        float zv[2], v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          zv[e] = __fadd_rn(acc[mb][4 * j + 2 * h + e], vb[e]);
          v[e] = zv[e];
          if (MODE == RELU_AFFINE_BF16) {
            const float relu = zv[e] < 0.f ? 0.f : zv[e];
            v[e] = __fadd_rn(__fmul_rn(relu, vs[e]), vt[e]);
          }
        }
        const long long at = row[mb][h] + n;
        if (MODE == RELU_AFFINE_BF16 && p.z != nullptr) {
          if (pairs) {
            *reinterpret_cast<float2*>(p.z + at) = make_float2(zv[0], zv[1]);
          } else {
            p.z[at] = zv[0];
            if (two) p.z[at + 1] = zv[1];
          }
        }
        if (MODE == BIAS_F32) {
          float* y = static_cast<float*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<float2*>(y) = make_float2(v[0], v[1]);
          } else {
            y[0] = v[0];
            if (two) y[1] = v[1];
          }
        } else {
          __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y) =
                __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
          } else {
            y[0] = __float2bfloat16_rn(v[0]);
            if (two) y[1] = __float2bfloat16_rn(v[1]);
          }
        }
      }
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_stage_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int S = STAGES<BN>;
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int FRAG = BN / 2;  // floats per thread of an m64 x BN fragment
  static_assert(CHAIN * 16 == BK, "one partial per slice");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sa = base;                // S x A_BYTES
  const uint32_t sb = sa + S * A_BYTES;    // S x B_BYTES
  const uint32_t bars = sb + S * B_BYTES;  // full[S], empty[S]
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(bars + 8 * (S + s), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // The producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile tl = tile_of(p, tile, BN);
        for (int ks = 0; ks < p.kslices; ++ks) {
          const int tap = ks / p.cslices;
          const int c0 = (ks - tap * p.cslices) * BK;
          const int ky = tap / p.kw;
          const int kx = tap - ky * p.kw;
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (S + stage), phase ^ 1);  // the slot is free
          mbar_expect_tx(full, A_BYTES + B_BYTES);
          tma_load_4d(sa + stage * A_BYTES, &xmap, full, c0, tl.w0 + kx - p.pw,
                      tl.h0 + ky - p.ph, tl.img);
          tma_load_2d(sb + stage * B_BYTES, &wmap, full, tap * p.cin + c0, tl.n0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 128 wg .. 128 wg + 127 of every tile, as MB
  // blocks of 64. Each slice's partial of a block (CHAIN k16 wgmmas) lands
  // in `part`, is waited for and added to that block's accumulator in K
  // order; the other warpgroup's wgmmas keep the tensor cores busy
  // meanwhile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[MB][FRAG], part[FRAG];
#pragma unroll
  for (int i = 0; i < FRAG; ++i) part[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = tile_of(p, tile, BN);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < FRAG; ++i) acc[mb][i] = 0.f;
    for (int ks = 0; ks < p.kslices; ++ks) {
      mbar_wait(bars + 8 * stage, phase);
      const uint64_t db = sw128_desc(sb + stage * B_BYTES);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const uint64_t da = sw128_desc(sa + stage * A_BYTES + (wg * MB + mb) * 64 * 128);
        issue<BN>(part, da, db);
        wgmma_wait<0>();
        fold(acc[mb], part);
      }
      if (lane == 0) mbar_arrive(bars + 8 * (S + stage));
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }

    store_tile<BN, MODE>(p, tl, acc, wg, warp, lane);
  }
}

// The halo kernel: the same tiles, loaded once per 64-channel slice instead
// of once per tap. x's box is the tile with its halo, (64, tw + kw - 1,
// th + kh - 1, 1) at (c0, w0 - pw, h0 - ph, n); tap (ky, kx) of an m64
// block that lies in one row of the tile (tw = 64 or 128) is 64
// consecutive rows of that box, r = (hh + ky) hw + ww + kx rows in (see
// sw128_desc). The weights' slices come through a ring of their own, one
// per tap. K is walked as (c, ky, kx) by slices; each output still sums its
// products in one order. Where the U-Net's 3x3 stages are widest (64^2 to
// 256^2) this reads (tw + 2)(th + 2) / (tw th), about 2, tiles of x per
// channel slice from L2 instead of 9.
constexpr int HALO_BYTES = 65 * 1024;  // (128 + 2) x (2 + 2) or (64 + 2) x (4 + 2) rows
template <int BN>
constexpr int HALO_B_STAGES = BN == 128 ? 4 : 6;

template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_stage_halo_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int SA = 2;  // halo slices in flight
  constexpr int SB = HALO_B_STAGES<BN>;
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int FRAG = BN / 2;
  static_assert(CHAIN * 16 == BK, "one partial per slice");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sa = base;                       // SA x HALO_BYTES
  const uint32_t sb = sa + SA * HALO_BYTES;       // SB x B_BYTES
  const uint32_t abar = sb + SB * B_BYTES;        // afull[SA], aempty[SA]
  const uint32_t bbar = abar + 16 * SA;           // bfull[SB], bempty[SB]
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(abar + 8 * s, 1);
      mbar_init(abar + 8 * (SA + s), CONSUMERS * 4);
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(bbar + 8 * s, 1);
      mbar_init(bbar + 8 * (SB + s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int as = 0, bs = 0;
      uint32_t aphase = 0, bphase = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile tl = tile_of(p, tile, BN);
        for (int cs = 0; cs < p.cslices; ++cs) {
          mbar_wait(abar + 8 * (SA + as), aphase ^ 1);
          mbar_expect_tx(abar + 8 * as, p.halo_bytes);
          tma_load_4d(sa + as * HALO_BYTES, &xmap, abar + 8 * as, cs * BK, tl.w0 - p.pw,
                      tl.h0 - p.ph, tl.img);
          for (int tap = 0; tap < p.taps; ++tap) {
            mbar_wait(bbar + 8 * (SB + bs), bphase ^ 1);
            mbar_expect_tx(bbar + 8 * bs, B_BYTES);
            tma_load_2d(sb + bs * B_BYTES, &wmap, bbar + 8 * bs, tap * p.cin + cs * BK, tl.n0);
            if (++bs == SB) {
              bs = 0;
              bphase ^= 1;
            }
          }
          if (++as == SA) {
            as = 0;
            aphase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[MB][FRAG], part[FRAG];
#pragma unroll
  for (int i = 0; i < FRAG; ++i) part[i] = 0.f;
  // Each m64 block's first row in the box (tap (0, 0)): the block lies in
  // row hh of the tile, from column ww.
  int first[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int m0 = (wg * MB + mb) * 64;
    first[mb] = (m0 / p.tw) * p.hw + m0 % p.tw;
  }
  int as = 0, bs = 0;
  uint32_t aphase = 0, bphase = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = tile_of(p, tile, BN);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < FRAG; ++i) acc[mb][i] = 0.f;
    for (int cs = 0; cs < p.cslices; ++cs) {
      mbar_wait(abar + 8 * as, aphase);
      const uint32_t halo = sa + as * HALO_BYTES;
      for (int tap = 0; tap < p.taps; ++tap) {
        const int ky = tap / p.kw;
        const int shift = ky * p.hw + (tap - ky * p.kw);  // rows from tap (0, 0)
        mbar_wait(bbar + 8 * bs, bphase);
        const uint64_t db = sw128_desc(sb + bs * B_BYTES);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const uint64_t da = sw128_desc(halo + (first[mb] + shift) * 128);
          issue<BN>(part, da, db);
          wgmma_wait<0>();
          fold(acc[mb], part);
        }
        if (lane == 0) mbar_arrive(bbar + 8 * (SB + bs));
        if (++bs == SB) {
          bs = 0;
          bphase ^= 1;
        }
      }
      if (lane == 0) mbar_arrive(abar + 8 * (SA + as));
      if (++as == SA) {
        as = 0;
        aphase ^= 1;
      }
    }
    store_tile<BN, MODE>(p, tl, acc, wg, warp, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process has loaded.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill outside.
int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return NO_ENCODER;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                          const_cast<void*>(base), dims, strides, box, ones,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)res;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& devices) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (devices.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int BN, int MODE>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, Params p, bool halo, int sms,
           cudaStream_t s) {
  constexpr int smem = STAGES<BN> * (A_BYTES + BN * BK * 2) + 2 * STAGES<BN> * 8 + 1024;
  constexpr int halo_smem = 2 * HALO_BYTES + HALO_B_STAGES<BN> * BN * BK * 2 +
                            16 * (2 + HALO_B_STAGES<BN>) + 1024;
  const auto kernel = halo ? conv_stage_halo_kernel<BN, MODE> : conv_stage_tma_kernel<BN, MODE>;
  static std::atomic<uint64_t> allowed{0}, allowed_halo{0};
  const cudaError_t err = allow_smem(kernel, halo ? halo_smem : smem,
                                     halo ? allowed_halo : allowed);
  if (err != cudaSuccess) return (int)err;
  const long long grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<(unsigned)grid, THREADS, halo ? halo_smem : smem, s>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

template <int BN>
int by_mode(const CUtensorMap& xmap, const CUtensorMap& wmap, const Params& p, int mode,
            bool halo, int sms, cudaStream_t s) {
  if (mode == BIAS_BF16) return launch<BN, BIAS_BF16>(xmap, wmap, p, halo, sms, s);
  if (mode == RELU_AFFINE_BF16) return launch<BN, RELU_AFFINE_BF16>(xmap, wmap, p, halo, sms, s);
  if (mode == BIAS_F32) return launch<BN, BIAS_F32>(xmap, wmap, p, halo, sms, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// As lm_conv_stage (csrc/conv_stage.cu), for cin % 64 == 0 and x, wt on
// 16-byte boundaries (else cudaErrorInvalidValue, nothing launched); z:
// float32 (n, ho, wo, cout) or null, written in mode 1 only.
int lm_conv_stage_tma(const void* x, const void* wt, const void* b, const void* s, const void* t,
                      void* y, void* z, int64_t n, int64_t h, int64_t w, int64_t cin,
                      int64_t cout, int64_t kh, int64_t kw, int64_t ph, int64_t pw, int mode,
                      int device, void* stream) {
  const int64_t ho = h + 2 * ph - kh + 1, wo = w + 2 * pw - kw + 1;
  if (n <= 0 || ho <= 0 || wo <= 0 || cout <= 0) return 0;
  const int64_t k = kh * kw * cin;
  if (cin <= 0 || cin % BK || kh <= 0 || kw <= 0 || ph < 0 || pw < 0 || ph >= kh ||
      pw >= kw || n > INT_MAX || h > INT_MAX || w > INT_MAX || cout > INT_MAX ||
      k > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  const int bn = cout <= 64 ? 64 : 128;
  Params p;
  p.b = static_cast<const float*>(b);
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.y = y;
  p.z = static_cast<float*>(z);
  p.ho = (int)ho;
  p.wo = (int)wo;
  p.cout = (int)cout;
  p.cin = (int)cin;
  p.kw = (int)kw;
  p.ph = (int)ph;
  p.pw = (int)pw;
  // The halo kernel where it can run — a tile row holds whole m64 blocks
  // (wo >= 64, tw 64 or 128) and the tile with its halo fits its buffer —
  // and only where cout <= 64: there the x tile is 32 of a slice's 40 KB,
  // and reading it once per channel slice instead of once per tap pays
  // (PERF.md has both kernels' times at every wide 3x3 stage).
  const int halo_tw = wo >= 128 ? 128 : 64;
  const bool halo = bn == 64 && (kh > 1 || kw > 1) && wo >= 64 &&
                    (halo_tw + kw - 1) * (BM / halo_tw + kh - 1) * BK * 2 <= HALO_BYTES;
  p.tw = 1;
  while (p.tw < wo && p.tw < (halo ? halo_tw : BM)) p.tw *= 2;
  p.th = BM / p.tw;
  p.tiles_w = (int)((wo + p.tw - 1) / p.tw);
  p.tiles_hw = p.tiles_w * (int)((ho + p.th - 1) / p.th);
  p.ntiles = (int)((cout + bn - 1) / bn);
  p.tiles = n * p.tiles_hw * p.ntiles;
  p.cslices = (int)(cin / BK);
  p.taps = (int)(kh * kw);
  p.kslices = p.taps * p.cslices;
  p.hw = p.tw + (int)kw - 1;
  p.halo_bytes = p.hw * (p.th + (int)kh - 1) * BK * 2;

  alignas(64) CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)(cin * 2), (cuuint64_t)(w * cin * 2),
                                  (cuuint64_t)(h * w * cin * 2)};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(halo ? p.hw : p.tw),
                              (cuuint32_t)(halo ? p.th + kh - 1 : p.th), 1};
  int rc = encode(&xmap, x, 4, xdims, xstrides, xbox);
  if (rc != 0) return rc;
  const cuuint64_t wdims[2] = {(cuuint64_t)k, (cuuint64_t)cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)(k * 2)};
  const cuuint32_t wbox[2] = {BK, (cuuint32_t)bn};
  rc = encode(&wmap, wt, 2, wdims, wstrides, wbox);
  if (rc != 0) return rc;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bn == 64 ? by_mode<64>(xmap, wmap, p, mode, halo, sms, st)
                  : by_mode<128>(xmap, wmap, p, mode, halo, sms, st);
}

}  // extern "C"
