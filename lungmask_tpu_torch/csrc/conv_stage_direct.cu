// K4's direct route: the bf16 convolution stages with fewer than 8 input
// channels (the U-Net's first conv, 3x3, cin 1 -> cout 64 at 256x256, and
// the residual variant's first 1x1 path), hand-written for Hopper (sm_90a):
//
//   y = cast( epilogue( conv(x, w) accumulated in float32 + b ) )
//
// with the epilogue ReLU then the folded-BatchNorm affine (y * s + t), or
// nothing (bias only). The output is bf16, rounded once, or float32. In the
// ReLU + affine mode the kernel also writes, given z, the float32
// pre-activation acc + b that the stage's backward reads
// (ops/kernels/conv_stage.py::ConvStage). The same function, C interface and
// argument list as csrc/conv_stage.cu::lm_conv_stage.
//
// It stands for what XLA computes for the JAX U-Net's bf16 conv stage (no
// Pallas kernel there: XLA's convolution and its fusion):
//   lungmask_tpu/models/unet.py:60-81    _conv_acc32: lax.conv_general_dilated
//                                        with preferred_element_type=float32
//   lungmask_tpu/models/unet.py:107-114  _conv: the float32 bias added to it
//   lungmask_tpu/models/unet.py:167-172  jnp.maximum(., 0), _affine in
//                                        float32, then .astype(bfloat16)
//
// Layouts: x is NHWC bf16 (n, h, w, cin), contiguous; w is bf16
// (cout, kh, kw, cin), contiguous (ops/kernels/conv_stage.py::weight_layout);
// b, s, t are float32 (cout,); y is NHWC (n, ho, wo, cout) with
// ho = h + 2 ph - kh + 1, wo = w + 2 pw - kw + 1 and zeros outside x.
//
// What bounds it on this card: bytes, and nearly all of them stores. At
// the first conv of a 32-slice chunk it writes 32 x 256^2 x 64 bf16 = 268 MB
// (0.080 ms at 3.35 TB/s), reads 4 MB and does 1.2 G multiply-adds (0.04 ms
// of the float32 units). A GEMM on the tensor cores would pad K = 9 to 16
// or 32 and spend its time filling tiles; this kernel has no tensor cores,
// no K padding and no copy pipeline, and is built around its stores:
//
// * One thread owns an output pixel's octet of 8 channels, so every bf16
//   store is one 16-byte vector; 8 lanes cover a pixel's 64-channel slab
//   (blockIdx.y picks the slab) and a warp 4 neighbouring pixels, so a
//   warp's store is 512 contiguous bytes (z and float32 outputs: two
//   16-byte stores a thread), streamed past the L2 (st.global.cs). A ragged
//   slab (cout % 8 != 0, or an octet past cout) and unaligned outputs take
//   masked scalar stores.
// * A persistent grid (as many blocks as fit on the SMs) walks tiles of 2
//   output rows by up to 256 columns. A thread computes the two pixels of
//   one column of the tile at a time: two independent sums per weight,
//   which hides the latencies of a block of few warps (the weights take
//   most registers). Each block loads its slab's weights, converted to
//   float32, and its b, s, t once: into
//   registers at the U-Net's two K (9, the 3x3 cin-1 stage: 72 weights a
//   thread; 1, the 1x1 path), compiled for that K so the taps' loads all
//   issue before their multiply-adds; at any other K (cin 2 to 7, kernels
//   up to 3x3) into shared memory, laid out so the 8 lanes of a pixel read
//   128 contiguous bytes. The largest stage's shared memory fits the
//   default 48 KB.
// * The tile's input rows with their halo are staged in shared memory as
//   float32, zeros outside the image; the 8 lanes of a pixel read each tap
//   as a broadcast. The input is small and lives in the L2, so plain loads
//   suffice (loading the next tile ahead into registers cost more, in the
//   registers the weights need, than it hid).
//
// Numerics, K4's: every output sums its K = kh*kw*cin products from +0 in
// the order (ky, kx, c), whatever its tile, with __fmaf_rn (a bf16 x bf16
// product is exact in float32, so the fused multiply-add rounds as the
// product followed by a round-to-nearest add would). A tap outside the image
// contributes a staged zero through the same multiply-add, never a skipped
// one, so a band of rows padded with its neighbours' rows (padding (0, 1),
// parallel/halo.py) gives the whole image's bits, signs of zeros included.
// The epilogue is __fadd_rn(acc, b), the ReLU, __fadd_rn(__fmul_rn(r, s), t)
// and one rounding, the order of the other routes (csrc/conv_stage.cu),
// with no contraction. The sum runs in another order than the mma.sync
// route's tensor cores; it is held to the plain version by K4's gate.
//
// C interface for ctypes; the launcher returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Makes `device` current for a launch and restores the caller's device on
// every return path (torch reads the runtime's current device).
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

constexpr int THREADS = 128;
constexpr int OCT = 8;                   // channels a thread writes: 16 bytes of bf16
constexpr int LANES = 8;                 // threads of one pixel
constexpr int SLAB = OCT * LANES;        // output channels of a block
constexpr int SLOTS = THREADS / LANES;   // columns a block computes at once
constexpr int CIN_MAX = 7;
constexpr int KSIZE_MAX = 3;             // kh, kw at most
constexpr int KMAX = KSIZE_MAX * KSIZE_MAX * CIN_MAX;  // the route's largest K
constexpr int TILE_ROWS = 2;             // output rows of a tile: a thread's two pixels
constexpr int TILE_W = 256;              // output columns of a tile, at most
// Dynamic shared memory of the largest stage: the weights, the tap offsets
// and the staged tile, (TILE_ROWS + kh - 1) x (TILE_W + kw - 1) x cin.
constexpr int SMEM_LIMIT =
    (KMAX * SLAB + KMAX + (TILE_ROWS + KSIZE_MAX - 1) * (TILE_W + KSIZE_MAX - 1) * CIN_MAX) * 4;
static_assert(SMEM_LIMIT <= 48 * 1024, "the largest stage must fit the default shared memory");

// Epilogues.
constexpr int BIAS_BF16 = 0;         // cast(acc + b)
constexpr int RELU_AFFINE_BF16 = 1;  // cast(max(acc + b, 0) * s + t)
constexpr int BIAS_F32 = 2;          // acc + b, float32 out

struct Params {
  const unsigned short* x;  // bf16 bits
  const unsigned short* w;
  const float* b;
  const float* s;
  const float* t;
  void* y;
  float* z;  // acc + b, float32, or null (ReLU + affine mode only)
  int h, w_in, cin, cout, kw, ph, pw, ho, wo;
  int k;               // kh * kw * cin
  int tw;              // a tile's output columns (its rows: TILE_ROWS)
  int sh, sw;          // its staged input rows and columns: TILE_ROWS + kh - 1, tw + kw - 1
  int tiles_x, tiles_y;
  long long tiles;     // n * tiles_y * tiles_x
  bool vec;            // cout % 8 == 0 and y, z on 16-byte boundaries
};

__device__ __forceinline__ float bf16_value(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// A tile: image img, output rows oy0 and oy0 + 1, columns ox0 .. ox0 + tw - 1.
struct Tile {
  long long img;
  int oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, long long tile) {
  const long long q = tile / p.tiles_x;
  Tile tl;
  tl.img = q / p.tiles_y;
  tl.oy0 = (int)(q - tl.img * p.tiles_y) * TILE_ROWS;
  tl.ox0 = (int)(tile - q * p.tiles_x) * p.tw;
  return tl;
}

// Element j of the tile's staged row r: input row oy0 - ph + r, element j
// of the contiguous run of x from column ox0 - pw; +0 outside the image.
__device__ __forceinline__ float staged(const Params& p, const Tile& tl, int r, int j) {
  const int iy = tl.oy0 - p.ph + r;
  const long long row = (long long)p.w_in * p.cin;
  const long long e = (long long)(tl.ox0 - p.pw) * p.cin + j;
  return (iy >= 0 && iy < p.h && e >= 0 && e < row) ? bf16_value(p.x[(tl.img * p.h + iy) * row + e])
                                                    : 0.f;
}

// The epilogue of z = acc + b: ReLU then the affine, or z itself.
template <int MODE>
__device__ __forceinline__ float epilogue(float z, float s, float t) {
  if (MODE != RELU_AFFINE_BF16) return z;
  const float r = z < 0.f ? 0.f : z;
  return __fadd_rn(__fmul_rn(r, s), t);
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Output pixel m's channels n0 .. n0 + 7 from their accumulators.
template <int MODE>
__device__ __forceinline__ void store(const Params& p, long long m, int n0, const float (&acc)[OCT],
                                      const float (&vb)[OCT], const float (&vs)[OCT],
                                      const float (&vt)[OCT]) {
  float zv[OCT], v[OCT];
#pragma unroll
  for (int e = 0; e < OCT; ++e) {
    zv[e] = __fadd_rn(acc[e], vb[e]);
    v[e] = epilogue<MODE>(zv[e], vs[e], vt[e]);
  }
  const long long at = m * p.cout + n0;
  const bool whole = p.vec && n0 + OCT <= p.cout;
  const int count = p.cout - n0 < OCT ? p.cout - n0 : OCT;
  if (MODE == RELU_AFFINE_BF16 && p.z != nullptr) {
    if (whole) {
      float4* dst = reinterpret_cast<float4*>(p.z + at);
      __stcs(dst, make_float4(zv[0], zv[1], zv[2], zv[3]));
      __stcs(dst + 1, make_float4(zv[4], zv[5], zv[6], zv[7]));
    } else {
      for (int e = 0; e < count; ++e) p.z[at + e] = zv[e];
    }
  }
  if (MODE == BIAS_F32) {
    float* y = static_cast<float*>(p.y) + at;
    if (whole) {
      float4* dst = reinterpret_cast<float4*>(y);
      __stcs(dst, make_float4(v[0], v[1], v[2], v[3]));
      __stcs(dst + 1, make_float4(v[4], v[5], v[6], v[7]));
    } else {
      for (int e = 0; e < count; ++e) y[e] = v[e];
    }
  } else {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + at;
    if (whole) {
      __stcs(reinterpret_cast<uint4*>(y), make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                                     bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7])));
    } else {
      for (int e = 0; e < count; ++e) y[e] = __float2bfloat16_rn(v[e]);
    }
  }
}

// KR > 0: K == KR, the weights in registers; KR == 0: any K, in shared memory.
template <int MODE, int KR>
__global__ void __launch_bounds__(THREADS, 3) conv_stage_direct_kernel(const Params p) {
  constexpr bool REG = KR > 0;
  constexpr int NR = REG ? KR : 1;  // taps held in registers
  extern __shared__ float smem[];
  // Shared memory: [weights, !REG: K x 2 x LANES x 4][tap offsets: K][staged tile].
  float* const sw = smem;
  int* const soff = reinterpret_cast<int*>(smem + (REG ? 0 : p.k * SLAB));
  float* const sx = smem + (REG ? 0 : p.k * SLAB) + p.k;

  const int tid = threadIdx.x, lane = tid % LANES, slot = tid / LANES;
  const int slab0 = blockIdx.y * SLAB;
  const int n0 = slab0 + lane * OCT;  // this thread's first channel
  const bool active = n0 < p.cout;

  // The staged offset of each tap, K in the order (ky, kx, c).
  for (int k = tid; k < p.k; k += THREADS) {
    const int tap = k / p.cin, c = k - tap * p.cin;
    const int ky = tap / p.kw, kx = tap - ky * p.kw;
    soff[k] = (ky * p.sw + kx) * p.cin + c;
  }
  float vb[OCT], vs[OCT], vt[OCT];
#pragma unroll
  for (int e = 0; e < OCT; ++e) {
    const bool ok = n0 + e < p.cout;
    vb[e] = ok ? p.b[n0 + e] : 0.f;
    vs[e] = (MODE == RELU_AFFINE_BF16 && ok) ? p.s[n0 + e] : 0.f;
    vt[e] = (MODE == RELU_AFFINE_BF16 && ok) ? p.t[n0 + e] : 0.f;
  }
  float wr[NR][OCT];
  if (REG) {
#pragma unroll
    for (int k = 0; k < NR; ++k)
#pragma unroll
      for (int e = 0; e < OCT; ++e)
        wr[k][e] = n0 + e < p.cout ? bf16_value(p.w[(long long)(n0 + e) * KR + k]) : 0.f;
  } else {
    // Element ((k * 2 + half) * LANES + lane) * 4 + j is channel
    // slab0 + lane * 8 + half * 4 + j of tap k: a pixel's 8 lanes read 128
    // contiguous bytes per half.
    for (int i = tid; i < p.k * SLAB; i += THREADS) {
      const int j = i & 3, ln = (i >> 2) & (LANES - 1), half = (i >> 5) & 1, k = i >> 6;
      const int n = slab0 + ln * OCT + half * 4 + j;
      sw[i] = n < p.cout ? bf16_value(p.w[(long long)n * p.k + k]) : 0.f;
    }
  }
  __syncthreads();
  int off[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) off[k] = REG ? soff[k] : 0;

  const int row_elems = p.sw * p.cin, stage_elems = p.sh * row_elems;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = tile_of(p, tile);
    const int oy0 = tl.oy0, ox0 = tl.ox0;
    const long long img = tl.img;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < stage_elems; i += THREADS) {
      const int r = i / row_elems;
      sx[i] = staged(p, tl, r, i - r * row_elems);
    }
    __syncthreads();

    if (active) {
      const int cols = p.wo - ox0 < p.tw ? p.wo - ox0 : p.tw;
      const bool two = oy0 + 1 < p.ho;  // the tile's second row is in the image
      const int rs = row_elems;          // the second pixel's taps: one staged row down
      const long long m0 = (img * p.ho + oy0) * p.wo + ox0;  // the tile's first pixel
      for (int lx = slot; lx < cols; lx += SLOTS) {
        const float* xs = sx + lx * p.cin;
        float a0[OCT], a1[OCT];
#pragma unroll
        for (int e = 0; e < OCT; ++e) a0[e] = a1[e] = 0.f;
        if (REG) {
          float x0[NR], x1[NR];
#pragma unroll
          for (int k = 0; k < NR; ++k) {
            x0[k] = xs[off[k]];
            x1[k] = xs[off[k] + rs];
          }
#pragma unroll
          for (int k = 0; k < NR; ++k)
#pragma unroll
            for (int e = 0; e < OCT; ++e) {
              a0[e] = __fmaf_rn(x0[k], wr[k][e], a0[e]);
              a1[e] = __fmaf_rn(x1[k], wr[k][e], a1[e]);
            }
        } else {
#pragma unroll 2
          for (int k = 0; k < p.k; ++k) {
            const float x0 = xs[soff[k]], x1 = xs[soff[k] + rs];
            const float4 w0 = *reinterpret_cast<const float4*>(sw + ((k * 2) * LANES + lane) * 4);
            const float4 w1 =
                *reinterpret_cast<const float4*>(sw + ((k * 2 + 1) * LANES + lane) * 4);
            const float wk[OCT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int e = 0; e < OCT; ++e) {
              a0[e] = __fmaf_rn(x0, wk[e], a0[e]);
              a1[e] = __fmaf_rn(x1, wk[e], a1[e]);
            }
          }
        }
        store<MODE>(p, m0 + lx, n0, a0, vb, vs, vt);
        if (two) store<MODE>(p, m0 + p.wo + lx, n0, a1, vb, vs, vt);
      }
    }
  }
}

template <int MODE, int KR>
int launch(const Params& p, int device, cudaStream_t s) {
  const auto kernel = conv_stage_direct_kernel<MODE, KR>;
  const int smem = ((KR > 0 ? 0 : p.k * SLAB) + p.k + p.sh * p.sw * p.cin) * 4;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const dim3 grid((unsigned)(p.tiles < resident ? p.tiles : resident),
                  (unsigned)((p.cout + SLAB - 1) / SLAB));
  kernel<<<grid, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int KR>
int by_mode(const Params& p, int mode, int device, cudaStream_t s) {
  if (mode == BIAS_BF16) return launch<BIAS_BF16, KR>(p, device, s);
  if (mode == RELU_AFFINE_BF16) return launch<RELU_AFFINE_BF16, KR>(p, device, s);
  if (mode == BIAS_F32) return launch<BIAS_F32, KR>(p, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) NHWC bf16, contiguous; wt: (cout, kh, kw, cin) bf16,
// contiguous, cin <= 7, kh <= 3, kw <= 3; b, s, t: float32 (cout,) (s and t read
// only in mode 1); y: (n, h + 2 ph - kh + 1, w + 2 pw - kw + 1, cout), bf16
// (modes 0, 1) or float32 (mode 2), contiguous; z: null or float32 of y's
// shape, written (acc + b) in mode 1 only; all on `device`. Launches on
// `stream` and does not synchronise. Returns a cudaError_t (0 = launched, or
// no work).
int lm_conv_stage_direct(const void* x, const void* wt, const void* b, const void* s,
                         const void* t, void* y, void* z, int64_t n, int64_t h, int64_t w,
                         int64_t cin, int64_t cout, int64_t kh, int64_t kw, int64_t ph, int64_t pw,
                         int mode, int device, void* stream) {
  const int64_t ho = h + 2 * ph - kh + 1, wo = w + 2 * pw - kw + 1;
  if (n <= 0 || ho <= 0 || wo <= 0 || cout <= 0) return 0;
  if (cin <= 0 || cin > CIN_MAX || kh <= 0 || kh > KSIZE_MAX || kw <= 0 || kw > KSIZE_MAX ||
      ph < 0 || pw < 0 ||
      h > INT_MAX || w > INT_MAX || ho > INT_MAX || wo > INT_MAX ||
      (cout + SLAB - 1) / SLAB > 65535)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Params p;
  p.x = static_cast<const unsigned short*>(x);
  p.w = static_cast<const unsigned short*>(wt);
  p.b = static_cast<const float*>(b);
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.y = y;
  p.z = static_cast<float*>(z);
  p.h = (int)h;
  p.w_in = (int)w;
  p.cin = (int)cin;
  p.cout = (int)cout;
  p.kw = (int)kw;
  p.ph = (int)ph;
  p.pw = (int)pw;
  p.ho = (int)ho;
  p.wo = (int)wo;
  p.k = (int)(kh * kw * cin);
  p.tw = wo < TILE_W ? (int)wo : TILE_W;
  p.sh = TILE_ROWS + (int)kh - 1;
  p.sw = p.tw + (int)kw - 1;
  p.tiles_x = (p.wo + p.tw - 1) / p.tw;
  p.tiles_y = (p.ho + TILE_ROWS - 1) / TILE_ROWS;
  p.tiles = n * p.tiles_x * p.tiles_y;
  p.vec = cout % OCT == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.k == 9) return by_mode<9>(p, mode, device, st);
  if (p.k == 1) return by_mode<1>(p, mode, device, st);
  return by_mode<0>(p, mode, device, st);
}

}  // extern "C"
