// K4: one bf16 convolution stage of the U-Net, hand-written for Hopper
// (sm_90a):
//
//   y = cast( epilogue( conv(x, w) accumulated in float32 + b ) )
//
// with the epilogue ReLU then the folded-BatchNorm affine (y * s + t), or
// nothing (bias only). The output is bf16, rounded once, or float32. In the
// ReLU + affine mode the kernel also writes, given z, the float32
// pre-activation acc + b that the stage's backward reads
// (ops/kernels/conv_stage.py::ConvStage).
//
// It replaces what XLA computes for the JAX U-Net's bf16 conv stage (no
// Pallas kernel there: XLA's convolution and its fusion):
//   lungmask_tpu/models/unet.py:61-81    _conv_acc32: lax.conv_general_dilated
//                                        with preferred_element_type=float32
//   lungmask_tpu/models/unet.py:107-114  _conv: the float32 bias added to it
//   lungmask_tpu/models/unet.py:167-172  jnp.maximum(., 0), _affine in
//                                        float32, then .astype(bfloat16)
// A bf16 torch convolution rounds its output to bf16 before the bias; this
// kernel keeps the float32 accumulator through the bias, the ReLU and the
// affine and rounds once, as JAX does. The products and sums of the
// epilogue are __fadd_rn / __fmul_rn in the plain version's order
// ((acc + b), max, (. * s) + t): nvcc would otherwise contract them into an
// FMA, which rounds once where the plain version rounds twice.
//
// Layouts: x is NHWC bf16 (n, h, w, cin), contiguous; w is bf16
// (cout, kh, kw, cin), contiguous (ops/kernels/conv_stage.py::weight_layout);
// b, s, t are float32 (cout,); y is NHWC (n, ho, wo, cout) with
// ho = h + 2 ph - kh + 1, wo = w + 2 pw - kw + 1 and zeros outside x.
//
// What bounds it on this card: operations. At the U-Net's shapes (batch 32
// of 256x256, wf=6) the 18 3x3 convs do 3.08 TFLOP in bf16 (3.1 ms at the
// H100's 989 TFLOP/s) against 2.0 GB of activations (0.6 ms at 3.35 TB/s);
// only the first (cin = 1) and the 1x1 projections are bound by bytes.
//
// This file is K4's mma.sync route: the stages whose cin is neither under
// 8 nor a multiple of 64, or whose operands are not 16-byte aligned, and any
// stage when forced (the yardstick). Cin under 8 (the first conv's cin = 1)
// takes the direct route, csrc/conv_stage_direct.cu; cin a multiple of 64
// the wgmma/TMA route, csrc/conv_stage_sm90.cu; all keep the numerics below.
//
// Design: an implicit GEMM, M = n*ho*wo output pixels, N = cout, K =
// kh*kw*cin in the order (ky, kx, c). A block computes a BM x BN tile of
// the output (BM = 128 pixels, BN = 128 channels, or 64 where cout <= 64)
// with 8 warps; each warp a (BM / WARPS_M) x 32 sub-tile with
// mma.sync.m16n8k16 bf16 -> float32, its fragments read from shared memory
// with ldmatrix. K is walked in slices of BK = 32 through a ring of STAGES
// shared-memory tiles filled by 16-byte cp.async (a pixel's 8 channels of
// one tap; a tap's padding, a ragged M or N tile and K's tail are
// predicated zero-fills), so the loads of slice k + 3 overlap the MMAs of
// slice k. The tiles are stored in 64-byte rows, their 16-byte chunks
// XOR-swizzled by row so that ldmatrix's eight rows fall in distinct banks.
// The epilogue runs in registers on the accumulator and stores each output
// element once (two channels per store). A cin that is not a multiple of 8
// (the first conv's cin = 1) or an unaligned base takes the scalar path:
// the same tiles filled by plain loads, element by element.
//
// Every output element sums its K products in the same order (the slices
// in order, each through the same MMA positions), whatever its tile, so a
// band of rows padded with its neighbours' rows (padding (0, 1),
// parallel/halo.py) gives the same bits as the whole image.
//
// The float32 add of each MMA's partial (mma_bf16) costs speed for
// accuracy. __launch_bounds__(256, 2) holds a thread to 128 registers, so
// two blocks share an SM. PERF.md has the times.
//
// C interface for ctypes; the launcher returns cudaGetLastError().

#include <atomic>
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

constexpr int BM = 128;         // output pixels per block
constexpr int BK = 32;          // K per shared-memory slice: 64-byte rows
constexpr int THREADS = 256;    // 8 warps
constexpr int STAGES = 4;       // slices in flight
constexpr int CHUNKS = BK / 8;  // 16-byte chunks per row

// Epilogues.
constexpr int BIAS_BF16 = 0;         // cast(acc + b)
constexpr int RELU_AFFINE_BF16 = 1;  // cast(max(acc + b, 0) * s + t)
constexpr int BIAS_F32 = 2;          // acc + b, float32 out

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* b;
  const float* s;
  const float* t;
  void* y;
  float* z;     // acc + b, float32, or null (ReLU + affine mode only)
  long long m;  // n * ho * wo
  int h, w_in, cin, cout, kw, ph, pw, ho, wo;
  int k;        // kh * kw * cin
  int ktiles;   // ceil(k / BK)
  int ntiles;   // ceil(cout / BN)
};

// The 16-byte unit of (row, chunk) in a tile of 64-byte rows: the chunk
// XOR-ed with bits 1-2 of the row, so 8 consecutive rows at one chunk hit
// 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * CHUNKS + (chunk ^ ((row >> 1) & 3));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; zeros where !pred (no bytes read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// acc += a (16x16, row) * b (16x8, col), bf16 in: the tensor core sums the
// 16 exact products of each output from zero, then an IEEE float32 add
// (round to nearest) takes that partial into the accumulator, as a plain
// float32 sum would. Chained through the tensor core's own float32
// accumulator instead, a sum over thousands of products drifts: the H100's
// accumulator does not round to nearest.
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], d[r]);
}

// An output pixel's place: its input pixel (oy, ox) of image img, as the
// element offset of x[img, oy, ox, 0] (taps add their own offsets).
struct Pixel {
  long long base;
  int oy, ox;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, long long m) {
  Pixel px;
  px.ok = m < p.m;
  if (!px.ok) m = 0;
  const long long q = m / p.wo;
  px.ox = (int)(m - q * p.wo);
  const long long img = q / p.ho;
  px.oy = (int)(q - img * p.ho);
  px.base = ((img * p.h + px.oy) * (long long)p.w_in + px.ox) * p.cin;
  return px;
}

// Tap of K index k (< p.k): its row and column offsets and channel.
struct Tap {
  int dy, dx, c;
};

__device__ __forceinline__ Tap tap_of(const Params& p, int k) {
  const int tap = k / p.cin;
  const int ky = tap / p.kw;
  Tap t;
  t.c = k - tap * p.cin;
  t.dy = ky - p.ph;
  t.dx = tap - ky * p.kw - p.pw;
  return t;
}

__device__ __forceinline__ bool inside(const Params& p, const Pixel& px, const Tap& t) {
  const int iy = px.oy + t.dy, ix = px.ox + t.dx;
  return px.ok && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;
}

__device__ __forceinline__ long long offset_of(const Params& p, const Pixel& px, const Tap& t) {
  return px.base + ((long long)t.dy * p.w_in + t.dx) * p.cin + t.c;
}

// The epilogue of z = acc + b: ReLU then the affine, or z itself.
template <int MODE>
__device__ __forceinline__ float epilogue(float z, float s, float t) {
  if (MODE != RELU_AFFINE_BF16) return z;
  const float r = z < 0.f ? 0.f : z;
  return __fadd_rn(__fmul_rn(r, s), t);
}

template <int BN, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, 2) conv_stage_kernel(const Params p) {
  constexpr int WARPS_N = BN / 32;
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // 64 (BN 128) or 32 (BN 64)
  constexpr int MT = WM / 16;       // m16 tiles per warp
  constexpr int NT = 4;             // n8 tiles per warp (32 channels)
  constexpr int A_UNITS = BM * CHUNKS;  // 16-byte units of an A slice
  constexpr int B_UNITS = BN * CHUNKS;
  constexpr int A_ROWS = A_UNITS / THREADS;  // A rows a thread fills
  constexpr int RSTEP = THREADS / CHUNKS;    // rows between them
  constexpr int B_LOOPS = (B_UNITS + THREADS - 1) / THREADS;

  extern __shared__ uint4 smem[];
  uint4* const sA = smem;                     // STAGES x A_UNITS
  uint4* const sB = smem + STAGES * A_UNITS;  // STAGES x B_UNITS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long mt = (long long)blockIdx.x / p.ntiles;
  const int n0 = (int)((long long)blockIdx.x - mt * p.ntiles) * BN;
  const long long m0 = mt * BM;

  // A thread fills 16-byte chunk tid % CHUNKS (8 K positions) of A rows
  // tid / CHUNKS + RSTEP i and of B rows the same way; the vector path with
  // one cp.async each, the scalar path element by element.
  const int chunk = tid % CHUNKS;
  Pixel px[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) px[i] = pixel_of(p, m0 + tid / CHUNKS + RSTEP * i);

  const unsigned short* const xs = reinterpret_cast<const unsigned short*>(p.x);
  const unsigned short* const ws = reinterpret_cast<const unsigned short*>(p.w);

  auto load = [&](int stage, int kt) {
    uint4* a = sA + stage * A_UNITS;
    uint4* b = sB + stage * B_UNITS;
    const int k = kt * BK + chunk * 8;
    if (VEC) {
      const bool kin = k < p.k;  // cin % 8 == 0: a chunk is in K whole or not at all
      const Tap t = tap_of(p, kin ? k : 0);
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const bool ok = kin && inside(p, px[i], t);
        cp_async16(a + swz(tid / CHUNKS + RSTEP * i, chunk),
                   ok ? p.x + offset_of(p, px[i], t) : p.x, ok);
      }
#pragma unroll
      for (int j = 0; j < B_LOOPS; ++j) {
        const int row = (tid + THREADS * j) / CHUNKS;
        if (B_UNITS % THREADS && tid + THREADS * j >= B_UNITS) break;
        const bool ok = kin && n0 + row < p.cout;
        cp_async16(b + swz(row, chunk), ok ? p.w + (long long)(n0 + row) * p.k + k : p.w, ok);
      }
    } else {
      alignas(16) unsigned short v[8];
      const uint4* vv = reinterpret_cast<const uint4*>(v);
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          unsigned short val = 0;
          if (k + e < p.k) {
            const Tap t = tap_of(p, k + e);
            if (inside(p, px[i], t)) val = xs[offset_of(p, px[i], t)];
          }
          v[e] = val;
        }
        a[swz(tid / CHUNKS + RSTEP * i, chunk)] = *vv;
      }
#pragma unroll
      for (int j = 0; j < B_LOOPS; ++j) {
        const int row = (tid + THREADS * j) / CHUNKS;
        if (B_UNITS % THREADS && tid + THREADS * j >= B_UNITS) break;
        const bool nin = n0 + row < p.cout;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (nin && k + e < p.k) ? ws[(long long)(n0 + row) * p.k + k + e]
                                      : (unsigned short)0;
        b[swz(row, chunk)] = *vv;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < p.ktiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < p.ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt is in; every warp is done with slice kt - 1
    const int next = kt + STAGES - 1;
    if (next < p.ktiles) load(next % STAGES, next);
    cp_async_commit();
    const uint4* a = sA + (kt % STAGES) * A_UNITS;
    const uint4* b = sB + (kt % STAGES) * B_UNITS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned af[MT][4], bf[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + swz(wm * WM + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4(bf[j], b + swz(wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   ks * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j & 1) * 2], bf[j / 2][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator element r of tile (i, j) is output pixel
  // m0 + wm*WM + 16 i + lane/4 (+ 8 for r >= 2), channel
  // n0 + wn*32 + 8 j + 2 (lane % 4) (+ 1 for odd r).
  float vb[NT][2], vs[NT][2], vt[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + e;
      const bool ok = n < p.cout;
      vb[j][e] = ok ? p.b[n] : 0.f;
      vs[j][e] = (MODE == RELU_AFFINE_BF16 && ok) ? p.s[n] : 0.f;
      vt[j][e] = (MODE == RELU_AFFINE_BF16 && ok) ? p.t[n] : 0.f;
    }
  const bool pairs = (p.cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long m = m0 + wm * WM + i * 16 + (lane >> 2) + hr * 8;
      if (m >= p.m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
        if (n >= p.cout) continue;
        const float z0 = __fadd_rn(acc[i][j][hr * 2], vb[j][0]);
        const float z1 = __fadd_rn(acc[i][j][hr * 2 + 1], vb[j][1]);
        const float v0 = epilogue<MODE>(z0, vs[j][0], vt[j][0]);
        const float v1 = epilogue<MODE>(z1, vs[j][1], vt[j][1]);
        const long long at = m * p.cout + n;
        if (MODE == RELU_AFFINE_BF16 && p.z != nullptr) {
          if (pairs) {
            *reinterpret_cast<float2*>(p.z + at) = make_float2(z0, z1);
          } else {
            p.z[at] = z0;
            if (n + 1 < p.cout) p.z[at + 1] = z1;
          }
        }
        if (MODE == BIAS_F32) {
          float* y = static_cast<float*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            y[0] = v0;
            if (n + 1 < p.cout) y[1] = v1;
          }
        } else {
          __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + at;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y) =
                __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
          } else {
            y[0] = __float2bfloat16_rn(v0);
            if (n + 1 < p.cout) y[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device: once per device (a bit of `devices` each), not on every launch.
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

template <int BN, bool VEC, int MODE>
int launch(Params p, cudaStream_t s) {
  p.ntiles = (p.cout + BN - 1) / BN;
  const long long blocks = (p.m + BM - 1) / BM * p.ntiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  constexpr int smem = STAGES * (BM + BN) * BK * 2;
  const auto kernel = conv_stage_kernel<BN, VEC, MODE>;
  static std::atomic<uint64_t> allowed{0};
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int BN, bool VEC>
int by_mode(const Params& p, int mode, cudaStream_t s) {
  if (mode == BIAS_BF16) return launch<BN, VEC, BIAS_BF16>(p, s);
  if (mode == RELU_AFFINE_BF16) return launch<BN, VEC, RELU_AFFINE_BF16>(p, s);
  if (mode == BIAS_F32) return launch<BN, VEC, BIAS_F32>(p, s);
  return (int)cudaErrorInvalidValue;
}

template <int BN>
int by_path(const Params& p, bool vec, int mode, cudaStream_t s) {
  return vec ? by_mode<BN, true>(p, mode, s) : by_mode<BN, false>(p, mode, s);
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) NHWC bf16, contiguous; wt: (cout, kh, kw, cin) bf16,
// contiguous; b, s, t: float32 (cout,) (s and t read only in mode 1); y:
// (n, h + 2 ph - kh + 1, w + 2 pw - kw + 1, cout), bf16 (modes 0, 1) or
// float32 (mode 2), contiguous; z: null or float32 of y's shape, written
// (acc + b) in mode 1 only; all on `device`. Launches on `stream` and does
// not synchronise. Returns a cudaError_t (0 = launched, or no work).
int lm_conv_stage(const void* x, const void* wt, const void* b, const void* s, const void* t,
                  void* y, void* z, int64_t n, int64_t h, int64_t w, int64_t cin, int64_t cout,
                  int64_t kh, int64_t kw, int64_t ph, int64_t pw, int mode, int device,
                  void* stream) {
  const int64_t ho = h + 2 * ph - kh + 1, wo = w + 2 * pw - kw + 1;
  if (n <= 0 || ho <= 0 || wo <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kh <= 0 || kw <= 0 || ph < 0 || pw < 0 || h > INT_MAX || w > INT_MAX ||
      cout > INT_MAX || kh * kw * cin > INT_MAX - BK)
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(wt);
  p.b = static_cast<const float*>(b);
  p.s = static_cast<const float*>(s);
  p.t = static_cast<const float*>(t);
  p.y = y;
  p.z = static_cast<float*>(z);
  p.m = n * ho * wo;
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
  p.ktiles = (p.k + BK - 1) / BK;
  p.ntiles = 0;
  const bool vec = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(wt) % 16) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout <= 64 ? by_path<64>(p, vec, mode, st) : by_path<128>(p, vec, mode, st);
}

}  // extern "C"
