// K2 and K3: the U-Net's 2x2 average pooling and bilinear x2 upsampling,
// hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels of lungmask_tpu/ops/pallas/stencil.py:
//   K2 avg_pool2_pallas (body _pool_kernel): NHWC 2x2 stride-2 mean. The row
//      pair is summed first, then the column pair, in float32:
//      (x00 + x10) + (x01 + x11), times 0.25, one rounding to the input
//      dtype. An odd H or W drops its last row or column (floor), as the
//      U-Net's VALID window does.
//   K3 bilinear_up2_pallas (body _up2_kernel): NHWC bilinear x2 with
//      half-pixel centres. Row pass: even = 0.25*prev + 0.75*cur,
//      odd = 0.75*cur + 0.25*next, edge rows clamped, kept in float32; then
//      the same column pass with edge columns clamped; one rounding.
// Both are bit-equal to the plain torch versions in ops/kernels/stencil.py,
// in float32 and bfloat16. Every product and sum is written with
// __fmul_rn / __fadd_rn: nvcc would otherwise contract 0.25f*a + 0.75f*b
// into an FMA, which rounds once where the plain version rounds twice.
//
// What bounds them on this card: bytes. Each input element is read from
// device memory once and each output element written once, with a few
// flops per element. At the U-Net's shapes (batch 32 of 256x256, wf=6,
// bf16) the four pools move 629 MB and the four upsamples 1258 MB per chunk:
// 0.188 ms and 0.376 ms at 3.35 TB/s. Design: a grid-stride loop with one
// thread per output pixel (K2) or per input pixel and its 2x2 output quad
// (K3), each thread on a vector of channels. Neighbouring threads take
// neighbouring channel vectors of the channels_last layout, so a warp's
// 16-byte loads and stores coalesce; a scalar path serves a C that is not a
// multiple of the vector width (or an unaligned pointer). K3's 3x3
// neighbourhood is read through L1/L2 (each input element by up to nine
// threads, from cache after the first). Offsets are int64: a batch of 512
// at 256x256x64 passes 2^31 elements.
//
// C interface for ctypes; each launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive channels of one pixel: one 16-byte access when
// V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f32(pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) pk.v[k] = from_f32<T>(in[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// 0.25*a + 0.75*b: two roundings for the products, one for the sum.
__device__ __forceinline__ float quarter_lerp(float a, float b) {
  return __fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.75f, b));
}

template <typename T, int V>
__global__ void avg_pool2_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                                 int64_t h, int64_t w, int64_t c) {
  const int64_t ho = h / 2, wo = w / 2, cv = c / V;
  const int64_t total = n * ho * wo * cv;
  const int64_t row = w * c;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = t / cv;  // output pixel (b, i, j) in raster order
    const int64_t ch = (t - r * cv) * V;
    const int64_t j = r % wo;
    r /= wo;
    const int64_t i = r % ho;
    const int64_t b = r / ho;
    const T* p = x + ((b * h + 2 * i) * w + 2 * j) * c + ch;
    float x00[V], x01[V], x10[V], x11[V];  // x<row><column>
    load_f32<T, V>(p, x00);
    load_f32<T, V>(p + c, x01);
    load_f32<T, V>(p + row, x10);
    load_f32<T, V>(p + row + c, x11);
    float s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = __fmul_rn(__fadd_rn(__fadd_rn(x00[k], x10[k]), __fadd_rn(x01[k], x11[k])), 0.25f);
    }
    store_f32<T, V>(y + t * V, s);  // y is (n, ho, wo, c): element t * V
  }
}

template <typename T, int V>
__global__ void bilinear_up2_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                                    int64_t h, int64_t w, int64_t c) {
  const int64_t cv = c / V;
  const int64_t total = n * h * w * cv;
  const int64_t row = w * c, out_row = 2 * w * c;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = t / cv;  // input pixel (b, i, j) in raster order
    const int64_t ch = (t - r * cv) * V;
    const int64_t j = r % w;
    r /= w;
    const int64_t i = r % h;
    const int64_t b = r / h;
    const int64_t up = i > 0 ? i - 1 : 0, down = i + 1 < h ? i + 1 : h - 1;
    const int64_t cols[3] = {j > 0 ? j - 1 : 0, j, j + 1 < w ? j + 1 : w - 1};
    // Row pass at columns j-1, j, j+1 (clamped): ev for output row 2i,
    // od for output row 2i+1.
    float ev[3][V], od[3][V];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T* col = x + (b * h * w + cols[q]) * c + ch;
      float above[V], mid[V], below[V];
      load_f32<T, V>(col + up * row, above);
      load_f32<T, V>(col + i * row, mid);
      load_f32<T, V>(col + down * row, below);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ev[q][k] = quarter_lerp(above[k], mid[k]);
        od[q][k] = quarter_lerp(below[k], mid[k]);
      }
    }
    // Column pass: output columns 2j (left) and 2j+1 (right) of both rows.
    T* o = y + ((b * 2 * h + 2 * i) * 2 * w + 2 * j) * c + ch;
    float left[V], right[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      left[k] = quarter_lerp(ev[0][k], ev[1][k]);
      right[k] = quarter_lerp(ev[2][k], ev[1][k]);
    }
    store_f32<T, V>(o, left);
    store_f32<T, V>(o + c, right);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      left[k] = quarter_lerp(od[0][k], od[1][k]);
      right[k] = quarter_lerp(od[2][k], od[1][k]);
    }
    store_f32<T, V>(o + out_row, left);
    store_f32<T, V>(o + out_row + c, right);
  }
}

unsigned blocks_for(int64_t threads) {
  const int64_t b = (threads + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// The 16-byte vector path needs whole vectors of channels and aligned bases.
template <typename T>
bool vectorizable(const void* x, const void* y, int64_t c) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  return c % (16 / sizeof(T)) == 0 && (bases & 15) == 0;
}

template <typename T>
int pool(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t pixels = n * (h / 2) * (w / 2);
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  if (vectorizable<T>(x, y, c)) {
    avg_pool2_kernel<T, VEC><<<blocks_for(pixels * (c / VEC)), THREADS, 0, s>>>(in, out, n, h, w, c);
  } else {
    avg_pool2_kernel<T, 1><<<blocks_for(pixels * c), THREADS, 0, s>>>(in, out, n, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int up2(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t pixels = n * h * w;
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  if (vectorizable<T>(x, y, c)) {
    bilinear_up2_kernel<T, VEC><<<blocks_for(pixels * (c / VEC)), THREADS, 0, s>>>(in, out, n, h, w, c);
  } else {
    bilinear_up2_kernel<T, 1><<<blocks_for(pixels * c), THREADS, 0, s>>>(in, out, n, h, w, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, h, w, c) NHWC-contiguous, dtype 0 = float32, 1 = bfloat16, on
// `device`; y: (n, h/2, w/2, c) of the same dtype. Launches on `stream` and
// does not synchronise. Returns a cudaError_t (0 = launched, or no work).
int lm_avg_pool2(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c, int dtype,
                 int device, void* stream) {
  if (n * (h / 2) * (w / 2) * c <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pool<float>(x, y, n, h, w, c, s);
  if (dtype == 1) return pool<__nv_bfloat16>(x, y, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// x: (n, h, w, c) as above; y: (n, 2h, 2w, c).
int lm_bilinear_up2(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c,
                    int dtype, int device, void* stream) {
  if (n * h * w * c <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return up2<float>(x, y, n, h, w, c, s);
  if (dtype == 1) return up2<__nv_bfloat16>(x, y, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
