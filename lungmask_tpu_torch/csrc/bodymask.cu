// K1: the fused per-slice bodymask pipeline, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel lungmask_tpu/ops/pallas/bodymask.py
// (bodymask_labels_pallas, body _bodymask_kernel). Per 128x128 HU slice:
//   1. threshold > -500 HU;
//   2. binary closing, cross structure (dilate, then erode; zero-filled
//      shifts, so the erosion eats the border);
//   3. hole fill: flood the complement from the border with the 8-neighbour
//      structure until nothing changes; the unreached complement is a hole;
//   4. erosion x2, cross;
//   5. 4-connected labels, root = raster-first linear index + 1, background 0.
// Outputs: int32 labels and the eroded mask (uint8), bit-equal to the TPU
// kernel and to the plain torch chain in ops/kernels/bodymask.py.
//
// What bounds it on this card: not bytes (64 KB of HU in, 80 KB out per
// slice) but the latency of the two fixpoint loops, each a sequence of
// block-wide barriers over one ~16K-pixel plane. Design: one block of 1024
// threads per slice, every plane in shared memory for the whole pipeline
// (96 KB: an int32 label plane and two uint8 mask planes), each thread owning
// 16 pixels strided by 1024 so global loads and stores coalesce. Single-step
// dilations/erosions read one plane and write the other. The two fixpoint
// loops update in place (the same monotone fixpoint, reached in fewer
// rounds) and stop on __syncthreads_or of a per-thread "changed" flag; the
// label loop also jumps each label to the label of the pixel it names.
//
// C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 128;
constexpr int PLANE = N * N;
constexpr int THREADS = 1024;
constexpr int PER_THREAD = PLANE / THREADS;
constexpr float BODY_THRESHOLD = -500.0f;
constexpr int SMEM_BYTES = PLANE * (int)sizeof(int32_t) + 2 * PLANE;

__device__ __forceinline__ uint8_t at(const uint8_t* p, int y, int x) {
  return (y >= 0 && y < N && x >= 0 && x < N) ? p[y * N + x] : 0;
}

// One cross-structure dilation (kDilate) or erosion step, src -> dst, with
// out-of-plane neighbours read as 0.
template <bool kDilate>
__device__ __forceinline__ void cross_step(const uint8_t* src, uint8_t* dst) {
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int y = i / N, x = i % N;
    const uint8_t c = src[i], u = at(src, y - 1, x), d = at(src, y + 1, x),
                  l = at(src, y, x - 1), r = at(src, y, x + 1);
    dst[i] = kDilate ? (c | u | d | l | r) : (c & u & d & l & r);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    bodymask_kernel(const float* __restrict__ hu, int32_t* __restrict__ labels_out,
                    uint8_t* __restrict__ mask_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* lab = reinterpret_cast<int32_t*>(smem);
  uint8_t* a = smem + PLANE * sizeof(int32_t);
  uint8_t* b = a + PLANE;
  const size_t base = (size_t)blockIdx.x * PLANE;

  // 1. threshold
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    a[i] = hu[base + i] > BODY_THRESHOLD;
  }
  __syncthreads();

  // 2. closing (cross): a -> b -> a
  cross_step<true>(a, b);
  cross_step<false>(b, a);

  // 3. hole fill (8-neighbour flood of the complement from the border),
  //    b = reached
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int y = i / N, x = i % N;
    const bool border = y == 0 || y == N - 1 || x == 0 || x == N - 1;
    b[i] = border && !a[i];
  }
  __syncthreads();
  {
    volatile uint8_t* reached = b;
    while (true) {
      int changed = 0;
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (a[i] || reached[i]) continue;
        const int y = i / N, x = i % N;
        bool hit = false;
        for (int dy = -1; dy <= 1 && !hit; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= N) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if (xx >= 0 && xx < N && reached[yy * N + xx]) {
              hit = true;
              break;
            }
          }
        }
        if (hit) {
          reached[i] = 1;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
  }
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    a[i] = a[i] | (b[i] ^ 1);  // body, or complement the flood never reached
  }
  __syncthreads();

  // 4. erosion x2 (cross): a -> b -> a
  cross_step<false>(a, b);
  cross_step<false>(b, a);

  // 5. eroded mask out; labels start at linear index + 1 on the foreground
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    mask_out[base + i] = a[i];
    lab[i] = a[i] ? i + 1 : 0;
  }
  __syncthreads();

  // 6. 4-connected min-label propagation to the fixpoint
  {
    volatile int32_t* L = lab;
    while (true) {
      int changed = 0;
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = threadIdx.x + k * THREADS;
        const int v = L[i];
        if (v == 0) continue;
        const int y = i / N, x = i % N;
        int m = v;
        int n;
        if (y > 0 && (n = L[i - N]) != 0 && n < m) m = n;
        if (y < N - 1 && (n = L[i + N]) != 0 && n < m) m = n;
        if (x > 0 && (n = L[i - 1]) != 0 && n < m) m = n;
        if (x < N - 1 && (n = L[i + 1]) != 0 && n < m) m = n;
        // Pixel m - 1 lies in this component and its label is <= m.
        n = L[m - 1];
        if (n != 0 && n < m) m = n;
        if (m < v) {
          L[i] = m;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
  }
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    labels_out[base + i] = lab[i];
  }
}

}  // namespace

extern "C" {

// hu: (batch, 128, 128) float32; labels: int32 and mask: uint8 of the same
// shape, all contiguous on `device`. Launches on `stream` and does not
// synchronise. Returns a cudaError_t (0 = launched).
int lm_bodymask_labels(const void* hu, void* labels, void* mask, int64_t batch,
                       int device, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bodymask_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  bodymask_kernel<<<(unsigned)batch, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(hu), static_cast<int32_t*>(labels),
      static_cast<uint8_t*>(mask));
  return (int)cudaGetLastError();
}

}  // extern "C"
