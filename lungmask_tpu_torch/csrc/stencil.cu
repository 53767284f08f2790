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
// 0.188 ms and 0.376 ms at 3.35 TB/s. Offsets of a pixel are int64: a batch
// of 512 at 256x256x64 passes 2^31 elements.
//
// K2: a grid-stride loop with one thread per output pixel over a vector of
// channels. Neighbouring threads take neighbouring channel vectors of the
// channels_last layout, so a warp's 16-byte loads and stores coalesce; a
// scalar path serves a C that is not a multiple of the vector width (or an
// unaligned pointer).
//
// K3: its first design gave each thread one input pixel and its 2x2 output
// quad, with an int64 division chain per thread, the row pass redone at
// columns j-1, j and j+1 (nine 16-byte loads and three times the float work
// per input element, the neighbours re-read through L1/L2), 62 registers;
// it reached 13-15% of the byte bound at every shape, held back by
// instruction issue and latency, not bytes. This design tiles: a block
// stages a clamped (rows+2) x (tile_w+2) x slab input tile in shared memory
// with 16-byte cp.async (each element read from device memory at most
// (rows+2)/rows x (tile_w+2)/tile_w times), computes the row pass once per
// staged element and parity, keeps the column neighbours in registers while
// a thread walks the tile's columns, and stores 16 bytes per thread with a
// warp on 32 consecutive channel vectors. One division chain per block, on
// blockIdx; int32 inside the tile, int64 for pixel offsets. The tile plan
// (ops/kernels/stencil.py::up2_plan) is chosen per shape so that the
// U-Net's smallest upsample (32 x 16 x 16 x 1024) still gives several
// blocks per SM; shared memory above 48 KB is asked for with
// cudaFuncSetAttribute, once per device. Ragged H, W and slabs are clamped on load and
// masked on store; the scalar path (V = 1) copies with plain loads.
//
// K2T and K3T, their adjoints, for the U-Net's backward. They replace XLA's
// transposes of unet._avg_pool2 and unet._bilinear_up2 (the JAX package
// has no backward kernel). Same bound as the forwards: one read of the
// gradient g, one write of the input gradient dx (0.188 ms and 0.376 ms
// per 32-slice bf16 chunk at the U-Net's shapes, at 3.35 TB/s).
//   K2T lm_avg_pool2_bwd: dx[2i+a, 2j+b] = 0.25 * g[i, j], exact in float32
//      and rounded once to the dtype; the last row or column an odd H or W
//      dropped gets 0.
//   K3T lm_bilinear_up2_bwd, in gather form (no atomics): per axis
//      dx[i] = (0.25*g[2i-1] + 0.75*g[2i]) + (0.75*g[2i+1] + 0.25*g[2i+2])
//      with the tap indices clamped to [0, 2n): the clamp is the forward's
//      edge rule transposed (dx[0] also takes 0.25*g[0], dx[n-1] also
//      0.25*g[2n-1]). The row pass first, kept in float32, then the column
//      pass, one rounding; __fmul_rn / __fadd_rn in the plain version's
//      order, so it is bit-equal to bilinear_up2_bwd_reference.
// Their first designs ran one thread per 16-byte dx vector with an int64
// division chain per thread. K2T read each g vector from 4 threads; K3T
// made 16 sixteen-byte loads per output (each g vector fetched by 4
// threads through L1/L2), redid the row pass at all 4 columns of every
// output (twice the float work) and took 70 registers in bf16; both sat at
// 52-72% of the bound at batch 32. Now:
//   K2T: one thread per quad of dx over one channel vector — one 16-byte
//      load of g, x0.25, the quad's (up to) four 16-byte stores; blocks over
//      (image, quad row, chunk), so one division chain per block and one
//      int32 division per thread. 24 registers (bf16), 22 (f32), no shared
//      memory.
//   K3T: the mirror of K3's tile. A block stages the clamped
//      (2 rows + 2) x (2 tile_w + 2) g window of its dx tile with 16-byte
//      cp.async (not TMA: its out-of-bounds fill is zero, not the clamp),
//      each thread walks one dx row along the tile's columns computing the
//      row pass once per staged column, two new ones per dx vector; one
//      division chain per block, int32 in the tile, int64 for pixel
//      offsets. The plan (ops/kernels/stencil.py::up2_bwd_plan) takes 16
//      dx rows x 4 columns of an 8-vector slab: 42.5 KB of shared memory
//      and 128 threads a block, five blocks per SM, a warp's stores four
//      runs of 128 contiguous bytes. Timed on the H100 against 32-vector
//      slabs of 8 x 4 (90 KB, two blocks of 256 threads per SM), 4 x 4 and
//      8 x 2, and 16-vector slabs, it was the fastest at every U-Net
//      shape: narrower slabs give more blocks in flight while tiles load,
//      and taller tiles less halo. 55 registers (bf16), 40 (f32), no
//      spills.
// Ragged tiles and slabs are clamped on load and masked on store; the
// scalar path (V = 1: C not a whole number of vectors, or an unaligned
// base) copies with plain loads.
//
// C interface for ctypes; each launcher returns cudaGetLastError().

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Makes `device` current for a launch and restores the caller's device on
// every return path: the runtime's current device is per host thread and
// torch reads it, so a launch on a tensor of another card must not move it.
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

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 16;
constexpr int64_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

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

// Copy V consecutive channels global -> shared: one 16-byte cp.async
// (L2 only) when they make 16 bytes, else a plain copy.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    *reinterpret_cast<Pack<T, V>*>(dst) = *reinterpret_cast<const Pack<T, V>*>(src);
  }
}

// K3 on one tile: image b, input rows [i0, i0 + rows), columns
// [j0, j0 + tile_w), channel vectors [slab * cvt, (slab + 1) * cvt). The
// block stages the clamped (rows + 2) x (tile_w + 2) tile of its slab in
// shared memory (clamping the halo's index is the half-pixel edge rule).
// Thread (v, slot) owns channel vector v; its slots take output rows
// 2r + parity, r < rows. For each it walks the tile's columns once: the
// row pass of staged column jj + 2 (one value per staged element and
// parity), kept with the two before it in registers, gives the column pass
// of output columns 2j and 2j + 1. Consecutive threads hold consecutive
// channel vectors, so a warp's stores cover 32 x 16 contiguous bytes.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    bilinear_up2_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c,
                        int rows, int tile_w, int cvt, int tiles_h, int tiles_w, int slabs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  int t = blockIdx.x;  // the one division chain, per block
  const int slab = t % slabs;
  t /= slabs;
  const int tj = t % tiles_w;
  t /= tiles_w;
  const int ti = t % tiles_h;
  const int b = t / tiles_h;
  const int i0 = ti * rows, j0 = tj * tile_w;
  const int v = threadIdx.x % cvt, slot = threadIdx.x / cvt, slots = blockDim.x / cvt;
  const int ch = (slab * cvt + v) * V;
  const bool live = ch < c;  // the last slab may be short
  const int sw = tile_w + 2, staged = (rows + 2) * sw;
  const int64_t img = (int64_t)b * h * w;  // first pixel of image b
  if (live) {
    for (int p = slot; p < staged; p += slots) {
      const int rr = p / sw, cc = p - rr * sw;
      const int si = min(max(i0 - 1 + rr, 0), h - 1);
      const int sj = min(max(j0 - 1 + cc, 0), w - 1);
      stage<T, V>(tile + (p * cvt + v) * V, x + (img + (int64_t)si * w + sj) * c + ch);
    }
  }
  if constexpr (V * sizeof(T) == 16) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;
  const int cols = min(tile_w, w - j0);
  const int col = cvt * V;  // elements per staged pixel
  for (int q = slot; q < 2 * rows; q += slots) {
    const int r = q >> 1, odd = q & 1, i = i0 + r;
    if (i >= h) break;
    // Staged row r + 1 is input row i; row r (above) or r + 2 (below)
    // is its neighbour for this parity.
    const T* mid = tile + (r + 1) * sw * col + v * V;
    const T* nb = tile + (r + 2 * odd) * sw * col + v * V;
    float prev[V], cur[V], next[V], m[V], n[V];
    load_f32<T, V>(nb, n);
    load_f32<T, V>(mid, m);
#pragma unroll
    for (int k = 0; k < V; ++k) prev[k] = quarter_lerp(n[k], m[k]);
    load_f32<T, V>(nb + col, n);
    load_f32<T, V>(mid + col, m);
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = quarter_lerp(n[k], m[k]);
    // Output image b starts at pixel 4 * img; this is pixel (2i + odd, 2 j0).
    T* o = y + (img * 4 + (int64_t)(2 * i + odd) * (2 * w) + 2 * j0) * c + ch;
    for (int jj = 0; jj < cols; ++jj) {
      load_f32<T, V>(nb + (jj + 2) * col, n);
      load_f32<T, V>(mid + (jj + 2) * col, m);
      float left[V], right[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        next[k] = quarter_lerp(n[k], m[k]);
        left[k] = quarter_lerp(prev[k], cur[k]);
        right[k] = quarter_lerp(next[k], cur[k]);
      }
      store_f32<T, V>(o, left);
      store_f32<T, V>(o + c, right);
      o += 2 * c;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        prev[k] = cur[k];
        cur[k] = next[k];
      }
    }
  }
}

// K2T: one thread per quad of dx, (2i .. 2i+1, 2j .. 2j+1) over one
// vector of channels. Block (image b, quad row i, chunk) and thread
// (quad column j, channel vector v) of that row: one division chain per
// block, one int32 division per thread, int64 for pixel offsets. A thread
// loads its g vector once (g[i, j] when the quad is a whole window, else
// 0: the row or column an odd H or W dropped), scales it by 0.25 in
// float32 and writes the quad's pixels that exist. Consecutive threads
// hold consecutive channel vectors, so a warp's 16-byte accesses cover
// 512 contiguous bytes when C has 32 vectors or more.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    avg_pool2_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int h, int w, int c,
                         int quad_rows, int chunks) {
  const int chunk = blockIdx.x % chunks, r = blockIdx.x / chunks;
  const int b = r / quad_rows, i = r - b * quad_rows;
  const int cv = c / V, t = chunk * blockDim.x + threadIdx.x;
  if (t >= ((w + 1) / 2) * cv) return;
  const int j = t / cv, ch = (t - j * cv) * V;
  const int ho = h / 2, wo = w / 2;
  float q[V];
  if (i < ho && j < wo) {
    load_f32<T, V>(g + (((int64_t)b * ho + i) * wo + j) * c + ch, q);
#pragma unroll
    for (int k = 0; k < V; ++k) q[k] = __fmul_rn(q[k], 0.25f);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) q[k] = 0.0f;
  }
  const int64_t row = (int64_t)w * c;
  T* o = dx + ((int64_t)b * h + 2 * i) * row + (int64_t)(2 * j) * c + ch;
  const bool right = 2 * j + 1 < w, down = 2 * i + 1 < h;
  store_f32<T, V>(o, q);
  if (right) store_f32<T, V>(o + c, q);
  if (down) store_f32<T, V>(o + row, q);
  if (down && right) store_f32<T, V>(o + row + c, q);
}

// (0.25*a + 0.75*b) + (0.75*c + 0.25*d): the adjoint's four taps, rounded
// as the plain version rounds them.
__device__ __forceinline__ float adjoint_taps(float a, float b, float c, float d) {
  return __fadd_rn(quarter_lerp(a, b), quarter_lerp(d, c));
}

// The row (H) pass of K3T at one staged column: the four staged rows from
// `p` on, `rs` elements apart.
template <typename T, int V>
__device__ __forceinline__ void row_pass(const T* p, int rs, float (&out)[V]) {
  float a[V], b[V], c[V], d[V];
  load_f32<T, V>(p, a);
  load_f32<T, V>(p + rs, b);
  load_f32<T, V>(p + 2 * rs, c);
  load_f32<T, V>(p + 3 * rs, d);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = adjoint_taps(a[k], b[k], c[k], d[k]);
}

// K3T on one tile: image b, dx rows [i0, i0 + rows), columns
// [j0, j0 + tile_w), channel vectors [slab * cvt, (slab + 1) * cvt). The
// block stages the clamped g window of its slab — rows 2*i0 - 1 ..
// 2*(i0 + rows), columns 2*j0 - 1 .. 2*(j0 + tile_w), a
// (2*rows + 2) x (2*tile_w + 2) tile — in shared memory (clamping the
// index is the edge rule). Thread (v, slot) owns channel vector v; its
// slots take dx rows r < rows. For each it walks the tile's columns once:
// dx column j0 + jj reads staged columns 2*jj .. 2*jj + 3, so the row pass
// of the two new ones, kept with the two before them in registers, gives
// the column pass of one dx vector, and each row-pass value is computed
// once. Consecutive threads hold consecutive channel vectors, so a warp's
// stores cover 32 x 16 contiguous bytes.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    bilinear_up2_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int h, int w, int c,
                            int rows, int tile_w, int cvt, int tiles_h, int tiles_w, int slabs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  int t = blockIdx.x;  // the one division chain, per block
  const int slab = t % slabs;
  t /= slabs;
  const int tj = t % tiles_w;
  t /= tiles_w;
  const int ti = t % tiles_h;
  const int b = t / tiles_h;
  const int i0 = ti * rows, j0 = tj * tile_w;
  const int v = threadIdx.x % cvt, slot = threadIdx.x / cvt, slots = blockDim.x / cvt;
  const int ch = (slab * cvt + v) * V;
  const bool live = ch < c;  // the last slab may be short
  const int gh = 2 * h, gw = 2 * w;
  const int sw = 2 * tile_w + 2, staged = (2 * rows + 2) * sw;
  const int64_t gimg = (int64_t)b * gh * gw;  // first pixel of g's image b
  if (live) {
    for (int p = slot; p < staged; p += slots) {
      const int rr = p / sw, cc = p - rr * sw;
      const int si = min(max(2 * i0 - 1 + rr, 0), gh - 1);
      const int sj = min(max(2 * j0 - 1 + cc, 0), gw - 1);
      stage<T, V>(tile + (p * cvt + v) * V, g + (gimg + (int64_t)si * gw + sj) * c + ch);
    }
  }
  if constexpr (V * sizeof(T) == 16) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!live) return;
  const int cols = min(tile_w, w - j0);
  const int col = cvt * V;  // elements per staged pixel
  const int rs = sw * col;  // elements per staged row
  for (int r = slot; r < rows; r += slots) {
    const int i = i0 + r;
    if (i >= h) break;
    // Staged row 2r is g row 2i - 1, the first of dx row i's four taps.
    const T* top = tile + 2 * r * rs + v * V;
    float c0[V], c1[V];
    row_pass<T, V>(top, rs, c0);
    row_pass<T, V>(top + col, rs, c1);
    T* o = dx + (((int64_t)b * h + i) * w + j0) * c + ch;
    for (int jj = 0; jj < cols; ++jj) {
      float c2[V], c3[V], out[V];
      row_pass<T, V>(top + (2 * jj + 2) * col, rs, c2);
      row_pass<T, V>(top + (2 * jj + 3) * col, rs, c3);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        out[k] = adjoint_taps(c0[k], c1[k], c2[k], c3[k]);
        c0[k] = c2[k];
        c1[k] = c3[k];
      }
      store_f32<T, V>(o, out);
      o += c;
    }
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

// K2T from g into dx (n, h, w, c).
template <typename T, int V>
int pool_bwd_launch(const T* g, T* dx, int64_t n, int64_t h, int64_t w, int64_t c,
                    cudaStream_t s) {
  const int64_t quad_rows = (h + 1) / 2, quad_vectors = (w + 1) / 2 * (c / V);
  const int64_t threads = quad_vectors < THREADS ? (quad_vectors + 31) / 32 * 32 : THREADS;
  const int64_t chunks = (quad_vectors + threads - 1) / threads;
  const int64_t blocks = n * quad_rows * chunks;
  if (blocks > INT_MAX || quad_vectors > INT_MAX || h > INT_MAX || w > INT_MAX || c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  avg_pool2_bwd_kernel<T, V><<<(unsigned)blocks, (unsigned)threads, 0, s>>>(
      g, dx, (int)h, (int)w, (int)c, (int)quad_rows, (int)chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int pool_bwd(const void* g, void* dx, int64_t n, int64_t h, int64_t w, int64_t c,
             cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* in = static_cast<const T*>(g);
  T* out = static_cast<T*>(dx);
  if (vectorizable<T>(g, dx, c)) return pool_bwd_launch<T, VEC>(in, out, n, h, w, c, s);
  return pool_bwd_launch<T, 1>(in, out, n, h, w, c, s);
}

// Lets `kernel` take up to MAX_SMEM bytes of dynamic shared memory on the
// current device: once per device (a bit of `devices` each), not on every
// launch.
template <typename Kernel>
cudaError_t allow_big_tiles(Kernel kernel, std::atomic<uint64_t>& devices) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (devices.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// K3 (BWD false) or K3T (BWD true) on a tile plan from the caller
// (ops/kernels/stencil.py::up2_plan, up2_bwd_plan): `rows` and `tile_w`
// rows and columns of the smaller image (K3's input x, K3T's output dx,
// (n, h, w, c)) per tile, `cvt` vectors of V channels per slab, `threads`
// a multiple of cvt up to 256. K3 stages (rows + 2) x (tile_w + 2) pixels
// of x per block, K3T (2 rows + 2) x (2 tile_w + 2) pixels of g.
template <typename T, int V, bool BWD>
int tile_launch(const T* in, T* out, int64_t n, int64_t h, int64_t w, int64_t c, int rows,
                int tile_w, int cvt, int threads, cudaStream_t s) {
  const int64_t tiles_h = (h + rows - 1) / rows, tiles_w = (w + tile_w - 1) / tile_w;
  const int64_t slabs = ((c + V - 1) / V + cvt - 1) / cvt;
  const int64_t blocks = n * tiles_h * tiles_w * slabs;
  const int64_t staged = BWD ? (2 * (int64_t)rows + 2) * (2 * (int64_t)tile_w + 2)
                             : ((int64_t)rows + 2) * (tile_w + 2);
  const int64_t smem = staged * cvt * V * (int64_t)sizeof(T);
  if (blocks > INT_MAX || smem > MAX_SMEM || 2 * h > INT_MAX || 2 * w > INT_MAX || c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto kernel = BWD ? bilinear_up2_bwd_kernel<T, V> : bilinear_up2_kernel<T, V>;
  static std::atomic<uint64_t> big_tiles{0};  // devices that let this kernel pass 48 KB
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_big_tiles(kernel, big_tiles);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, (size_t)smem, s>>>(in, out, (int)h, (int)w, (int)c, rows,
                                                         tile_w, cvt, (int)tiles_h, (int)tiles_w,
                                                         (int)slabs);
  return (int)cudaGetLastError();
}

template <typename T, bool BWD>
int tiled(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c, int vec, int rows,
          int tile_w, int cvt, int threads, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (rows < 1 || tile_w < 1 || cvt < 1 || threads < cvt || threads > 256 || threads % cvt)
    return (int)cudaErrorInvalidValue;
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  if (vec == VEC && vectorizable<T>(x, y, c))
    return tile_launch<T, VEC, BWD>(in, out, n, h, w, c, rows, tile_w, cvt, threads, s);
  if (vec == 1)
    return tile_launch<T, 1, BWD>(in, out, n, h, w, c, rows, tile_w, cvt, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (n, h, w, c) NHWC-contiguous, dtype 0 = float32, 1 = bfloat16, on
// `device`; y: (n, h/2, w/2, c) of the same dtype. Launches on `stream` and
// does not synchronise. Returns a cudaError_t (0 = launched, or no work).
int lm_avg_pool2(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c, int dtype,
                 int device, void* stream) {
  if (n * (h / 2) * (w / 2) * c <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pool<float>(x, y, n, h, w, c, s);
  if (dtype == 1) return pool<__nv_bfloat16>(x, y, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// x: (n, h, w, c) as above; y: (n, 2h, 2w, c); the tile plan
// (ops/kernels/stencil.py::up2_plan) as tiled takes it.
int lm_bilinear_up2(const void* x, void* y, int64_t n, int64_t h, int64_t w, int64_t c,
                    int dtype, int vec, int rows, int tile_w, int cvt, int threads,
                    int device, void* stream) {
  if (n * h * w * c <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tiled<float, false>(x, y, n, h, w, c, vec, rows, tile_w, cvt, threads, s);
  if (dtype == 1)
    return tiled<__nv_bfloat16, false>(x, y, n, h, w, c, vec, rows, tile_w, cvt, threads, s);
  return (int)cudaErrorInvalidValue;
}

// g: (n, h/2, w/2, c) NHWC-contiguous, the gradient of lm_avg_pool2's
// output; dx: (n, h, w, c), the gradient of its input; dtype and stream as
// above.
int lm_avg_pool2_bwd(const void* g, void* dx, int64_t n, int64_t h, int64_t w, int64_t c,
                     int dtype, int device, void* stream) {
  if (n * h * w * c <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pool_bwd<float>(g, dx, n, h, w, c, s);
  if (dtype == 1) return pool_bwd<__nv_bfloat16>(g, dx, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// g: (n, 2h, 2w, c), the gradient of lm_bilinear_up2's output; dx:
// (n, h, w, c), the gradient of its input; the tile plan
// (ops/kernels/stencil.py::up2_bwd_plan) as tiled takes it.
int lm_bilinear_up2_bwd(const void* g, void* dx, int64_t n, int64_t h, int64_t w, int64_t c,
                        int dtype, int vec, int rows, int tile_w, int cvt, int threads,
                        int device, void* stream) {
  if (n * h * w * c <= 0) return 0;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tiled<float, true>(g, dx, n, h, w, c, vec, rows, tile_w, cvt, threads, s);
  if (dtype == 1)
    return tiled<__nv_bfloat16, true>(g, dx, n, h, w, c, vec, rows, tile_w, cvt, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
