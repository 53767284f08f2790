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
// kernel and to the plain torch chain in ops/kernels/bodymask.py. Both are
// fixpoints defined by the input alone, so any exact algorithm gives them.
//
// What bounds it on this card: not bytes (64 KB of HU in, 80 KB out per
// slice: 28.3 MB at B=192, 8.5 us at 3.35 TB/s) but the chain of dependent
// steps per slice. The first design (one 1024-thread block per slice, one
// byte per pixel, 16 pixels per thread) moved both fixpoints one pixel per
// round, each round a full-plane pass and a block-wide barrier, so the
// rounds grew with the longest flood path or component.
//
// This design: one 128-thread block per slice, thread y owning row y as a
// 128-bit row (two 64-bit words, bit x = pixel x). The whole batch of 192
// slices is resident at once (56 KB of shared memory per block, up to four
// blocks per SM), so the kernel takes about one slice's chain.
//   * Threshold: each warp loads its 32 rows 128 bytes at a time and turns
//     them into bits with __ballot_sync.
//   * Closing and erosions: word shifts with carries across the two words,
//     ANDs and ORs; rows above and below come through shared memory.
//   * Flood: a free run is filled in one step by carry propagation,
//     (f & ((f + s) ^ f)) | s fills each run of f upward from its seeds s,
//     and the same on the bit-reversed row fills it downward. Each warp then
//     fills straight vertical free runs through its 32 rows by doubling
//     (__shfl_up/down by 1, 2, 4, 8, 16) and takes one 8-neighbour step to
//     the rows above and below; it repeats this without a block barrier
//     until its rows are stable, then publishes its rows and the block
//     checks for change (__syncthreads_or). So the barriers count the
//     flood's crossings between warps, not its pixels.
//   * Labels: union-find over horizontal runs. Runs get ids in raster order
//     (row counts, block scan), each overlap of a run with the row above is
//     one union (atomicMin on the parent, parents always smaller ids), so
//     each root is its component's raster-first run, whose start pixel is
//     the component's smallest linear index. One compression pass, then
//     each pixel's label = start of its run's root + 1, written 512 bytes
//     per warp store.
//
// C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 128;
constexpr int THREADS = N;  // one thread per row
constexpr int WARPS = THREADS / 32;
// After the erosions rows 0 and 127 and columns 0 and 127 are empty, so a
// slice holds at most 126 rows x 63 runs = 7938 runs.
constexpr int MAX_RUNS = 8192;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BODY_THRESHOLD = -500.0f;

typedef unsigned long long u64;

struct Row {
  u64 lo, hi;  // pixels 0..63, 64..127
};

__device__ __forceinline__ Row operator|(Row a, Row b) { return {a.lo | b.lo, a.hi | b.hi}; }
__device__ __forceinline__ Row operator&(Row a, Row b) { return {a.lo & b.lo, a.hi & b.hi}; }
__device__ __forceinline__ Row operator~(Row a) { return {~a.lo, ~a.hi}; }
__device__ __forceinline__ bool operator!=(Row a, Row b) { return a.lo != b.lo || a.hi != b.hi; }

// Pixel x takes the value of pixel x - 1 (x + 1); 0 from outside the plane.
__device__ __forceinline__ Row from_left(Row a) { return {a.lo << 1, (a.hi << 1) | (a.lo >> 63)}; }
__device__ __forceinline__ Row from_right(Row a) { return {(a.lo >> 1) | (a.hi << 63), a.hi >> 1}; }
__device__ __forceinline__ Row reversed(Row a) { return {__brevll(a.hi), __brevll(a.lo)}; }

// Every pixel of a run of f at or above (in x) a seed of s, s within f:
// the carry of f + s runs from each run's first seed to the run's end.
__device__ __forceinline__ Row fill_up(Row s, Row f) {
  const u64 lo = f.lo + s.lo;
  const u64 hi = f.hi + s.hi + (lo < f.lo ? 1ull : 0ull);
  return (f & Row{lo ^ f.lo, hi ^ f.hi}) | s;
}

// The whole runs of f that hold a seed of s.
__device__ __forceinline__ Row fill_runs(Row s, Row f) {
  return fill_up(s, f) | reversed(fill_up(reversed(s), reversed(f)));
}

__device__ __forceinline__ Row shfl_up(Row a, int d) {
  return {__shfl_up_sync(FULL, a.lo, d), __shfl_up_sync(FULL, a.hi, d)};
}
__device__ __forceinline__ Row shfl_down(Row a, int d) {
  return {__shfl_down_sync(FULL, a.lo, d), __shfl_down_sync(FULL, a.hi, d)};
}

// Straight vertical runs of f inside this warp's 32 rows that hold a pixel
// of g (g within f): Kogge-Stone doubling downward, then upward.
__device__ __forceinline__ Row fill_columns(Row g, Row f, int lane) {
  Row p = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Row gs = shfl_up(g, d), ps = shfl_up(p, d);
    if (lane >= d) {
      g = g | (p & gs);
      p = p & ps;
    }
  }
  p = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Row gs = shfl_down(g, d), ps = shfl_down(p, d);
    if (lane + d < 32) {
      g = g | (p & gs);
      p = p & ps;
    }
  }
  return g;
}

__device__ __forceinline__ Row load_row(const volatile Row* p) {
  const volatile u64* w = reinterpret_cast<const volatile u64*>(p);
  return {w[0], w[1]};
}
__device__ __forceinline__ void store_row(volatile Row* p, Row a) {
  volatile u64* w = reinterpret_cast<volatile u64*>(p);
  w[0] = a.lo;
  w[1] = a.hi;
}

// Number of set bits of a at pixels <= x.
__device__ __forceinline__ int count_to(Row a, int x) {
  if (x < 64) return __popcll(a.lo & ((2ull << x) - 1ull));
  return __popcll(a.lo) + __popcll(a.hi & ((2ull << (x - 64)) - 1ull));
}

__device__ __forceinline__ unsigned word32(Row a, int q) {
  const u64 w = q < 2 ? a.lo : a.hi;
  return (unsigned)(q & 1 ? w >> 32 : w);
}

struct Smem {
  Row plane[2][N];  // rows exchanged between neighbours (alternating)
  Row reach[N];     // the flood's published rows
  Row mask[N];      // the eroded mask
  Row starts[N];    // its run starts
  int base[N];      // id of each row's first run
  int warp_runs[WARPS];
  int parent[MAX_RUNS];
  uint16_t runpos[MAX_RUNS];  // linear index of each run's first pixel
};

__device__ __forceinline__ int find(const volatile int* parent, int a) {
  int p;
  while ((p = parent[a]) != a) a = p;
  return a;
}

// Join the trees of runs a and b; a parent is always a smaller id.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find(parent, a);
    b = find(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[a], b);
    if (old == a) return;
    a = old;  // a had gained another parent: join that one to b
  }
}

// Publish row r of this thread and read its neighbours (0 outside).
__device__ __forceinline__ void neighbours(Smem& s, int& buf, int y, Row r, Row& up, Row& dn) {
  Row* pl = s.plane[buf];
  buf ^= 1;
  pl[y] = r;
  __syncthreads();
  up = y > 0 ? pl[y - 1] : Row{0, 0};
  dn = y < N - 1 ? pl[y + 1] : Row{0, 0};
}

__global__ void __launch_bounds__(THREADS)
    bodymask_kernel(const float* __restrict__ hu, int32_t* __restrict__ labels_out,
                    uint8_t* __restrict__ mask_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int y = threadIdx.x, lane = y & 31, warp = y >> 5;
  const int64_t base = (int64_t)blockIdx.x * N * N;
  const float* src = hu + base;

  // 1. threshold: warp w holds rows 32w..32w+31, lane k keeps row 32w+k.
  Row m = {0, 0};
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const float* p = src + (warp * 32 + k) * N + lane;
    const float v0 = p[0], v1 = p[32], v2 = p[64], v3 = p[96];
    const unsigned w0 = __ballot_sync(FULL, v0 > BODY_THRESHOLD);
    const unsigned w1 = __ballot_sync(FULL, v1 > BODY_THRESHOLD);
    const unsigned w2 = __ballot_sync(FULL, v2 > BODY_THRESHOLD);
    const unsigned w3 = __ballot_sync(FULL, v3 > BODY_THRESHOLD);
    if (lane == k) m = {w0 | ((u64)w1 << 32), w2 | ((u64)w3 << 32)};
  }

  // 2. closing (cross)
  int buf = 0;
  Row up, dn;
  neighbours(s, buf, y, m, up, dn);
  m = m | from_left(m) | from_right(m) | up | dn;
  neighbours(s, buf, y, m, up, dn);
  m = m & from_left(m) & from_right(m) & up & dn;

  // 3. hole fill: r = the complement reached from the border
  const Row f = ~m;
  const Row edge = {1ull, 1ull << 63};
  Row r = (y == 0 || y == N - 1) ? f : f & edge;
  store_row(&s.reach[y], r);
  __syncthreads();
  while (true) {
    const Row start = r;
    // Rows of the neighbouring warps, as last published (a stale row is a
    // subset of the fixpoint, so it only delays the flood).
    const Row ext_up = (lane == 0 && y > 0) ? load_row(&s.reach[y - 1]) : Row{0, 0};
    const Row ext_dn = (lane == 31 && y < N - 1) ? load_row(&s.reach[y + 1]) : Row{0, 0};
    while (true) {
      Row u = shfl_up(r, 1), d = shfl_down(r, 1);
      if (lane == 0) u = ext_up;
      if (lane == 31) d = ext_dn;
      Row v = u | d;
      v = v | from_left(v) | from_right(v);  // the 8 neighbours above and below
      Row n = fill_runs((r | v) & f, f);
      n = fill_runs(fill_columns(n, f, lane), f);
      const bool changed = n != r;
      r = n;
      if (!__any_sync(FULL, changed)) break;
    }
    store_row(&s.reach[y], r);
    if (!__syncthreads_or(r != start)) break;
  }
  m = m | ~r;  // body, or complement the flood never reached

  // 4. erosion x2 (cross)
  neighbours(s, buf, y, m, up, dn);
  m = m & from_left(m) & from_right(m) & up & dn;
  neighbours(s, buf, y, m, up, dn);
  m = m & from_left(m) & from_right(m) & up & dn;

  // 5. runs: ids in raster order by a block scan of the row counts
  const Row st = m & ~from_left(m);
  s.mask[y] = m;
  s.starts[y] = st;
  const int cnt = __popcll(st.lo) + __popcll(st.hi);
  int inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) s.warp_runs[warp] = inc;
  __syncthreads();
  int first = inc - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) first += s.warp_runs[w];
    total += s.warp_runs[w];
  }
  s.base[y] = first;
  {
    int id = first;
    for (int half = 0; half < 2; ++half) {
      u64 bits = half ? st.hi : st.lo;
      while (bits) {
        const int x = half * 64 + __ffsll((long long)bits) - 1;
        bits &= bits - 1;
        s.parent[id] = id;
        s.runpos[id] = (uint16_t)(y * N + x);
        ++id;
      }
    }
  }
  __syncthreads();

  // 6. one union per overlap of a run with a run of the row above
  if (y > 0) {
    const Row pm = s.mask[y - 1], ps = s.starts[y - 1];
    const int pb = s.base[y - 1];
    const Row o = m & pm;
    const Row os = o & ~from_left(o);
    for (int half = 0; half < 2; ++half) {
      u64 bits = half ? os.hi : os.lo;
      while (bits) {
        const int x = half * 64 + __ffsll((long long)bits) - 1;
        bits &= bits - 1;
        unite(s.parent, first + count_to(st, x) - 1, pb + count_to(ps, x) - 1);
      }
    }
  }
  __syncthreads();
  for (int i = y; i < total; i += THREADS) {
    const int root = find(s.parent, i);
    reinterpret_cast<volatile int*>(s.parent)[i] = root;
  }
  __syncthreads();

  // 7. outputs: warp w writes its 32 rows, lane l pixels 4l..4l+3
  const int q = lane >> 3, shift = (lane & 7) * 4;
  for (int k = 0; k < 32; ++k) {
    const int row = warp * 32 + k;
    const Row mr = s.mask[row];
    const unsigned bits = (word32(mr, q) >> shift) & 0xfu;
    const int64_t at = base + row * N + 4 * lane;
    unsigned bytes = 0;
    int lab[4] = {0, 0, 0, 0};
    if (bits) {
      const Row sr = s.starts[row];
      const int rb = s.base[row];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (bits >> b & 1u) {
          bytes |= 1u << (8 * b);
          lab[b] = (int)s.runpos[s.parent[rb + count_to(sr, 4 * lane + b) - 1]] + 1;
        }
      }
    }
    *reinterpret_cast<unsigned*>(mask_out + at) = bytes;
    *reinterpret_cast<int4*>(labels_out + at) = make_int4(lab[0], lab[1], lab[2], lab[3]);
  }
}

}  // namespace

extern "C" {

// hu: (batch, 128, 128) float32; labels: int32 and mask: uint8 of the same
// shape, all contiguous on `device` (torch's allocations are 16-byte
// aligned, as the vector stores need). Launches on `stream` and does not
// synchronise. Returns a cudaError_t (0 = launched).
int lm_bodymask_labels(const void* hu, void* labels, void* mask, int64_t batch,
                       int device, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(labels) | reinterpret_cast<uintptr_t>(mask)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bodymask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  bodymask_kernel<<<(unsigned)batch, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      static_cast<const float*>(hu), static_cast<int32_t*>(labels),
      static_cast<uint8_t*>(mask));
  return (int)cudaGetLastError();
}

}  // extern "C"
