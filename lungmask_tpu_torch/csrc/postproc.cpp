// Native host core of the PyTorch port: connected-component labeling, region
// properties, hole filling and the exact volume postprocessing, run in
// z-slabs across the host's CPUs.
//
// Replaces the skimage.measure.label / regionprops C internals the reference
// leans on (lungmask/utils.py:293-298) with a run-length union-find tuned for
// multi-class label volumes:
//
//  * same-value connectivity (two voxels join a component iff neighbors AND
//    equal value; 0 = background) — skimage semantics,
//  * connectivity 1 (6/4-neighborhood) or full (26/8),
//  * output labels renumbered 1..n in raster-scan first-occurrence order
//    (skimage's ordering, which downstream tie-breaking depends on),
//  * fused region properties (area, value, bounding box) in the same pass.
//
// Every pass over voxels splits the volume into contiguous z-slabs, one task
// a slab, on a process-wide pool of worker threads and the calling thread.
// The results are byte for byte those of a single-threaded pass (the JAX
// package's copy of this core, csrc/postproc.cpp at the repository root, is
// that pass and the oracle of the port's tests): labeling stitches the slabs
// in one serial step and numbers components in raster order; the merge loop,
// whose decisions depend on their order, stays serial.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {
// LM_POSTPROC_TIMING=1 → per-stage wall times of lm_postprocess to stderr.
inline bool pp_timing() {
  static int v = -1;
  if (v < 0) {
    const char* e = getenv("LM_POSTPROC_TIMING");
    v = (e && *e == '1') ? 1 : 0;
  }
  return v == 1;
}
inline double pp_now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- worker pool ----
//
// Threads persist across calls (thread start is slow on some hosts). A call
// hands its tasks to the pool and runs them itself too, so it finishes its
// own tasks even when every pool thread is busy with another call's: two
// concurrent calls (the fused pair's two finish threads, a cohort's finisher
// beside its loader) share the threads and cannot deadlock.
class Pool {
 public:
  // fn(0) … fn(n-1), each once, on the calling thread and up to n-1 pool
  // threads; returns when all have run.
  void run(int n, const std::function<void(int)>& fn) {
    grow(n - 1);
    Job job(&fn, n);
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push_back(&job);
    }
    cv_.notify_all();
    for (int i; (i = job.next.fetch_add(1)) < n;) {
      fn(i);
      std::lock_guard<std::mutex> lk(mu_);
      ++job.done;
    }
    std::unique_lock<std::mutex> lk(mu_);
    auto it = std::find(jobs_.begin(), jobs_.end(), &job);
    if (it != jobs_.end()) jobs_.erase(it);
    job.cv.wait(lk, [&] { return job.done == n; });
  }

 private:
  struct Job {
    Job(const std::function<void(int)>* f, int count) : fn(f), n(count) {}
    const std::function<void(int)>* fn;
    const int n;
    std::atomic<int> next{0};
    int done = 0;  // guarded by mu_
    std::condition_variable cv;
  };

  void grow(int want) {
    std::lock_guard<std::mutex> lk(mu_);
    for (; threads_ < want; ++threads_) std::thread(&Pool::loop, this).detach();
  }

  void loop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return !jobs_.empty(); });
      Job* j = jobs_.front();
      const int i = j->next.fetch_add(1);
      if (i >= j->n) {  // every task taken: the job leaves the queue
        jobs_.pop_front();
        continue;
      }
      lk.unlock();
      (*j->fn)(i);
      lk.lock();
      if (++j->done == j->n) j->cv.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Job*> jobs_;
  int threads_ = 0;
};

// One pool a process. A forked child starts a fresh one: the parent's
// threads do not exist there (the old pool is left, never freed).
Pool* g_pool = nullptr;
void fresh_pool() { g_pool = new Pool(); }
Pool& pool() {
  static const bool made = [] {
    fresh_pool();
    pthread_atfork(nullptr, nullptr, fresh_pool);
    return true;
  }();
  (void)made;
  return *g_pool;
}

template <typename F>
void parallel_for(int n, F&& f) {
  if (n <= 1) {
    if (n == 1) f(0);
    return;
  }
  const std::function<void(int)> fn = f;
  pool().run(n, fn);
}

// Slabs for a pass over `voxels` voxels of `nz` planes: one a worker, each of
// at least `slab_voxels` voxels and one plane; 1 runs the pass inline.
int slab_count(int64_t nz, int64_t voxels, int32_t workers, int64_t slab_voxels) {
  int64_t n = slab_voxels > 0 ? voxels / slab_voxels : 1;
  n = std::min<int64_t>(n, std::min<int64_t>(workers, nz));
  return static_cast<int>(std::max<int64_t>(n, 1));
}

inline int64_t cut(int64_t nz, int s, int n) { return nz * s / n; }

// f(s, i0, i1) for each of `nslabs` z-slabs of a volume of `nz` planes of
// `sz` voxels, [i0, i1) being slab s's voxels; one task a slab.
template <typename F>
void over_slabs(int64_t nz, int64_t sz, int nslabs, F&& f) {
  parallel_for(nslabs, [&](int s) {
    f(s, cut(nz, s, nslabs) * sz, cut(nz, s + 1, nslabs) * sz);
  });
}

// A buffer whose contents survive only as long as the caller needs them:
// grown without initialisation, so that a fresh allocation's pages fault in
// on the threads that first write them, slab by slab.
template <typename T>
struct Scratch {
  std::unique_ptr<T[]> p;
  size_t cap = 0;
  T* get(size_t n) {
    if (n > cap) {
      p.reset();
      p.reset(new T[n]);
      cap = n;
    }
    return p.get();
  }
};

struct UnionFind {
  std::vector<int32_t> parent;
  int32_t find(int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];  // path halving
      a = parent[a];
    }
    return a;
  }
  // The smaller root wins, so a set's root is its smallest member.
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

// Multi-class connected components, run-length union-find.
//
// Label volumes are highly run-compressible (a lung field is one run per
// row), so rows compress into maximal same-value runs and all union work
// happens between overlapping runs of adjacent rows — typically 50-100×
// fewer union-find operations than the per-voxel formulation, with the
// remaining O(voxels) work being two passes (run extraction and label fill),
// each split into z-slabs.

struct Run {
  int32_t x0, x1;  // half-open
  int32_t value;
  int32_t comp;  // the slab's union-find id, then its local component
};

// Calls f(i, k) for each run a[i] and run b[k] of equal value that touch:
// intervals [x0-slack, x1+slack) intersect (`slack` 0 for axis connectivity,
// 1 for full connectivity). Two-pointer sweep over two sorted rows.
template <typename F>
inline void touching(const Run* a, int64_t na, const Run* b, int64_t nb,
                     int32_t slack, F&& f) {
  int64_t j = 0;
  for (int64_t i = 0; i < na; ++i) {
    const int32_t lo = a[i].x0 - slack, hi = a[i].x1 + slack;
    while (j < nb && b[j].x1 <= lo) ++j;
    for (int64_t k = j; k < nb && b[k].x0 < hi; ++k)
      if (b[k].value == a[i].value) f(i, k);
  }
}

// Per-component statistics accumulated from runs (the run sweep knows each
// run's value, length and extent, so a separate voxel-level regionprops pass
// over the volume is unnecessary).
struct CompStats {
  std::vector<int64_t> areas;
  std::vector<int32_t> value;  // the component's (single) image value
  std::vector<int32_t> bbox;   // n*6: z0,y0,x0,z1,y1,x1 half-open
};

// The labeled domain: a box of a C-contiguous volume.
struct Box {
  int64_t z0, y0, x0;  // origin in the volume
  int64_t wz, wy, wx;  // extent
  int64_t sy, sz;      // the volume's row and plane strides
  int64_t at(int64_t z, int64_t y) const {
    return (z0 + z) * sz + (y0 + y) * sy + x0;
  }
  bool on_border(const int32_t* b) const {
    return b[0] == 0 || b[1] == 0 || b[2] == 0 || b[3] == wz || b[4] == wy ||
           b[5] == wx;
  }
};

struct Slab {
  int64_t z0, z1;  // planes of the box
  std::vector<Run> runs;
  std::vector<int64_t> row_start;  // (z1-z0)*wy + 1
  UnionFind uf;                    // over the slab's runs
  int32_t n_local = 0;             // components seen inside the slab
  std::vector<int64_t> area;       // per local component
  std::vector<int32_t> value;
  std::vector<int32_t> bbox;
  std::vector<int32_t> label;  // local component → global label
  bool overflow = false;
};

class Labeling {
 public:
  // Labels the nonzero values of val(i) (i: index into the volume) over
  // `box`, in `nslabs` slabs. Returns the number of components n, or -1 on
  // overflow; `stats`, when given, receives each label's area, value and box.
  template <typename V>
  int32_t build(const V& val, const Box& box, bool full, int nslabs,
                CompStats* stats);
  // int32 labels of the whole box (0 background), slab by slab.
  void write(int32_t* out, const Box& box) const;
  // The first slabs_used slabs hold the runs of the last build.
  std::vector<Slab> slabs;
  int slabs_used = 0;
};

template <typename V>
void extract_slab(Slab& sl, const V& val, const Box& b, bool full) {
  const int32_t slack = full ? 1 : 0;
  const int64_t wy = b.wy, wx = b.wx;
  std::vector<Run>& runs = sl.runs;
  std::vector<int64_t>& row_start = sl.row_start;
  std::vector<int32_t>& parent = sl.uf.parent;
  runs.clear();
  parent.clear();
  sl.overflow = false;
  const int64_t rows = (sl.z1 - sl.z0) * wy;
  row_start.resize(rows + 1);
  for (int64_t z = sl.z0; z < sl.z1; ++z) {
    for (int64_t y = 0; y < wy; ++y) {
      const int64_t r = (z - sl.z0) * wy + y;
      const int64_t base = b.at(z, y);
      row_start[r] = static_cast<int64_t>(runs.size());
      for (int64_t x = 0; x < wx;) {
        const int32_t v = static_cast<int32_t>(val(base + x));
        if (v == 0) { ++x; continue; }
        int64_t e = x + 1;
        while (e < wx && static_cast<int32_t>(val(base + e)) == v) ++e;
        // Ids are int32; a billion-voxel worst-case (alternating) volume
        // could overflow them. Fail cleanly (callers fall back to the
        // Python/scipy path) instead of wrapping into UB.
        if (runs.size() >= static_cast<size_t>(INT32_MAX) - 1) {
          sl.overflow = true;
          return;
        }
        const int32_t id = static_cast<int32_t>(runs.size());
        runs.push_back({static_cast<int32_t>(x), static_cast<int32_t>(e), v, id});
        parent.push_back(id);
        x = e;
      }
      const int64_t a0 = row_start[r];
      const int64_t a1 = static_cast<int64_t>(runs.size());
      if (a1 == a0) continue;
      auto unite_with = [&](int64_t b0, int64_t b1) {
        touching(runs.data() + a0, a1 - a0, runs.data() + b0, b1 - b0, slack,
                 [&](int64_t i, int64_t k) {
                   sl.uf.unite(static_cast<int32_t>(a0 + i),
                               static_cast<int32_t>(b0 + k));
                 });
      };
      if (y > 0) unite_with(row_start[r - 1], a0);
      if (z > sl.z0) {
        const int64_t ylo = full ? (y > 0 ? y - 1 : 0) : y;
        const int64_t yhi = full ? (y + 1 < wy ? y + 1 : wy - 1) : y;
        for (int64_t yy = ylo; yy <= yhi; ++yy) {
          const int64_t q = r - wy - y + yy;
          unite_with(row_start[q], row_start[q + 1]);
        }
      }
    }
  }
  row_start[rows] = static_cast<int64_t>(runs.size());

  // Local components in first-occurrence order: a set's root is its first
  // run, so a run that is its own root opens a component.
  sl.n_local = 0;
  sl.area.clear();
  sl.value.clear();
  sl.bbox.clear();
  int64_t ri = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t z = static_cast<int32_t>(sl.z0 + r / wy);
    const int32_t y = static_cast<int32_t>(r % wy);
    for (; ri < row_start[r + 1]; ++ri) {
      Run& run = runs[ri];
      const int32_t root = sl.uf.find(static_cast<int32_t>(ri));
      if (root == ri) {
        run.comp = sl.n_local++;
        sl.area.push_back(0);
        sl.value.push_back(run.value);
        sl.bbox.insert(sl.bbox.end(),
                       {z, y, run.x0, z + 1, y + 1, run.x1});
      } else {
        run.comp = runs[root].comp;
      }
      const int32_t k = run.comp;
      sl.area[k] += run.x1 - run.x0;
      int32_t* bb = sl.bbox.data() + static_cast<size_t>(k) * 6;
      if (y < bb[1]) bb[1] = y;
      if (run.x0 < bb[2]) bb[2] = run.x0;
      if (z + 1 > bb[3]) bb[3] = z + 1;
      if (y + 1 > bb[4]) bb[4] = y + 1;
      if (run.x1 > bb[5]) bb[5] = run.x1;
    }
  }
}

template <typename V>
int32_t Labeling::build(const V& val, const Box& box, bool full, int nslabs,
                        CompStats* stats) {
  if (static_cast<int>(slabs.size()) < nslabs) slabs.resize(nslabs);
  slabs_used = nslabs;
  for (int s = 0; s < nslabs; ++s) {
    slabs[s].z0 = cut(box.wz, s, nslabs);
    slabs[s].z1 = cut(box.wz, s + 1, nslabs);
  }
  parallel_for(nslabs, [&](int s) { extract_slab(slabs[s], val, box, full); });

  std::vector<int64_t> off(nslabs + 1, 0);
  for (int s = 0; s < nslabs; ++s) {
    if (slabs[s].overflow) return -1;
    off[s + 1] = off[s] + slabs[s].n_local;
  }
  if (off[nslabs] >= INT32_MAX) return -1;

  // Stitch: each slab's first plane against the last plane of the slab
  // before it, over the slabs' local components.
  UnionFind g;
  g.parent.resize(off[nslabs]);
  for (int64_t i = 0; i < off[nslabs]; ++i) g.parent[i] = static_cast<int32_t>(i);
  const int32_t slack = full ? 1 : 0;
  const int64_t wy = box.wy;
  for (int s = 1; s < nslabs; ++s) {
    const Slab& a = slabs[s];
    const Slab& p = slabs[s - 1];
    const int64_t last = (p.z1 - p.z0 - 1) * wy;
    for (int64_t y = 0; y < wy; ++y) {
      const int64_t a0 = a.row_start[y], a1 = a.row_start[y + 1];
      if (a0 == a1) continue;
      const int64_t ylo = full ? (y > 0 ? y - 1 : 0) : y;
      const int64_t yhi = full ? (y + 1 < wy ? y + 1 : wy - 1) : y;
      for (int64_t yy = ylo; yy <= yhi; ++yy) {
        const int64_t b0 = p.row_start[last + yy], b1 = p.row_start[last + yy + 1];
        touching(a.runs.data() + a0, a1 - a0, p.runs.data() + b0, b1 - b0, slack,
                 [&](int64_t i, int64_t k) {
                   g.unite(static_cast<int32_t>(off[s] + a.runs[a0 + i].comp),
                           static_cast<int32_t>(off[s - 1] + p.runs[b0 + k].comp));
                 });
      }
    }
  }

  // Global labels in raster first-occurrence order: slabs in z order, each
  // slab's components in its own first-occurrence order.
  std::vector<int32_t> glab(off[nslabs], 0);
  int32_t next = 0;
  for (int s = 0; s < nslabs; ++s) {
    Slab& sl = slabs[s];
    sl.label.resize(sl.n_local);
    for (int32_t lc = 0; lc < sl.n_local; ++lc) {
      const int32_t root = g.find(static_cast<int32_t>(off[s] + lc));
      if (glab[root] == 0) glab[root] = ++next;
      sl.label[lc] = glab[root];
    }
  }
  if (stats) {
    stats->areas.assign(next, 0);
    stats->value.assign(next, 0);
    stats->bbox.assign(static_cast<size_t>(next) * 6, 0);
    for (int32_t l = 0; l < next; ++l) {
      int32_t* b = stats->bbox.data() + static_cast<size_t>(l) * 6;
      b[0] = static_cast<int32_t>(box.wz);
      b[1] = static_cast<int32_t>(box.wy);
      b[2] = static_cast<int32_t>(box.wx);
    }
    for (int s = 0; s < nslabs; ++s) {
      const Slab& sl = slabs[s];
      for (int32_t lc = 0; lc < sl.n_local; ++lc) {
        const int32_t k = sl.label[lc] - 1;
        stats->areas[k] += sl.area[lc];
        stats->value[k] = sl.value[lc];
        int32_t* b = stats->bbox.data() + static_cast<size_t>(k) * 6;
        const int32_t* lb = sl.bbox.data() + static_cast<size_t>(lc) * 6;
        for (int d = 0; d < 3; ++d) {
          if (lb[d] < b[d]) b[d] = lb[d];
          if (lb[d + 3] > b[d + 3]) b[d + 3] = lb[d + 3];
        }
      }
    }
  }
  return next;
}

void Labeling::write(int32_t* out, const Box& box) const {
  parallel_for(slabs_used, [&](int s) {
    const Slab& sl = slabs[s];
    int64_t ri = 0;
    for (int64_t z = sl.z0; z < sl.z1; ++z)
      for (int64_t y = 0; y < box.wy; ++y) {
        int32_t* dst = out + box.at(z, y);
        const int64_t r1 = sl.row_start[(z - sl.z0) * box.wy + y + 1];
        int32_t x = 0;
        for (; ri < r1; ++ri) {
          const Run& r = sl.runs[ri];
          std::fill(dst + x, dst + r.x0, 0);
          std::fill(dst + r.x0, dst + r.x1, sl.label[r.comp]);
          x = r.x1;
        }
        std::fill(dst + x, dst + box.wx, 0);
      }
  });
}

// A calling thread's working buffers for postprocess().
struct Work {
  Scratch<int32_t> comp;
  Labeling lab;
  CompStats st, st2, stw;
  std::vector<int64_t> cnt;
};

Box whole(int64_t nz, int64_t ny, int64_t nx) {
  return {0, 0, 0, nz, ny, nx, nx, ny * nx};
}

}  // namespace

extern "C" {

int32_t lm_label(const int32_t* img, int64_t nz, int64_t ny, int64_t nx,
                 int32_t connectivity, int32_t* out) {
  Labeling lab;
  const Box box = whole(nz, ny, nx);
  const int32_t n = lab.build([img](int64_t i) { return img[i]; }, box,
                              connectivity != 1, 1, nullptr);
  if (n >= 0) lab.write(out, box);
  return n;
}

// Fused region properties over a labeled volume.
//   labels:     int32 from lm_label (1..n_labels)
//   intensity:  int32 original label image (may be NULL)
//   areas:      int64[n_labels]
//   max_int:    int32[n_labels] (untouched when intensity == NULL)
//   bbox:       int32[n_labels*6]  (z0,y0,x0,z1,y1,x1 half-open)
void lm_regionprops(const int32_t* labels, const int32_t* intensity,
                    int64_t nz, int64_t ny, int64_t nx, int32_t n_labels,
                    int64_t* areas, int32_t* max_int, int32_t* bbox) {
  for (int32_t l = 0; l < n_labels; ++l) {
    areas[l] = 0;
    if (intensity) max_int[l] = INT32_MIN;
    bbox[l * 6 + 0] = static_cast<int32_t>(nz);
    bbox[l * 6 + 1] = static_cast<int32_t>(ny);
    bbox[l * 6 + 2] = static_cast<int32_t>(nx);
    bbox[l * 6 + 3] = 0;
    bbox[l * 6 + 4] = 0;
    bbox[l * 6 + 5] = 0;
  }
  int64_t i = 0;
  for (int64_t z = 0; z < nz; ++z)
    for (int64_t y = 0; y < ny; ++y)
      for (int64_t x = 0; x < nx; ++x, ++i) {
        const int32_t l = labels[i];
        if (l == 0) continue;
        const int32_t k = l - 1;
        ++areas[k];
        if (intensity && intensity[i] > max_int[k]) max_int[k] = intensity[i];
        int32_t* b = bbox + k * 6;
        if (z < b[0]) b[0] = static_cast<int32_t>(z);
        if (y < b[1]) b[1] = static_cast<int32_t>(y);
        if (x < b[2]) b[2] = static_cast<int32_t>(x);
        if (z + 1 > b[3]) b[3] = static_cast<int32_t>(z + 1);
        if (y + 1 > b[4]) b[4] = static_cast<int32_t>(y + 1);
        if (x + 1 > b[5]) b[5] = static_cast<int32_t>(x + 1);
      }
}

// Hole filling, cross connectivity: a hole is a background component that
// touches no face of the volume (its bounding box reaches none), and is set
// to 1. Matches scipy.ndimage.binary_fill_holes' default structure /
// fill_voids.fill (lungmask/utils.py:352).
void lm_fill_holes(uint8_t* mask, int64_t nz, int64_t ny, int64_t nx) {
  Labeling lab;
  CompStats st;
  const Box box = whole(nz, ny, nx);
  if (lab.build([mask](int64_t i) { return mask[i] ? 0 : 1; }, box, false, 1,
                &st) <= 0)
    return;
  const Slab& sl = lab.slabs[0];
  int64_t ri = 0;
  for (int64_t r = 0; r < nz * ny; ++r)
    for (; ri < sl.row_start[r + 1]; ++ri) {
      const Run& run = sl.runs[ri];
      const int32_t k = sl.label[run.comp] - 1;
      if (!box.on_border(st.bbox.data() + static_cast<size_t>(k) * 6))
        std::memset(mask + r * nx + run.x0, 1, run.x1 - run.x0);
    }
}

}  // extern "C"

namespace {

// Full exact postprocessing of the label volume val(i), in `nslabs` slabs
// for each pass over the whole volume (each champion's window takes its own
// count). See lm_postprocess. Returns nslabs, or -1 on error.
template <typename V>
int32_t postprocess(const V& val, int64_t nz, int64_t ny, int64_t nx,
                    const int32_t* spare, int32_t n_spare, int32_t skip_below,
                    int32_t workers, int64_t slab_voxels, int nslabs,
                    uint8_t* out) {
  const int64_t sy = nx, sz = ny * nx, n = nz * sz;
  const Box box = whole(nz, ny, nx);

  auto in_spare = [&](int64_t v) {
    for (int32_t s = 0; s < n_spare; ++s)
      if (spare[s] == v) return true;
    return false;
  };

  double t0 = pp_timing() ? pp_now() : 0.0;
  // Persistent scratch: the working buffers total ~200 MB for a full-size
  // fused volume; fresh ones would be mapped and page-faulted anew on every
  // call, so they are kept across a thread's calls. Bound by reference: a
  // thread_local named inside a task would be the pool thread's own.
  static thread_local Work tls;
  Work& w = tls;
  int32_t* const comp = w.comp.get(n);
  Labeling& lab = w.lab;
  CompStats& st = w.st;
  const int32_t n_comp = lab.build(val, box, /*full*/ true, nslabs, &st);
  if (n_comp < 0) return -1;
  lab.write(comp, box);
  std::vector<int64_t>& areas = st.areas;
  std::vector<int32_t>& maxint = st.value;
  std::vector<int32_t>& bbox = st.bbox;
  if (pp_timing()) {
    fprintf(stderr, "lm_postprocess: label %.3fs (n_comp=%d, slabs=%d)\n",
            pp_now() - t0, n_comp, nslabs);
    t0 = pp_now();
  }

  // Ascending initial area, ties in ascending-label (stable) order.
  std::vector<int32_t> order(n_comp);
  for (int32_t i = 0; i < n_comp; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return areas[a] < areas[b];
  });

  // Initial per-class champion areas + the interim-champion class LUT
  // (every region that strictly exceeded the running max keeps its mark —
  // reference utils.py:294-308 semantics, scanned in ascending-area order).
  int32_t max_class = 0;
  for (int32_t i = 0; i < n_comp; ++i)
    if (maxint[i] > max_class) max_class = maxint[i];
  std::vector<int64_t> champion_area(max_class + 1, 0);
  std::vector<uint8_t> class_of(n_comp + 1, 0);
  for (int32_t oi = 0; oi < n_comp; ++oi) {
    const int32_t r = order[oi];
    const int32_t v = maxint[r];
    if (areas[r] > champion_area[v]) {
      champion_area[v] = areas[r];
      class_of[r + 1] = static_cast<uint8_t>(v);
    }
  }

  // ---- merge loop (serial: later windows read the labels earlier merges
  // wrote, and the champion areas change as it goes) ----
  bool merged_any = false;
  std::vector<int64_t>& cnt = w.cnt;
  cnt.assign(n_comp + 1, 0);
  std::vector<int32_t> touched;
  for (int32_t oi = 0; oi < n_comp; ++oi) {
    const int32_t r = order[oi];
    const int32_t L = r + 1;
    const int32_t v = maxint[r];
    if (!((areas[r] < champion_area[v] || in_spare(v)) &&
          areas[r] >= skip_below))
      continue;
    int32_t* b = bbox.data() + static_cast<size_t>(r) * 6;
    const int64_t z0 = b[0] > 2 ? b[0] - 2 : 0, y0 = b[1] > 2 ? b[1] - 2 : 0,
                  x0 = b[2] > 2 ? b[2] - 2 : 0;
    const int64_t z1 = b[3] + 2 < nz ? b[3] + 2 : nz,
                  y1 = b[4] + 2 < ny ? b[4] + 2 : ny,
                  x1 = b[5] + 2 < nx ? b[5] + 2 : nx;
    // Border vote: a voxel is under the dilated footprint iff it is L or has
    // an L 6-neighbor *within the window* (scipy pads with 0 outside the
    // window array — identical membership).
    touched.clear();
    for (int64_t z = z0; z < z1; ++z)
      for (int64_t y = y0; y < y1; ++y) {
        const int64_t row = z * sz + y * sy;
        for (int64_t x = x0; x < x1; ++x) {
          const int64_t p = row + x;
          const int32_t c = comp[p];
          if (c == 0 || c == L) continue;
          const bool dil = (x > x0 && comp[p - 1] == L) ||
                           (x + 1 < x1 && comp[p + 1] == L) ||
                           (y > y0 && comp[p - sy] == L) ||
                           (y + 1 < y1 && comp[p + sy] == L) ||
                           (z > z0 && comp[p - sz] == L) ||
                           (z + 1 < z1 && comp[p + sz] == L);
          if (!dil) continue;
          if (cnt[c]++ == 0) touched.push_back(c);
        }
      }
    std::sort(touched.begin(), touched.end());
    int32_t target = L;
    int64_t best_border = 0, moved = 0;
    for (const int32_t c : touched) {
      if (cnt[c] > best_border && !in_spare(c)) {
        best_border = cnt[c];
        target = c;
        moved = areas[r];
      }
      cnt[c] = 0;
    }
    if (target != L) {
      merged_any = true;
      for (int64_t z = z0; z < z1; ++z)
        for (int64_t y = y0; y < y1; ++y) {
          const int64_t row = z * sz + y * sy;
          for (int64_t x = x0; x < x1; ++x)
            if (comp[row + x] == L) comp[row + x] = target;
        }
      int32_t* tb = bbox.data() + static_cast<size_t>(target - 1) * 6;
      for (int k = 0; k < 3; ++k) {
        if (b[k] < tb[k]) tb[k] = b[k];
        if (b[k + 3] > tb[k + 3]) tb[k + 3] = b[k + 3];
      }
    }
    const int32_t t = target - 1;
    if (areas[t] == champion_area[maxint[t]]) champion_area[maxint[t]] += moved;
    areas[t] += moved;
  }

  if (pp_timing()) {
    fprintf(stderr, "lm_postprocess: merge %.3fs (merged_any=%d)\n",
            pp_now() - t0, (int)merged_any);
    t0 = pp_now();
  }

  // class volume (interim-champion LUT, spare classes zeroed — np.isin on
  // *class values*, utils.py:342).
  for (int32_t l = 1; l <= n_comp; ++l)
    if (class_of[l] && in_spare(class_of[l])) class_of[l] = 0;

  // ---- final sweep: per-class champion + windowed hole fill ----
  // finals: (label, class value, area, bbox*) in ascending label order.
  std::vector<int32_t> fin_label;
  std::vector<uint8_t> fin_value;
  std::vector<int64_t> fin_area;
  const int32_t* fin_bbox = nullptr;
  CompStats& st2 = w.st2;
  bool any_zero = false;  // a voxel of class 0 in the class volume

  if (!merged_any && n_spare == 0) {
    // No merge wrote into comp and no spare was zeroed: comp restricted to
    // the marked champions IS the final labeling (equality argument in the
    // Python source). Areas are the original (unmutated in this branch).
    int64_t labeled = 0;
    for (int32_t l = 1; l <= n_comp; ++l) {
      labeled += areas[l - 1];
      if (class_of[l]) {
        fin_label.push_back(l);
        fin_value.push_back(class_of[l]);
        fin_area.push_back(areas[l - 1]);
      } else {
        any_zero = true;
      }
    }
    any_zero |= labeled < n;
    fin_bbox = bbox.data();
  } else {
    // Relabel the class volume class_of[comp] with fused stats, read through
    // the LUT as the runs are extracted (never written out); it has a zero
    // voxel iff its components do not cover the volume.
    const uint8_t* lut = class_of.data();
    const int32_t n2 = lab.build([lut, comp](int64_t i) { return lut[comp[i]]; },
                                 box, true, nslabs, &st2);
    if (n2 < 0) return -1;
    lab.write(comp, box);
    int64_t labeled = 0;
    for (int32_t l = 1; l <= n2; ++l) {
      fin_label.push_back(l);
      fin_value.push_back(static_cast<uint8_t>(st2.value[l - 1]));
      fin_area.push_back(st2.areas[l - 1]);
      labeled += st2.areas[l - 1];
    }
    any_zero = labeled < n;
    fin_bbox = st2.bbox.data();
  }
  if (pp_timing()) {
    fprintf(stderr, "lm_postprocess: final-relabel %.3fs (finals=%zu)\n",
            pp_now() - t0, fin_label.size());
    t0 = pp_now();
  }

  // Classes present, ascending; drop the FIRST sorted-unique value verbatim
  // (utils.py:355) — when 0 is absent this drops the smallest class.
  std::vector<uint8_t> present(max_class + 2, 0);
  present[0] = any_zero;
  for (size_t f = 0; f < fin_label.size(); ++f) present[fin_value[f]] = 1;
  std::vector<int32_t> classes;
  for (int32_t v = 0; v <= max_class + 1; ++v)
    if (present[v]) classes.push_back(v);
  if (!classes.empty()) classes.erase(classes.begin());

  over_slabs(nz, sz, nslabs, [&](int, int64_t i0, int64_t i1) {
    std::memset(out + i0, 0, static_cast<size_t>(i1 - i0));
  });

  // Champion per class: ascending-label scan keeps the LAST maximal region.
  std::vector<int32_t> champ(max_class + 2, -1);
  for (size_t f = 0; f < fin_label.size(); ++f) {
    const uint8_t v = fin_value[f];
    if (!v) continue;
    if (champ[v] < 0 || fin_area[f] >= fin_area[champ[v]]) champ[v] = (int32_t)f;
  }

  // Each champion filled on its own bounding window: the window's voxels
  // other than L are labeled (cross connectivity), and those of components
  // that reach no face of the window are holes. A window row is painted from
  // its runs alone: L between the runs, and the runs that are holes. The
  // classes paint in ascending order, each after the one before, so
  // overlapping windows resolve as in a serial sweep.
  CompStats& stw = w.stw;
  for (const int32_t v : classes) {
    if (v == 0 || champ[v] < 0) continue;
    const int32_t L = fin_label[champ[v]];
    const int32_t* b = fin_bbox + static_cast<size_t>(L - 1) * 6;
    const Box win = {b[0], b[1], b[2], b[3] - b[0], b[4] - b[1], b[5] - b[2],
                     sy, sz};
    const int wslabs =
        slab_count(win.wz, win.wz * win.wy * win.wx, workers, slab_voxels);
    if (lab.build([comp, L](int64_t i) { return comp[i] != L ? 1 : 0; }, win,
                  false, wslabs, &stw) < 0)
      return -1;
    const uint8_t value = static_cast<uint8_t>(v);
    parallel_for(wslabs, [&](int s) {
      const Slab& sl = lab.slabs[s];
      int64_t ri = 0;
      for (int64_t z = sl.z0; z < sl.z1; ++z)
        for (int64_t y = 0; y < win.wy; ++y) {
          uint8_t* dst = out + win.at(z, y);
          const int64_t r1 = sl.row_start[(z - sl.z0) * win.wy + y + 1];
          int32_t x = 0;
          for (; ri < r1; ++ri) {
            const Run& run = sl.runs[ri];
            const int32_t k = sl.label[run.comp] - 1;
            const bool hole =
                !win.on_border(stw.bbox.data() + static_cast<size_t>(k) * 6);
            std::memset(dst + x, value, (hole ? run.x1 : run.x0) - x);
            x = run.x1;
          }
          std::memset(dst + x, value, win.wx - x);
        }
    });
  }
  if (pp_timing())
    fprintf(stderr, "lm_postprocess: fills %.3fs\n", pp_now() - t0);
  return nslabs;
}

}  // namespace

extern "C" {

// Full exact postprocessing in one native call (3-D volumes).
//
// Mirrors transforms/postprocess.py::postprocessing (the windowed
// re-derivation of lungmask/utils.py:272-358) voxel-for-voxel — that Python
// implementation remains the oracle and the differential tests pin this one
// against it. The merge loop is a 7-point stencil sweep over each region's
// current bounding window.
//
// Quirks reproduced exactly (see the Python docstring for the full list):
// ascending-area processing with stable (label-order) ties; dilated-border
// vote with ties by ascending component label; *component labels* compared
// against `spare` values at the vote (utils.py:323); champion-area cache
// mutation on merges (utils.py:330-339); sub-skip_below regions neither merge
// nor update caches; final sweep over sorted-unique class values with the
// FIRST value dropped (utils.py:355 `np.unique(mapped)[1:]`, even when 0 is
// absent); last-maximal-region tie-break for per-class champions; hole
// filling on the champion's own bounding window.
//
//   label_image: uint8 volume (z,y,x), the multi-class prediction
//   spare/n_spare: spare label values (fusion path), may be empty
//   skip_below: minimum region area to participate in merging
//   workers: threads a pass may use, the caller's included
//   slab_voxels: the fewest voxels a slab takes (fewer than two slabs' worth
//     runs the pass on the calling thread alone)
//   out: uint8 postprocessed volume (caller-allocated, same shape)
// Returns the number of slabs the passes over the volume took, or -1 on
// error (nz < 2: single-slice volumes use the Python area_closing path).
int32_t lm_postprocess(const uint8_t* label_image, int64_t nz, int64_t ny,
                       int64_t nx, const int32_t* spare, int32_t n_spare,
                       int32_t skip_below, int32_t workers, int64_t slab_voxels,
                       uint8_t* out) {
  if (nz < 2) return -1;
  const int nslabs = slab_count(nz, nz * ny * nx, workers, slab_voxels);
  return postprocess([label_image](int64_t i) { return label_image[i]; }, nz,
                     ny, nx, spare, n_spare, skip_below, workers, slab_voxels,
                     nslabs, out);
}

// Fused-path finish in one native call (reference mask.py:228-232 semantics):
//   spare = max(res_l) + 1
//   FN-fill:    res_l[res_l == 0 & res_r > 0] = spare
//   FP-removal: res_l[res_r == 0] = 0
//   out = lm_postprocess(res_l, spare=[spare])
// The fused volume is never written: the labeling reads it from the two
// masks as it extracts runs. Returns as lm_postprocess; -1 also when the
// spare would overflow uint8.
int32_t lm_fused_finish(const uint8_t* res_l, const uint8_t* res_r, int64_t nz,
                        int64_t ny, int64_t nx, int32_t skip_below,
                        int32_t workers, int64_t slab_voxels, uint8_t* out) {
  if (nz < 2) return -1;
  const int64_t sz = ny * nx;
  const int nslabs = slab_count(nz, nz * sz, workers, slab_voxels);
  std::vector<uint8_t> maxs(nslabs, 0);
  over_slabs(nz, sz, nslabs, [&](int s, int64_t i0, int64_t i1) {
    uint8_t m = 0;
    for (int64_t i = i0; i < i1; ++i) m = std::max(m, res_l[i]);
    maxs[s] = m;
  });
  const uint8_t maxv = *std::max_element(maxs.begin(), maxs.end());
  if (maxv == 255) return -1;
  const uint8_t spare_u8 = static_cast<uint8_t>(maxv + 1);
  const int32_t spare = spare_u8;
  // FN-fill-then-FP-removal in one expression: res_r==0 always clears;
  // otherwise res_l==0 becomes spare.
  return postprocess(
      [res_l, res_r, spare_u8](int64_t i) -> uint8_t {
        return res_r[i] == 0 ? 0 : (res_l[i] == 0 ? spare_u8 : res_l[i]);
      },
      nz, ny, nx, &spare, 1, skip_below, workers, slab_voxels, nslabs, out);
}

// Expand bit-packed class maps (runtime/engine.py packs masks to 2 or 4 bits
// per pixel on device to shrink the device→host download; the expansion back
// to uint8 sits on the single-volume latency path). One 256-entry word-wide
// LUT turns each packed byte into a 4- or 2-byte store at memory bandwidth.
//   bits: 2 (4 pixels/byte, low crumb first) or 4 (2 pixels/byte, low nibble
//   first). Returns 0 on success, -1 on unsupported bits.
int32_t lm_unpack_bits(const uint8_t* packed, int64_t n_bytes, int32_t bits,
                       uint8_t* out) {
  // LUTs are built byte-wise so pixel order within each packed byte is
  // host-endianness-independent (a word-built LUT would reverse it on a
  // big-endian host).
  if (bits == 2) {
    uint8_t lut[256][4];
    for (uint32_t v = 0; v < 256; ++v)
      for (uint32_t p = 0; p < 4; ++p)
        lut[v][p] = (uint8_t)((v >> (2 * p)) & 3u);
    for (int64_t i = 0; i < n_bytes; ++i)
      std::memcpy(out + 4 * i, lut[packed[i]], 4);
    return 0;
  }
  if (bits == 4) {
    uint8_t lut[256][2];
    for (uint32_t v = 0; v < 256; ++v) {
      lut[v][0] = (uint8_t)(v & 15u);
      lut[v][1] = (uint8_t)(v >> 4);
    }
    for (int64_t i = 0; i < n_bytes; ++i)
      std::memcpy(out + 2 * i, lut[packed[i]], 2);
    return 0;
  }
  return -1;
}

// Batched mask paste-back: the reference's per-slice reshape_mask
// (/root/reference/lungmask/utils.py:114-129) — nearest-neighbor zoom of each
// (mh, mw) class map to its body bbox, pasted into a zero (H, W) canvas — for
// the whole volume in one call. Bit-identical to ops/resample.paste_masks_host
// (differential test in tests/test_resample.py): the gather plan uses scipy's
// float64 arithmetic, cc = i * double(in-1)/(out-1), round half up, with
// cc > in-1 treated as out of bounds (cval=0).
//
// Motivation: the numpy paste loop's per-slice fancy-indexing allocations made
// this stage the e2e long pole under host contention (BENCH_r03: 0.137 s
// quiet → 2.341 s contended). One pass of row-gather memcpy-like stores runs
// at memory bandwidth and holds no GIL.
//   masks: (n, mh, mw) uint8;  boxes: (n, 4) int32 half-open (r0, c0, r1, c1)
//   out:   (n, H, W) uint8, fully overwritten. Returns 0 on success, -1 on a
//   box outside the canvas (callers fall back to the numpy path).
int32_t lm_paste_masks(const uint8_t* masks, int64_t n, int64_t mh, int64_t mw,
                       const int32_t* boxes, int64_t H, int64_t W,
                       uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* b = boxes + 4 * i;
    if (b[0] < 0 || b[1] < 0 || b[2] > H || b[3] > W) return -1;
  }
  std::memset(out, 0, (size_t)(n * H * W));
  std::vector<int64_t> cidx;
  std::vector<uint8_t> row;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r0 = boxes[4 * i], c0 = boxes[4 * i + 1];
    const int64_t r1 = boxes[4 * i + 2], c1 = boxes[4 * i + 3];
    const int64_t bh = r1 - r0, bw = c1 - c0;
    if (bh <= 0 || bw <= 0) continue;
    const uint8_t* mask = masks + i * mh * mw;
    uint8_t* canvas = out + i * H * W;
    // Column plan (shared by every row of this slice). oob → the sample
    // stays 0 (canvas is pre-zeroed), marked with index -1.
    cidx.assign(bw, -1);
    double czoom = bw == 1 ? 0.0 : (double)(mw - 1) / (double)(bw - 1);
    for (int64_t c = 0; c < bw; ++c) {
      double cc = (double)c * czoom;
      if (cc > (double)(mw - 1) || cc < 0.0) continue;
      int64_t idx = (int64_t)std::floor(cc + 0.5);
      cidx[c] = idx < 0 ? 0 : (idx > mw - 1 ? mw - 1 : idx);
    }
    double rzoom = bh == 1 ? 0.0 : (double)(mh - 1) / (double)(bh - 1);
    row.resize(bw);
    int64_t prev_src = -2;
    for (int64_t r = 0; r < bh; ++r) {
      double cc = (double)r * rzoom;
      if (cc > (double)(mh - 1) || cc < 0.0) {
        prev_src = -2;  // oob row: canvas stays 0
        continue;
      }
      int64_t src = (int64_t)std::floor(cc + 0.5);
      if (src < 0) src = 0;
      if (src > mh - 1) src = mh - 1;
      if (src != prev_src) {  // upsampled rows repeat: gather once, copy after
        const uint8_t* mrow = mask + src * mw;
        for (int64_t c = 0; c < bw; ++c)
          row[c] = cidx[c] < 0 ? 0 : mrow[cidx[c]];
        prev_src = src;
      }
      std::memcpy(canvas + (r0 + r) * W + c0, row.data(), (size_t)bw);
    }
  }
  return 0;
}

}  // extern "C"
