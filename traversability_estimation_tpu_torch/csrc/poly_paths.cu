// Kernel 3: the grouped polygonal path evaluator in one launch.
//
// Not the port of a TPU kernel: on the TPU the JAX package's grouped
// evaluator (traversability_estimation_tpu/ops/footprint.py:1208,
// check_polygonal_paths_grouped) is XLA-fused jnp code. Plain version:
// ops/footprint.py::check_polygonal_paths_grouped, ~1,750 eager torch
// operations for a 1024 x 50 batch, whose float32 steps this kernel repeats
// one by one (built with -fmad=false; every fused multiply-add of the plain
// version, its emulated fma_f32, is an explicit __fmaf_rn here):
//   1. poses -> footprints (transform_footprint);
//   2. one convex ring per consecutive pose pair: the swept hull of two
//      translates (swept_hull_translates) or the edge-matrix hull
//      (ops/hull.py), with its 3e-6 collinearity band, its first valid
//      successor, its walk and its padding;
//   3. the raster window of the path (or of each block of SEG_BLOCK
//      segments, re-anchored per block) in the padded query plane;
//   4. per (edge, window column) the binary search for the row where the
//      crossing comparison flips, in the plain version's fixed number of
//      rounds; the inside run of a column is [min, max) of the flip rows of
//      the edges that straddle its centre line;
//   5. per ring the fail / count / sum reduction and its verdict;
//   6. the shoelace areas and the path's area-weighted aggregation.
// Every term is the plain version's float32 value; the sums over terms
// (window cells, shoelace terms, a path's segments) accumulate in float64
// and round once, in an order fixed by the launch geometry (no floating-point
// atomics: two launches give the same bits), so they carry less rounding
// than the plain version's float32 sums, whose order differs anyway. Counts
// and verdicts are exact.
//
// What bounds it on the H100: issued instructions and latency, not bytes (a
// batch reads ~1 MB of plane and ~6 MB of poses) nor float rate. A stage
// profile of the first design (one block per path, scripts/kernel3_profile.py)
// put its warp cycles in the searches, the hull tests and the cell sweep,
// with one thread aggregating each path while its block held the SM. This
// design:
//   - a block of 8 warps takes a ring block of 8 rings at a time (SEG_BLOCK
//     segments; the pose-0 footprint is the path's last ring), a warp per
//     ring; 4 blocks fit an SM (__launch_bounds__(256, 4)). A path is one
//     block, or, where the batch has too few paths to fill the card, a
//     cluster of up to 8 blocks taking every cluster-th ring block (the host
//     chooses: a block's warps wait for its slowest, a cluster for its
//     slowest block). 8 paths x 10 poses start 16 blocks, not 8;
//   - the path's verdict: each warp sums its rings' weights in float64, the
//     cluster meets at a barrier, and the leader block's first warp reads
//     every warp's sums from the cluster's shared memory (distributed shared
//     memory) and reduces them in a fixed order;
//   - rasterises only the columns a ring spans: those whose centre line lies
//     in [min y, max y) of its points, found with the same cell_coord
//     arithmetic (every other column has no straddling edge, so no cell);
//     in strips of 32 columns, a lane finds its column's two straddling
//     edges first and runs their two searches together, then the warp sweeps
//     the strip's rows with neighbouring lanes on neighbouring cells of a row
//     (coalesced; a narrow strip takes several rows at a time), four rows of
//     loads in flight per lane, each cell tested against its column's run;
//   - the hull's O(M^3) test exits at the first point outside an edge; the
//     duplicates are a bit mask from the warp's shuffles, a successor is an
//     atomicMin over the valid edges of a vertex, and the walk along the
//     successors is pointer doubling over the warp's lanes (rings of at most
//     32 points);
//   - a slot (a ring's points) is shared memory; a footprint whose slots
//     exceed it (more than 302 vertices conservative, 604 plain) takes its
//     slots from a global scratch of one slice per block instead: the same
//     code, compiled for either space (kGlobal); so too the work counters of
//     the bound (kCount) and the per-stage clocks (kStage), off in use.
// TMA and cp.async are not used: the plane is read once per ring from L2
// (0.45 MB at 336^2, 17 MB at 2048^2), a cell at a time under its run's
// predicate.
// The launch geometry is computed on the host by
// ops/poly_kernel.py::launch_plan and checked here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define POLY_WARPS 8          // == ops/footprint.py::SEG_BLOCK: the rings of one ring block
#define POLY_SLOT_WORDS 6     // per ring point: x, y, ring x, ring y, successor, duplicate
#define POLY_CLUSTER 8        // most blocks of one path (a portable cluster)
#define POLY_PARTIAL_BYTES 256  // shared memory of the warps' partials and ring 0

constexpr int kThreads = POLY_WARPS * 32;
constexpr unsigned kFull = 0xffffffffu;

struct PolyParams {
  const float* pos;      // (P, N, pos_d)
  const float* quat;     // (P, N, 4) xyzw
  const int* n_poses;    // (P,)
  const float* fp;       // (V, 2)
  const float* plane;    // (H + 2 gpad, Wp = W + 2 gpad) packed query plane, ring of +inf
  const float* p0;       // (2,) map origin P0
  int N, pos_d, V, H, W, Wp, gpad, wi, wj, n_bits, cap, cluster, n_blocks;
  float res, res_rcp, default_tv;
  int conservative, translate_only, use_blocks;
  float* slots;  // (grid, POLY_WARPS, POLY_SLOT_WORDS, cap) global slots, or null: shared memory
  unsigned long long* work;   // null, or [hull point tests, searches, straddle tests] added up
  unsigned long long* stage;  // null, or kStages per-stage warp cycles added up
  uint8_t* safe;
  float* trav;
  float* area;
  // per ring (P, N): ring 0 the pose-0 footprint, ring u > 0 segment u - 1
  uint8_t* u_fail;
  int* u_n;
  float* u_sum;
  float* u_area;  // ring 0: its area; ring u > 0: the segment's area weight
};

// one warp's share of its path's verdict, in its block's shared memory
struct WarpPartial {
  double total, weighted;  // sum of valid segments' weights w, and of w * trav
  int ok;                  // every valid segment ok
};
struct Ring0 {
  int ok;
  float trav, area;
};
static_assert(POLY_WARPS * sizeof(WarpPartial) + sizeof(Ring0) <= POLY_PARTIAL_BYTES, "partials");

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Per-stage clocks of one warp (kStage, off in use): lap(k) adds the cycles
// since the previous lap to stage k of the warp's counters in shared memory
// (lane 0's clock), so that the instantiation keeps the production code's
// registers; a lap after a divergent branch falls after the warp
// reconverges, so it counts the branch's whole time.
enum Stage {
  kTransform, kHullTests, kHullWalk, kRingArea, kStraddle, kSearch, kSweep, kAggregate,
  kBarrier, kOther, kStages
};

template <bool kOn>
struct Stages {
  unsigned long long* c;  // this warp's kStages counters, written by lane 0
  long long t;
  __device__ __forceinline__ void start(unsigned long long* counters, int lane) {
    if (kOn) {
      c = lane == 0 ? counters : nullptr;
      if (c)
        for (int k = 0; k < kStages; ++k) c[k] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void lap(int k) {
    if (kOn) {
      const long long n = clock64();
      if (c) c[k] += (unsigned long long)(n - t);
      t = n;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (kOn && c)
      for (int k = 0; k < kStages; ++k) atomicAdd(&out[k], c[k]);
  }
};

// footprint vertex v at pose t of `path` (transform_footprint)
__device__ __forceinline__ void transform(const PolyParams& p, int path, int t, int v,
                                          float& ox, float& oy) {
  const float* q = p.quat + ((size_t)path * p.N + t) * 4;
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float n = __fmaf_rn(w, w, __fmaf_rn(z, z, __fmaf_rn(x, x, y * y)));
  // `2.0 / n` in torch is reciprocal(n) * 2
  const float s = n > 0.0f ? __frcp_rn(n) * 2.0f : 0.0f;
  const float r00 = __fmaf_rn(-s, y * y + z * z, 1.0f);
  const float r01 = s * __fmaf_rn(x, y, -(z * w));
  const float r10 = s * __fmaf_rn(x, y, z * w);
  const float r11 = __fmaf_rn(-s, x * x + z * z, 1.0f);
  const float fx = p.fp[2 * v], fy = p.fp[2 * v + 1];
  const float* ps = p.pos + ((size_t)path * p.N + t) * p.pos_d;
  ox = __fmaf_rn(r00, fx, r01 * fy) + ps[0];
  oy = __fmaf_rn(r10, fx, r11 * fy) + ps[1];
}

// map-frame centre of cell index g along one axis (_cell_coord)
__device__ __forceinline__ float cell_coord(float p0, int g, float res) {
  return __fmaf_rn(-((float)g + 0.5f), res, p0);
}

// top-left corner in the padded plane of the window centred on the cell of
// (ax, ay) (_index_of, then _window_starts)
__device__ __forceinline__ void window_start(const PolyParams& p, float ax, float ay, int& si,
                                             int& sj) {
  const int ai = __float2int_rd((p.p0[0] - ax) * p.res_rcp);
  const int aj = __float2int_rd((p.p0[1] - ay) * p.res_rcp);
  si = min(max(ai - p.wi / 2 + p.gpad, 0), p.H + 2 * p.gpad - p.wi);
  sj = min(max(aj - p.wj / 2 + p.gpad, 0), p.W + 2 * p.gpad - p.wj);
}

// the window centred on the bbox centre of the points (X, Y)[0, m)
__device__ __forceinline__ void bbox_window(const PolyParams& p, const float* X, const float* Y,
                                            int m, int lane, int& si, int& sj) {
  float mx = -INFINITY, my = -INFINITY, nx = INFINITY, ny = INFINITY;
  for (int v = lane; v < m; v += 32) {
    mx = fmaxf(mx, X[v]), nx = fminf(nx, X[v]);
    my = fmaxf(my, Y[v]), ny = fminf(ny, Y[v]);
  }
  window_start(p, 0.5f * (warp_max(mx) + warp_min(nx)), 0.5f * (warp_max(my) + warp_min(ny)),
               si, sj);
}

// shoelace area of a ring of m points (polygon_area), by one warp
__device__ float ring_area(const float* X, const float* Y, int m, int lane) {
  double acc = 0.0;
  for (int k = lane; k < m; k += 32) {
    const int j = k == 0 ? m - 1 : k - 1;
    acc += (X[j] + X[k]) * (Y[j] - Y[k]);
  }
  return fabsf((float)warp_sum(acc) * 0.5f);
}

// Edge-matrix convex hull (ops/hull.py) of the m points (X, Y), every one
// valid, into the ring (RX, RY) of m entries, by one warp; kCount: its point
// tests are added to work[0].
// one point test of the edge i -> j (from (xi, yi), direction (jx, jy) of
// squared length len2) against point k at (xk, yk): left of the edge, or on
// it between i and j within the collinearity band
__device__ __forceinline__ bool edge_test(float xi, float yi, float jx, float jy, float len2,
                                          float xk, float yk) {
  const float kx = xk - xi, ky = yk - yi;
  const float cross = __fmaf_rn(jx, ky, -(jy * kx));
  const float dot = __fmaf_rn(jx, kx, jy * ky);
  const float k_len2 = __fmaf_rn(kx, kx, ky * ky);
  const float eps = 3e-6f * __fsqrt_rn(len2 * k_len2) + 1e-30f;
  const bool left = cross > eps;
  const bool between = (fabsf(cross) <= eps) & (dot >= -eps) & (dot <= len2 + eps);
  return left | between;
}

// Edge-matrix convex hull (ops/hull.py) of the m points (X, Y), every one
// valid, into the ring (RX, RY) of m entries, by one warp; kCount: its point
// tests are added to work[0]. A pair (i, j) is tested against k = 0, 1, ...
// up to its first point outside; a point equal to an earlier one (a
// duplicate) is no edge's end, and succ[i] is the least j of a valid edge.
template <bool kCount, bool kStage>
__device__ void hull_ring(const float* X, const float* Y, int m, int* succ, int* dup, float* RX,
                          float* RY, int lane, unsigned long long* work, Stages<kStage>& st) {
  // the duplicates: a bit mask from the warp's shuffles (m <= 32), else in
  // the slot
  unsigned dups = 0;
  if (m <= 32) {
    const float xa = lane < m ? X[lane] : 0.0f, ya = lane < m ? Y[lane] : 0.0f;
    bool d = false;
    for (int b = 0; b < m; ++b) {
      const float xb = __shfl_sync(kFull, xa, b), yb = __shfl_sync(kFull, ya, b);
      d |= (b < lane) & (xa == xb) & (ya == yb);
    }
    dups = __ballot_sync(kFull, lane < m && d);
  } else {
    for (int a = lane; a < m; a += 32) {
      int d = 0;
      for (int b = 0; b < a; ++b) d |= (X[a] == X[b]) & (Y[a] == Y[b]);
      dup[a] = d;
    }
  }
  for (int a = lane; a < m; a += 32) succ[a] = m;
  __syncwarp();
  unsigned long long tests = 0;
  for (int q = lane; q < m * m; q += 32) {
    const int i = q / m, j = q - i * m;
    const bool skip = m <= 32 ? ((dups >> i) | (dups >> j)) & 1 : dup[i] | dup[j];
    if (skip || i == j) continue;
    const float xi = X[i], yi = Y[i];
    const float jx = X[j] - xi, jy = Y[j] - yi;
    const float len2 = __fmaf_rn(jx, jx, jy * jy);
    bool ok = true;
    for (int k = 0; k < m && ok; ++k) {
      ++tests;
      ok = edge_test(xi, yi, jx, jy, len2, X[k], Y[k]);
    }
    if (ok) atomicMin(&succ[i], j);
  }
  if (kCount) {
    for (int o = 16; o; o >>= 1) tests += __shfl_xor_sync(kFull, tests, o);
    if (lane == 0) atomicAdd(&work[0], tests);
  }
  __syncwarp();
  st.lap(kHullTests);
  // the walk from the first hull vertex; from its first return on, the
  // padding repeats that vertex: point t of the ring is f^t(start), f(i) the
  // successor of i (start where i has none)
  if (m <= 32) {
    const int s = lane < m ? succ[lane] : m;
    const unsigned has = __ballot_sync(kFull, s < m);
    const int start = has ? __ffs(has) - 1 : 0;
    int g = s < m ? s : start;  // f^(2^b) of this lane's point
    int cur = start;            // f^(lane's low b bits)(start)
    for (int b = 0; (1 << b) < m; ++b) {
      const int nxt = __shfl_sync(kFull, g, cur);
      cur = (lane >> b) & 1 ? nxt : cur;
      g = __shfl_sync(kFull, g, g);
    }
    const unsigned back = __ballot_sync(kFull, lane >= 1 && lane < m && cur == start);
    const int first = back ? __ffs(back) - 1 : m;
    if (lane < m) {
      const int src = lane >= first ? start : cur;
      RX[lane] = X[src];
      RY[lane] = Y[src];
    }
  } else if (lane == 0) {
    int start = 0;
    for (int i = 0; i < m; ++i)
      if (succ[i] < m) {
        start = i;
        break;
      }
    int cur = start;
    bool back = false;
    for (int t = 0; t < m; ++t) {
      back |= t > 0 && cur == start;
      const int src = back ? start : cur;
      RX[t] = X[src];
      RY[t] = Y[src];
      const int nxt = succ[cur];
      cur = nxt < m ? nxt : start;
    }
  }
  __syncwarp();
  st.lap(kHullWalk);
}

// The ring of segment s of `path` into the warp's slot (RX, RY: `mh`
// entries); returns its area weight (hull area, less polygon1's after the
// first segment).
template <bool kCount, bool kStage>
__device__ float segment_ring(const PolyParams& p, int path, int s, float orient, float* X,
                              float* Y, float* RX, float* RY, int* succ, int* dup, int lane,
                              int& mh, Stages<kStage>& st) {
  const int V = p.V;
  const float* ps0 = p.pos + ((size_t)path * p.N + s) * p.pos_d;
  const float* ps1 = ps0 + p.pos_d;
  const float dx = ps1[0] - ps0[0], dy = ps1[1] - ps0[1];
  // the hull's points: [prev, cur] or, conservative, [prev, cur - d, cur, prev + d];
  // polygon1 is their first V or 2V
  const int mv = p.conservative ? 2 * V : V;
  for (int v = lane; v < V; v += 32) {
    float ax, ay, bx, by;
    transform(p, path, s, v, ax, ay);
    transform(p, path, s + 1, v, bx, by);
    if (p.conservative) {
      X[v] = ax, Y[v] = ay;
      X[V + v] = bx - dx, Y[V + v] = by - dy;
      X[2 * V + v] = bx, Y[2 * V + v] = by;
      X[3 * V + v] = ax + dx, Y[3 * V + v] = ay + dy;
    } else {
      X[v] = ax, Y[v] = ay;
      X[V + v] = bx, Y[V + v] = by;
    }
  }
  __syncwarp();
  st.lap(kTransform);
  mh = 2 * mv;
  if (p.translate_only && !p.conservative) {
    // swept_hull_translates: vertex k's poly1 copy where the outward normal
    // of the edge beside it opposes d, its poly2 copy where it aligns
    for (int k = lane; k < V; k += 32) {
      // edge k runs from vertex k to k + 1; edge k - 1 enters vertex k
      const int kn = k + 1 == V ? 0 : k + 1, kp = k == 0 ? V - 1 : k - 1;
      const float ex = p.fp[2 * kn] - p.fp[2 * k], ey = p.fp[2 * kn + 1] - p.fp[2 * k + 1];
      const float epx = p.fp[2 * k] - p.fp[2 * kp], epy = p.fp[2 * k + 1] - p.fp[2 * kp + 1];
      const bool g = (ex * dy - ey * dx) * orient < 0.0f;
      const bool g_prev = (epx * dy - epy * dx) * orient < 0.0f;
      RX[2 * k] = g_prev ? X[V + k] : X[k];
      RY[2 * k] = g_prev ? Y[V + k] : Y[k];
      RX[2 * k + 1] = g ? X[V + k] : X[k];
      RY[2 * k + 1] = g ? Y[V + k] : Y[k];
    }
    __syncwarp();
    st.lap(kHullTests);
  } else {
    hull_ring<kCount>(X, Y, mh, succ, dup, RX, RY, lane, p.work, st);
  }
  float w = ring_area(RX, RY, mh, lane);
  if (s > 0) w -= ring_area(X, Y, mv, lane);
  st.lap(kRingArea);
  return w;
}

// the first column c in [0, wj] whose centre line py(c) lies below y: py
// falls with c (one rounding of a falling exact value), so the columns
// below y are one run from there on; the estimate is moved to it exactly
__device__ __forceinline__ int first_below(const PolyParams& p, float p0y, int gj0, float y) {
  const float est = (p0y - y) * p.res_rcp - 0.5f - (float)gj0;
  int c = (int)fminf(fmaxf(floorf(est), 0.0f), (float)p.wj);
  while (c > 0 && cell_coord(p0y, gj0 + c - 1, p.res) < y) --c;
  while (c < p.wj && !(cell_coord(p0y, gj0 + c, p.res) < y)) ++c;
  return c;
}

// the plain version's search over the window's rows, in its fixed rounds:
// the first row whose crossing comparison holds for an edge (x, d, rhs)
__device__ __forceinline__ int search(const PolyParams& p, float p0x, int gi0, float x, float d,
                                      float rhs) {
  int l = 0, h = p.wi;
  for (int b = 0; b < p.n_bits; ++b) {
    const int mid = (l + h) >> 1;
    const bool comp = (cell_coord(p0x, gi0 + mid, p.res) - x) * d < rhs;
    l = comp ? l : mid + 1;
    h = comp ? mid : h;
  }
  return l;
}

// fail / count / sum of the cells inside the convex ring (RX, RY: m
// entries, closed by wrap) in the window at (si, sj), by one warp (the
// span rule of seg_block); kCount: its searches are added to work[1] and
// its straddle tests to work[2]
template <bool kCount, bool kStage>
__device__ void rasterise(const PolyParams& p, const float* RX, const float* RY, int m, int si,
                          int sj, int lane, bool& fail, int& n, float& sum, Stages<kStage>& st) {
  const float p0x = p.p0[0], p0y = p.p0[1];
  const int gi0 = si - p.gpad, gj0 = sj - p.gpad;
  // the ring's columns: an edge straddles a centre line py only where py
  // lies in [min y, max y) of the ring's points (all of them: NaN compares
  // false and may straddle anywhere)
  float ymin = INFINITY, ymax = -INFINITY;
  bool nan = false;
  for (int e = lane; e < m; e += 32) {
    const float y = RY[e];
    ymin = fminf(ymin, y), ymax = fmaxf(ymax, y);
    nan |= isnan(y);
  }
  ymin = warp_min(ymin), ymax = warp_max(ymax);
  int c0 = 0, c1 = p.wj;
  if (!__any_sync(kFull, nan))
    c0 = first_below(p, p0y, gj0, ymax), c1 = first_below(p, p0y, gj0, ymin);
  bool f = false;
  int cnt = 0, searches = 0;
  double acc = 0.0;
  // strips of 32 columns: lane q the run of column cs + q
  for (int cs = c0; cs < c1; cs += 32) {
    const int cols = min(32, c1 - cs);
    const float py = cell_coord(p0y, gj0 + cs + lane, p.res);
    // the straddling edges: 0 or 2 for a convex ring, always an even number
    int ns = 0;
    float ax = 0.0f, ad = 0.0f, ar = 0.0f, bx = 0.0f, bd = 0.0f, br = 0.0f;
    if (lane < cols) {
      float xj = RX[m - 1], yj = RY[m - 1];  // the previous vertex of vertex 0
      for (int e = 0; e < m; ++e) {
        const float xi = RX[e], yi = RY[e];
        if ((yi > py) != (yj > py)) {
          const float denom = yj - yi;
          const float sg = denom > 0.0f ? 1.0f : -1.0f;
          const float d_abs = denom * sg;
          const float rhs = ((xj - xi) * (py - yi)) * sg;
          if (ns == 0) ax = xi, ad = d_abs, ar = rhs;
          else if (ns == 1) bx = xi, bd = d_abs, br = rhs;
          ++ns;
        }
        xj = xi;
        yj = yi;
      }
    }
    st.lap(kStraddle);
    // both searches together, on every lane (a lane without edges searches
    // no-ops and keeps the empty run)
    const int la = search(p, p0x, gi0, ax, ad, ar), lb = search(p, p0x, gi0, bx, bd, br);
    int lo = p.wi, end = 0;
    if (ns >= 2) lo = min(la, lb), end = min(max(la, lb), p.wi);
    if (ns > 2) {
      // a ring that is not convex: every further straddling edge
      int seen = 0, hi = max(la, lb);
      float xj = RX[m - 1], yj = RY[m - 1];
      for (int e = 0; e < m; ++e) {
        const float xi = RX[e], yi = RY[e];
        if ((yi > py) != (yj > py) && seen++ >= 2) {
          const float denom = yj - yi;
          const float sg = denom > 0.0f ? 1.0f : -1.0f;
          const int l = search(p, p0x, gi0, xi, denom * sg, ((xj - xi) * (py - yi)) * sg);
          lo = min(lo, l), hi = max(hi, l);
        }
        xj = xi;
        yj = yi;
      }
      end = min(hi, p.wi);
    }
    searches += ns;
    st.lap(kSearch);
    // the strip's cells: rows [r0, r1) of its runs; lanes over its columns
    // (a strip of w <= 16 columns: w lanes a row, 32 / w rows at a time),
    // neighbouring lanes on neighbouring cells of a row, 4 rows of loads in
    // flight per lane (more, or a larger register budget, measured slower)
    const int r0 = warp_min_i(lo < end ? lo : p.wi), r1 = warp_max_i(lo < end ? end : 0);
    int w = 32;
    while (w > 1 && (w >> 1) >= cols) w >>= 1;
    const int j = lane & (w - 1), step = 32 / w;
    const int run_lo = __shfl_sync(kFull, lo, j), run_end = __shfl_sync(kFull, end, j);
    const float* col = p.plane + (size_t)si * p.Wp + sj + cs + j;
    for (int r = r0 + lane / w; r < r1; r += 4 * step) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = r + u * step;
        // outside the run: NaN, which no reduction takes
        v[u] = rr >= run_lo && rr < run_end ? __ldg(col + (size_t)rr * p.Wp)
                                            : __int_as_float(0x7fc00000);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        f |= v[u] == -INFINITY;
        if (isfinite(v[u])) {
          ++cnt;
          acc += v[u];
        }
      }
    }
    st.lap(kSweep);
  }
  fail = __any_sync(kFull, f);
  n = warp_sum_i(cnt);
  sum = (float)warp_sum(acc);
  if (kCount) {
    searches = warp_sum_i(searches);
    if (lane == 0) {
      atomicAdd(&p.work[1], (unsigned long long)searches);
      atomicAdd(&p.work[2], (unsigned long long)(c1 - c0) * m);
    }
  }
  st.lap(kSweep);
}

// (ok, trav) of a ring from its reduction (_window_verdict)
__device__ __forceinline__ void verdict(const PolyParams& p, bool fail, int n, float sum, bool& ok,
                                        float& trav) {
  const bool empty = n == 0 && !fail;
  ok = !fail && (!empty || p.default_tv != 0.0f);
  const float mean = sum / (float)max(n, 1);
  trav = fail ? 0.0f : (empty ? p.default_tv : mean);
}

template <bool kGlobal, bool kCount, bool kStage>
__global__ void __launch_bounds__(kThreads, 4) poly_paths_kernel(const PolyParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Stages<kStage> st;
  if (kStage) {
    __shared__ unsigned long long stage_counters[POLY_WARPS][kStages];
    st.start(stage_counters[warp], lane);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int path = blockIdx.x / p.cluster;
  WarpPartial* const partials = reinterpret_cast<WarpPartial*>(smem);
  Ring0* const ring0 = reinterpret_cast<Ring0*>(partials + POLY_WARPS);
  // this block's slots: shared memory, or its slice of the global scratch
  float* const slots =
      kGlobal ? p.slots + (size_t)blockIdx.x * POLY_WARPS * POLY_SLOT_WORDS * p.cap
              : reinterpret_cast<float*>(smem + POLY_PARTIAL_BYTES);
  float* X = slots + (size_t)warp * POLY_SLOT_WORDS * p.cap;
  float* Y = X + p.cap;
  float* RX = Y + p.cap;
  float* RY = RX + p.cap;
  int* succ = reinterpret_cast<int*>(RY + p.cap);
  int* dup = succ + p.cap;
  const int S = p.N - 1;
  const int n_p = p.n_poses[path];

  float orient = 1.0f;
  if (p.translate_only) {
    float acc = 0.0f;
    for (int k = 0; k < p.V; ++k) {
      const int kn = k + 1 == p.V ? 0 : k + 1;
      acc += p.fp[2 * k] * p.fp[2 * kn + 1] - p.fp[2 * kn] * p.fp[2 * k + 1];
    }
    orient = acc < 0.0f ? -1.0f : 1.0f;
  }
  // the path's window (not in the block tier): centred on its poses' bbox
  int psi = 0, psj = 0;
  if (!p.use_blocks) {
    float mx = -INFINITY, my = -INFINITY, nx = INFINITY, ny = INFINITY;
    for (int t = lane; t < p.N; t += 32) {
      const float* ps = p.pos + ((size_t)path * p.N + t) * p.pos_d;
      mx = fmaxf(mx, ps[0]), nx = fminf(nx, ps[0]);
      my = fmaxf(my, ps[1]), ny = fminf(ny, ps[1]);
    }
    window_start(p, 0.5f * (warp_max(mx) + warp_min(nx)), 0.5f * (warp_max(my) + warp_min(ny)),
                 psi, psj);
  }

  // ring block k holds rings t = 8k .. 8k + 7 of the path: t < S segment t
  // (output ring t + 1), t == S the pose-0 footprint (output ring 0); this
  // block takes ring blocks rank, rank + cluster, ..., warp w ring t = 8k + w
  WarpPartial mine = {0.0, 0.0, 1};
  for (int k = rank; k < p.n_blocks; k += p.cluster) {
    const int t = k * POLY_WARPS + warp;
    int mh = 0;
    float w = 0.0f;
    st.lap(kOther);
    if (p.use_blocks) {
      __syncthreads();  // the previous ring block's slots are read by every warp
      st.lap(kBarrier);
    }
    if (t < S) {
      w = segment_ring<kCount>(p, path, t, orient, X, Y, RX, RY, succ, dup, lane, mh, st);
    } else if (t == S) {
      for (int v = lane; v < p.V; v += 32) transform(p, path, 0, v, RX[v], RY[v]);
      __syncwarp();
      st.lap(kTransform);
      mh = p.V;
      w = ring_area(RX, RY, mh, lane);
      st.lap(kRingArea);
    }
    int si = psi, sj = psj;
    if (p.use_blocks) {
      __syncthreads();
      st.lap(kBarrier);
      if (t < S) {
        // the ring block's anchor: the bbox centre of its segments' rings (a
        // ring fills its slot: cap == mh)
        const int nb = min(POLY_WARPS, S - k * POLY_WARPS);
        float mx = -INFINITY, my = -INFINITY, nx = INFINITY, ny = INFINITY;
        for (int q = lane; q < nb * p.cap; q += 32) {
          const float* slot = slots + (size_t)(q / p.cap) * POLY_SLOT_WORDS * p.cap;
          const float x = slot[2 * p.cap + q % p.cap], y = slot[3 * p.cap + q % p.cap];
          mx = fmaxf(mx, x), nx = fminf(nx, x);
          my = fmaxf(my, y), ny = fminf(ny, y);
        }
        window_start(p, 0.5f * (warp_max(mx) + warp_min(nx)),
                     0.5f * (warp_max(my) + warp_min(ny)), si, sj);
      } else if (t == S) {
        bbox_window(p, RX, RY, mh, lane, si, sj);  // the footprint's own window
      }
    }
    if (t <= S) {
      st.lap(kOther);
      bool fail, ok;
      int n;
      float sum, trav;
      rasterise<kCount>(p, RX, RY, mh, si, sj, lane, fail, n, sum, st);
      const int u = t < S ? t + 1 : 0;
      if (lane == 0) {
        const size_t i = (size_t)path * p.N + u;
        p.u_fail[i] = fail;
        p.u_n[i] = n;
        p.u_sum[i] = sum;
        p.u_area[i] = w;
      }
      verdict(p, fail, n, sum, ok, trav);
      if (t < S) {
        // _aggregate_polygonal_path's terms of segment t
        const bool valid = t + 1 < n_p;
        mine.ok &= ok || !valid;
        const float wv = valid ? w : 0.0f;
        mine.total += wv;
        mine.weighted += wv * trav;
      } else if (lane == 0) {
        *ring0 = {ok, trav, w};
      }
      st.lap(kAggregate);
    }
  }
  if (lane == 0) partials[warp] = mine;
  st.lap(kAggregate);
  cluster.sync();  // every warp's partial and ring 0 are written
  st.lap(kBarrier);

  // the path's verdict (_aggregate_polygonal_path): warp 0 of the leader
  // sums the cluster's warp partials, lane l those of partials l, l + 32,
  // then a butterfly: a fixed order
  if (rank == 0 && warp == 0) {
    double total = 0.0, weighted = 0.0;
    int all_ok = 1;
    for (int q = lane; q < p.cluster * POLY_WARPS; q += 32) {
      const WarpPartial r = cluster.map_shared_rank(partials, q / POLY_WARPS)[q % POLY_WARPS];
      total += r.total, weighted += r.weighted, all_ok &= r.ok;
    }
    total = warp_sum(total), weighted = warp_sum(weighted);
    const bool multi_ok = __all_sync(kFull, all_ok);
    const Ring0 r0 = *cluster.map_shared_rank(ring0, (S / POLY_WARPS) % p.cluster);
    if (lane == 0) {
      const bool ok1 = r0.ok;
      const float trav1 = r0.trav, area1 = r0.area;
      bool safe;
      float trav, area;
      if (p.N == 1) {
        safe = ok1 && n_p >= 1;
        trav = ok1 ? trav1 : 0.0f;
        area = ok1 ? area1 : 0.0f;
      } else {
        const float total_f = (float)total;
        const float trav_multi = (float)weighted / (total_f != 0.0f ? total_f : 1.0f);
        const bool single = n_p == 1;
        safe = (single ? ok1 : multi_ok) && n_p >= 1;
        trav = single ? (ok1 ? trav1 : 0.0f) : trav_multi;
        area = single ? (ok1 ? area1 : 0.0f) : total_f;
        trav = safe ? trav : 0.0f;
        area = (safe || single) ? area : 0.0f;
      }
      p.safe[path] = safe;
      p.trav[path] = trav;
      p.area[path] = area;
    }
  }
  st.lap(kAggregate);
  cluster.sync();  // no block leaves while the leader reads its shared memory
  st.lap(kBarrier);
  st.flush(p.stage);
}

// dynamic shared memory of a block: the partials, and the slots unless
// they are global
static size_t smem_bytes(int cap, bool global_slots) {
  return POLY_PARTIAL_BYTES +
         (global_slots ? 0 : (size_t)POLY_WARPS * POLY_SLOT_WORDS * 4 * cap);
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int bit_length(int x) {
  int b = 0;
  while (x) ++b, x >>= 1;
  return b;
}

extern "C" {

const char* te_poly_paths_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Resident blocks per SM for a launch with this shared memory and slot
// space, or -1.
int te_poly_paths_occupancy(int smem, int global_slots) {
  int blocks = -1;
  const auto kernel = global_slots ? poly_paths_kernel<true, false, false>
                                   : poly_paths_kernel<false, false, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return e == cudaSuccess ? blocks : -1;
}

// pos (P, N, pos_d) f32, quat (P, N, 4) f32, n_poses (P,) i32, fp (V, 2) f32,
// plane (Hp, Wp) f32 = (H + 2 gpad, W + 2 gpad), p0 (2,) f32; outputs safe
// (P,) u8, trav (P,) f32, area (P,) f32 and the per-ring u_fail (P, N) u8,
// u_n (P, N) i32, u_sum and u_area (P, N) f32; all device pointers, all
// contiguous. (wi, wj): the window (the block window in the block tier),
// n_bits the search's rounds, cap the points of one warp's slot.
// grid_x, cluster_x, block_x, smem: the launch plan (cluster_x blocks per
// path, a cluster each, at most one per ring block), launched as given once
// it is checked against this file's block, cluster and slot layout
// (cudaErrorInvalidValue where they differ): smem holds the partials and
// the slots, or `slots` (grid_x x POLY_WARPS x POLY_SLOT_WORDS x cap f32)
// holds the slots. `work`: null, or three u64 counters the
// launch adds its hull point tests, binary searches and straddle tests to;
// `stage`: null, or kStages u64 counters it adds each stage's warp cycles to
// (not both). Returns cudaGetLastError() after the launch.
int te_poly_paths(const float* pos, const float* quat, const int* n_poses, const float* fp,
                  const float* plane, const float* p0, int P, int N, int pos_d, int V, int H,
                  int W, int gpad, int wi, int wj, int n_bits, int cap, float res, float res_rcp,
                  float default_tv, int conservative, int translate_only, int use_blocks,
                  int grid_x, int cluster_x, int block_x, int smem, float* slots, uint8_t* safe,
                  float* trav, float* area, uint8_t* u_fail, int* u_n, float* u_sum,
                  float* u_area, unsigned long long* work, unsigned long long* stage,
                  void* stream) {
  const int m = (conservative ? 4 : 2) * V;
  const int n_blocks = (N + POLY_WARPS - 1) / POLY_WARPS;
  if (P < 1 || N < 1 || pos_d < 2 || V < 1 || wi < 1 || wj < 1 || gpad < wi || gpad < wj ||
      H < 0 || W < 0 || (work && stage) || n_bits != (wi > 1 ? bit_length(wi) : 1) || cap != m ||
      cluster_x < 1 || cluster_x > min(n_blocks, POLY_CLUSTER) || grid_x != P * cluster_x ||
      block_x != kThreads || (size_t)smem != smem_bytes(cap, slots != nullptr))
    return (int)cudaErrorInvalidValue;
  PolyParams prm;
  prm.pos = pos, prm.quat = quat, prm.n_poses = n_poses, prm.fp = fp, prm.plane = plane;
  prm.p0 = p0;
  prm.N = N, prm.pos_d = pos_d, prm.V = V, prm.H = H, prm.W = W;
  prm.Wp = W + 2 * gpad, prm.gpad = gpad;
  prm.wi = wi, prm.wj = wj, prm.n_bits = n_bits, prm.cap = cap;
  prm.cluster = cluster_x, prm.n_blocks = n_blocks;
  prm.res = res, prm.res_rcp = res_rcp, prm.default_tv = default_tv;
  prm.conservative = conservative, prm.translate_only = translate_only;
  prm.use_blocks = use_blocks;
  prm.slots = slots, prm.work = work, prm.stage = stage;
  prm.safe = safe, prm.trav = trav, prm.area = area;
  prm.u_fail = u_fail, prm.u_n = u_n, prm.u_sum = u_sum, prm.u_area = u_area;
  const auto kernel =
      slots ? (work    ? poly_paths_kernel<true, true, false>
               : stage ? poly_paths_kernel<true, false, true>
                       : poly_paths_kernel<true, false, false>)
            : (work    ? poly_paths_kernel<false, true, false>
               : stage ? poly_paths_kernel<false, false, true>
                       : poly_paths_kernel<false, false, false>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x);
  cfg.blockDim = dim3(block_x);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&prm};
  e = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
