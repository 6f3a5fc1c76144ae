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
// and round once, so they carry less rounding than the plain version's
// float32 sums, whose order differs anyway. Counts and verdicts are exact.
//
// What bounds it on the H100: issued instructions and load latency, not
// bytes (a batch reads ~1 MB of plane and ~6 MB of poses) nor float rate.
// The design keeps everything but the plane on chip:
//   - one block of 8 warps per path (8 == SEG_BLOCK): each warp takes one
//     ring at a time (the pose-0 footprint or one segment's hull), builds it
//     in its own slot, rasterises it and writes its four per-ring numbers;
//     in the block tier the 8 warps build one block's 8 rings, meet at a
//     barrier, and each reads all 8 for the block's anchor;
//   - a slot is shared memory; a footprint whose slots exceed it (more than
//     302 vertices conservative, 605 plain) takes its slots from a global
//     scratch of one slice per block instead: the same code, compiled for
//     either space (kGlobal), so that shared slots keep their shared-memory
//     loads; so too the work counters of the bound (kCount), off in use;
//   - lanes run over window columns, so one row of a run is one coalesced
//     read of neighbouring plane cells (through L1/L2: the plane is not
//     staged, windows may hold millions of cells);
//   - the hull's O(M^3) test exits at the first point outside an edge, and
//     a successor is an atomicMin over the valid edges of a vertex;
//   - row coordinates are recomputed per probe (one FMA) instead of kept.
// The launch geometry is computed on the host by
// ops/poly_kernel.py::launch_plan and checked here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define POLY_WARPS 8  // == ops/footprint.py::SEG_BLOCK
#define POLY_SLOT_WORDS 6  // per ring point: x, y, ring x, ring y, successor, duplicate

constexpr int kThreads = POLY_WARPS * 32;
constexpr unsigned kFull = 0xffffffffu;

struct PolyParams {
  const float* pos;      // (P, N, pos_d)
  const float* quat;     // (P, N, 4) xyzw
  const int* n_poses;    // (P,)
  const float* fp;       // (V, 2)
  const float* plane;    // (H + 2 gpad, Wp = W + 2 gpad) packed query plane, ring of +inf
  const float* p0;       // (2,) map origin P0
  int N, pos_d, V, H, W, Wp, gpad, wi, wj, n_bits, cap;
  float res, res_rcp, default_tv;
  int conservative, translate_only, use_blocks;
  float* slots;  // (P, POLY_WARPS, POLY_SLOT_WORDS, cap) global slots, or null: shared memory
  unsigned long long* work;  // null, or [hull point tests, searches] added up
  uint8_t* safe;
  float* trav;
  float* area;
  // per ring (P, N): ring 0 the pose-0 footprint, ring u > 0 segment u - 1
  uint8_t* u_fail;
  int* u_n;
  float* u_sum;
  float* u_area;  // ring 0: its area; ring u > 0: the segment's area weight
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ unsigned long long warp_sum_u64(unsigned long long v) {
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
template <bool kCount>
__device__ void hull_ring(const float* X, const float* Y, int m, int* succ, int* dup, float* RX,
                          float* RY, int lane, unsigned long long* work) {
  for (int a = lane; a < m; a += 32) {
    int d = 0;
    for (int b = 0; b < a; ++b) d |= (X[a] == X[b]) & (Y[a] == Y[b]);
    dup[a] = d;
    succ[a] = m;
  }
  __syncwarp();
  unsigned long long tests = 0;
  for (int q = lane; q < m * m; q += 32) {
    const int i = q / m, j = q - i * m;
    if (dup[i] | dup[j] | ((X[i] == X[j]) & (Y[i] == Y[j]))) continue;
    const float xi = X[i], yi = Y[i];
    const float jx = X[j] - xi, jy = Y[j] - yi;
    const float len2 = __fmaf_rn(jx, jx, jy * jy);
    bool ok = true;
    for (int k = 0; k < m && ok; ++k) {
      ++tests;
      const float kx = X[k] - xi, ky = Y[k] - yi;
      const float cross = __fmaf_rn(jx, ky, -(jy * kx));
      const float dot = __fmaf_rn(jx, kx, jy * ky);
      const float k_len2 = __fmaf_rn(kx, kx, ky * ky);
      const float eps = 3e-6f * __fsqrt_rn(len2 * k_len2) + 1e-30f;
      const bool left = cross > eps;
      const bool between = (fabsf(cross) <= eps) & (dot >= -eps) & (dot <= len2 + eps);
      ok = left | between;
    }
    if (ok) atomicMin(&succ[i], j);
  }
  if (kCount) {
    tests = warp_sum_u64(tests);
    if (lane == 0) atomicAdd(&work[0], tests);
  }
  __syncwarp();
  if (lane == 0) {
    int start = 0;
    for (int i = 0; i < m; ++i)
      if (succ[i] < m) {
        start = i;
        break;
      }
    // the walk from the first hull vertex; from its first return on, the
    // padding repeats that vertex
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
}

// The ring of segment s of `path` into the warp's slot (RX, RY: `mh`
// entries); returns its area weight (hull area, less polygon1's after the
// first segment).
template <bool kCount>
__device__ float segment_ring(const PolyParams& p, int path, int s, float orient, float* X,
                              float* Y, float* RX, float* RY, int* succ, int* dup, int lane,
                              int& mh) {
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
  } else {
    hull_ring<kCount>(X, Y, mh, succ, dup, RX, RY, lane, p.work);
  }
  const float hull_area = ring_area(RX, RY, mh, lane);
  if (s == 0) return hull_area;
  return hull_area - ring_area(X, Y, mv, lane);
}

// fail / count / sum of the cells inside the convex ring (RX, RY: m
// entries, closed by wrap) in the window at (si, sj), by one warp (the
// span rule of seg_block); kCount: its binary searches are added to work[1]
template <bool kCount>
__device__ void rasterise(const PolyParams& p, const float* RX, const float* RY, int m, int si,
                          int sj, int lane, bool& fail, int& n, float& sum) {
  const float p0x = p.p0[0], p0y = p.p0[1];
  const int gi0 = si - p.gpad, gj0 = sj - p.gpad;
  bool f = false;
  int cnt = 0, searches = 0;
  double acc = 0.0;
  for (int c = lane; c < p.wj; c += 32) {
    const float py = cell_coord(p0y, gj0 + c, p.res);
    int lo = p.wi + 1, hi = -1;
    float xj = RX[m - 1], yj = RY[m - 1];  // the previous vertex of vertex 0
    for (int e = 0; e < m; ++e) {
      const float xi = RX[e], yi = RY[e];
      if ((yi > py) != (yj > py)) {
        const float denom = yj - yi;
        const float sg = denom > 0.0f ? 1.0f : -1.0f;
        const float d_abs = denom * sg;
        const float rhs = ((xj - xi) * (py - yi)) * sg;
        ++searches;
        int l = 0, h = p.wi;
        for (int b = 0; b < p.n_bits; ++b) {
          const int mid = (l + h) >> 1;
          const bool comp = (cell_coord(p0x, gi0 + mid, p.res) - xi) * d_abs < rhs;
          l = comp ? l : mid + 1;
          h = comp ? mid : h;
        }
        lo = min(lo, l);
        hi = max(hi, l);
      }
      xj = xi;
      yj = yi;
    }
    const float* col = p.plane + (size_t)si * p.Wp + sj + c;
    const int end = min(hi, p.wi);
    for (int r = lo; r < end; ++r) {
      const float v = col[(size_t)r * p.Wp];
      f |= v == -INFINITY;
      if (isfinite(v)) {
        ++cnt;
        acc += v;
      }
    }
  }
  fail = __any_sync(kFull, f);
  n = warp_sum_i(cnt);
  sum = (float)warp_sum(acc);
  if (kCount) {
    searches = warp_sum_i(searches);
    if (lane == 0) atomicAdd(&p.work[1], (unsigned long long)searches);
  }
}

__device__ __forceinline__ void store_ring(const PolyParams& p, int path, int u, bool fail, int n,
                                           float sum, float area, int lane) {
  if (lane == 0) {
    const size_t i = (size_t)path * p.N + u;
    p.u_fail[i] = fail;
    p.u_n[i] = n;
    p.u_sum[i] = sum;
    p.u_area[i] = area;
  }
}

// (ok, trav) of a ring from its reduction (_window_verdict)
__device__ __forceinline__ void verdict(const PolyParams& p, bool fail, int n, float sum, bool& ok,
                                        float& trav) {
  const bool empty = n == 0 && !fail;
  ok = !fail && (!empty || p.default_tv != 0.0f);
  const float mean = sum / (float)max(n, 1);
  trav = fail ? 0.0f : (empty ? p.default_tv : mean);
}

template <bool kGlobal, bool kCount>
__global__ void __launch_bounds__(kThreads) poly_paths_kernel(const PolyParams p) {
  extern __shared__ float smem[];
  const int path = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's slots: shared memory, or its slice of the global scratch
  float* const slots =
      kGlobal ? p.slots + (size_t)path * POLY_WARPS * POLY_SLOT_WORDS * p.cap : smem;
  float* X = slots + (size_t)warp * POLY_SLOT_WORDS * p.cap;
  float* Y = X + p.cap;
  float* RX = Y + p.cap;
  float* RY = RX + p.cap;
  int* succ = reinterpret_cast<int*>(RY + p.cap);
  int* dup = succ + p.cap;
  const int S = p.N - 1;

  float orient = 1.0f;
  if (p.translate_only) {
    float acc = 0.0f;
    for (int k = 0; k < p.V; ++k) {
      const int kn = k + 1 == p.V ? 0 : k + 1;
      acc += p.fp[2 * k] * p.fp[2 * kn + 1] - p.fp[2 * kn] * p.fp[2 * k + 1];
    }
    orient = acc < 0.0f ? -1.0f : 1.0f;
  }

  // the pose-0 footprint ring: in the block tier warp 0 rasterises it in
  // its own window (the footprint's bbox centre), else it is ring 0 of the
  // path's window
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
  auto pose0 = [&]() {
    for (int v = lane; v < p.V; v += 32) transform(p, path, 0, v, RX[v], RY[v]);
    __syncwarp();
    int si = psi, sj = psj;
    if (p.use_blocks) {
      float mx = -INFINITY, my = -INFINITY, nx = INFINITY, ny = INFINITY;
      for (int v = lane; v < p.V; v += 32) {
        mx = fmaxf(mx, RX[v]), nx = fminf(nx, RX[v]);
        my = fmaxf(my, RY[v]), ny = fminf(ny, RY[v]);
      }
      window_start(p, 0.5f * (warp_max(mx) + warp_min(nx)), 0.5f * (warp_max(my) + warp_min(ny)),
                   si, sj);
    }
    bool fail;
    int n;
    float sum;
    rasterise<kCount>(p, RX, RY, p.V, si, sj, lane, fail, n, sum);
    store_ring(p, path, 0, fail, n, sum, ring_area(RX, RY, p.V, lane), lane);
    __syncwarp();
  };

  if (!p.use_blocks) {
    for (int u = warp; u < p.N; u += POLY_WARPS) {
      if (u == 0) {
        pose0();
        continue;
      }
      int mh;
      const float w = segment_ring<kCount>(p, path, u - 1, orient, X, Y, RX, RY, succ, dup, lane, mh);
      bool fail;
      int n;
      float sum;
      rasterise<kCount>(p, RX, RY, mh, psi, psj, lane, fail, n, sum);
      store_ring(p, path, u, fail, n, sum, w, lane);
      __syncwarp();
    }
  } else {
    if (warp == 0) pose0();
    for (int b0 = 0; b0 < S; b0 += POLY_WARPS) {
      const int s = b0 + warp, nb = min(POLY_WARPS, S - b0);
      int mh = 0;
      float w = 0.0f;
      __syncthreads();  // the previous block's rings are read by every warp
      if (s < S) w = segment_ring<kCount>(p, path, s, orient, X, Y, RX, RY, succ, dup, lane, mh);
      __syncthreads();
      // the block's anchor: the bbox centre of its rings (a ring fills its
      // slot: cap == mh)
      float mx = -INFINITY, my = -INFINITY, nx = INFINITY, ny = INFINITY;
      for (int q = lane; q < nb * p.cap; q += 32) {
        const float* slot = slots + (size_t)(q / p.cap) * POLY_SLOT_WORDS * p.cap;
        const float x = slot[2 * p.cap + q % p.cap], y = slot[3 * p.cap + q % p.cap];
        mx = fmaxf(mx, x), nx = fminf(nx, x);
        my = fmaxf(my, y), ny = fminf(ny, y);
      }
      int si, sj;
      window_start(p, 0.5f * (warp_max(mx) + warp_min(nx)), 0.5f * (warp_max(my) + warp_min(ny)),
                   si, sj);
      if (s < S) {
        bool fail;
        int n;
        float sum;
        rasterise<kCount>(p, RX, RY, mh, si, sj, lane, fail, n, sum);
        store_ring(p, path, s + 1, fail, n, sum, w, lane);
      }
    }
  }
  __syncthreads();

  // the path's verdict (_aggregate_polygonal_path), in segment order
  if (threadIdx.x == 0) {
    const size_t base = (size_t)path * p.N;
    const int n_p = p.n_poses[path];
    bool ok1;
    float trav1;
    verdict(p, p.u_fail[base], p.u_n[base], p.u_sum[base], ok1, trav1);
    const float area1 = p.u_area[base];
    bool safe;
    float trav, area;
    if (p.N == 1) {
      safe = ok1 && n_p >= 1;
      trav = ok1 ? trav1 : 0.0f;
      area = ok1 ? area1 : 0.0f;
    } else {
      bool multi_ok = true;
      double total = 0.0, weighted = 0.0;
      for (int s = 0; s < S; ++s) {
        const bool valid = s + 1 < n_p;
        bool ok_s;
        float trav_s;
        verdict(p, p.u_fail[base + s + 1], p.u_n[base + s + 1], p.u_sum[base + s + 1], ok_s,
                trav_s);
        multi_ok &= ok_s || !valid;
        const float w = valid ? p.u_area[base + s + 1] : 0.0f;
        total += w;
        weighted += w * trav_s;
      }
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

static size_t smem_bytes(int cap) { return (size_t)POLY_WARPS * POLY_SLOT_WORDS * 4 * cap; }

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

// Resident blocks per SM for a launch with this shared memory, or -1.
int te_poly_paths_occupancy(int smem) {
  int blocks = -1;
  const auto kernel = smem ? poly_paths_kernel<false, false> : poly_paths_kernel<true, false>;
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
// grid_x, block_x, smem: the launch plan, launched as given once it is
// checked against this file's block and slot layout (cudaErrorInvalidValue
// where they differ): smem holds the slots, or is 0 and `slots` (P x
// POLY_WARPS x POLY_SLOT_WORDS x cap f32) does. `work`: null, or two u64
// counters the launch adds its hull point tests and binary searches to.
// Returns cudaGetLastError() after the launch.
int te_poly_paths(const float* pos, const float* quat, const int* n_poses, const float* fp,
                  const float* plane, const float* p0, int P, int N, int pos_d, int V, int H,
                  int W, int gpad, int wi, int wj, int n_bits, int cap, float res, float res_rcp,
                  float default_tv, int conservative, int translate_only, int use_blocks,
                  int grid_x, int block_x, int smem, float* slots, uint8_t* safe, float* trav,
                  float* area, uint8_t* u_fail, int* u_n, float* u_sum, float* u_area,
                  unsigned long long* work, void* stream) {
  const int m = (conservative ? 4 : 2) * V;
  if (P < 1 || N < 1 || pos_d < 2 || V < 1 || wi < 1 || wj < 1 || gpad < wi || gpad < wj ||
      H < 0 || W < 0 || n_bits != (wi > 1 ? bit_length(wi) : 1) || cap != m || grid_x != P ||
      block_x != kThreads || (size_t)smem != (slots ? 0 : smem_bytes(cap)))
    return (int)cudaErrorInvalidValue;
  PolyParams prm;
  prm.pos = pos, prm.quat = quat, prm.n_poses = n_poses, prm.fp = fp, prm.plane = plane;
  prm.p0 = p0;
  prm.N = N, prm.pos_d = pos_d, prm.V = V, prm.H = H, prm.W = W;
  prm.Wp = W + 2 * gpad, prm.gpad = gpad;
  prm.wi = wi, prm.wj = wj, prm.n_bits = n_bits, prm.cap = cap;
  prm.res = res, prm.res_rcp = res_rcp, prm.default_tv = default_tv;
  prm.conservative = conservative, prm.translate_only = translate_only;
  prm.use_blocks = use_blocks;
  prm.slots = slots, prm.work = work;
  prm.safe = safe, prm.trav = trav, prm.area = area;
  prm.u_fail = u_fail, prm.u_n = u_n, prm.u_sum = u_sum, prm.u_area = u_area;
  const auto kernel = slots ? (work ? poly_paths_kernel<true, true> : poly_paths_kernel<true, false>)
                            : (work ? poly_paths_kernel<false, true> : poly_paths_kernel<false, false>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&prm};
  e = cudaLaunchKernel((const void*)kernel, dim3(grid_x), dim3(block_x), args, smem,
                       (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
