// Circular path batch: check_circular_paths' samples, lookups and
// aggregation for every path of a batch, and check_circles' spiral for its
// single-pose paths, in one launch.
//
// Not the port of a TPU kernel: the JAX package computes the batch as
// XLA-fused jnp (traversability_estimation_tpu/ops/footprint.py:378). Plain
// version: ops/footprint.py::check_circular_paths_plain. Built with
// -fmad=false, so every float32 operation is the plain version's; its
// verdicts are exact, a single-pose path's traversability is bit for bit
// check_circles', and a multi-pose path's sums run in another order.
//
// What bounds it on the H100: neither bytes nor operations. At the main
// path's 1024 paths x 50 poses it reads ~0.4 MB of poses and 5 bytes of
// field per sample (~0.5 MB) and does ~2e6 float32 operations, a bound of
// ~0.2 us, below the time of any launch. What it costs a caller is the host
// work around the launch, so the design takes that work in:
//   - no sample cap from the host: a segment takes its own samples k = 0,
//     4, 8, ... <= denom (its cells), so a caller needs no pass over the
//     poses to size a static walk. A cap S remains for a caller that passes
//     max_segment_cells (S = INT_MAX: none);
//   - one warp per path, 4 paths a block; a block's 4 x N poses are
//     contiguous, and a bulk asynchronous copy (cp.async.bulk, completion
//     on an mbarrier) brings them into shared memory, where each pose's cell
//     is computed once (a segment's two ends are shared with its
//     neighbours). One copy a stage: a stage holds kStagePoses segment
//     starts (4 paths of 512 poses) and the pose after them, 32 KB with
//     their cells, within the 48 KB a launch has without opting in, so the
//     main path's 4 x 50 take one; longer paths take the stages in turn, a
//     lane's segments still in order;
//   - a sample's cell comes from the Bresenham closed form over(k) =
//     (denom / 2 + k * num_add) / max(denom, 1) (grid_map's LineIterator,
//     walked from the segment's END to its START as the reference walks
//     it), so a lane computes only its stride-4 samples, never the line;
//     each reads the field's ok byte and trav float and rounds them through
//     the plain version's packed encoding (ok ? trav : -1 - trav);
//   - a lane sums its segments in order, the warp combines the lanes with
//     a fixed shuffle tree: no float atomics, two launches give the same
//     bits;
//   - a path of one pose (or every path of a one-pose batch) is
//     check_circles at its sub-cell pose, evaluated by its warp: 32 spiral
//     offsets at a time from a cached device table (offset, radius, outer
//     ring flag), the outer two rings' distance re-check against the pose,
//     the first failure by a ballot, and the sums in the pairwise order of
//     _prefix_sum (jax.lax.associative_scan's): the prefix of c elements is
//     the left-to-right sum of the perfect-tree sums of the aligned blocks
//     of c's binary digits, largest first. A chunk of 32 gives its blocks
//     up to 32 by a shuffle tree; whole chunks merge as a binary counter
//     held one level per lane. The walk stops at the chunk of the first
//     failure: the sums before it are all the verdict needs.
// The launch geometry (grid, block, shared memory) is computed on the host
// by ops/circ_kernel.py::launch_plan and checked here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CIRC_WARPS 4

constexpr int kThreads = 32 * CIRC_WARPS;
constexpr unsigned kFull = 0xffffffffu;
// segment starts a stage of the block's poses holds; with the pose after
// the last and every pose's cell, 16 bytes a pose: 32 KB
constexpr int kStagePoses = 4 * 512;

struct CircParams {
  const float* poses;        // (P, N, 2)
  const int* n_poses;        // (P,)
  const float* position;     // (2,) the query state's map centre
  const uint8_t* field_ok;   // (H, W), or null when N == 1
  const float* field_trav;   // (H, W), or null when N == 1
  const float* trav_plane;   // (H, ld_trav) the state's traversability
  const uint8_t* mask_plane;  // (H, ld_mask) the state's traversable_mask
  const int2* spiral;        // (K,) offsets (an int16 pair), radius bits (< 0: outer ring)
  int P, N, H, W, S, K, ld_trav, ld_mask, single, rmin_zero;
  float res, res_rcp, fill, default_trav, r2max, rmin, span_rcp;
  uint8_t* safe;  // (P,)
  float* trav;    // (P,)
};

// The cell index of a coordinate below the origin p0: floor((p0 - x) *
// rcp(res)), as ops/footprint.py::index_from_origin rounds it.
__device__ __forceinline__ int cell_of(float p0, float x, float res_rcp) {
  return (int)floorf(__fmul_rn(__fsub_rn(p0, x), res_rcp));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// check_circles at the sub-cell pose (px, py) of cell (ci0, cj0), by one
// warp; every lane returns the verdict.
__device__ __forceinline__ void single_pose(const CircParams& q, float p0x, float p0y, float px,
                                            float py, int ci0, int cj0, bool* ok_out,
                                            float* trav_out) {
  const int lane = threadIdx.x & 31;
  // a pose off the map: the default verdict (_is_inside)
  const float tx = __fsub_rn(p0x, px), ty = __fsub_rn(p0y, py);
  const float len_x = __fmul_rn((float)q.H, q.res), len_y = __fmul_rn((float)q.W, q.res);
  if (!(tx >= 0.0f && tx < len_x && ty >= 0.0f && ty < len_y)) {
    *ok_out = q.default_trav != 0.0f;
    *trav_out = q.default_trav;
    return;
  }
  float level = 0.0f;  // lane a: the pending block of 32 * 2^a elements
  unsigned chunks = 0;  // whole chunks merged so far (the counter's bits)
  int count = 0;        // passing cells of the prefix
  int first_fail = -1;
  int rest = 0;         // elements of a last, partial chunk
  float part[6];        // this lane's level sums of its chunk
  for (int base = 0; base < q.K; base += 32) {
    const int k = base + lane;
    bool fail = false, pass = false;
    float v = 0.0f;
    if (k < q.K) {
      const int2 e = q.spiral[k];
      const int ci = ci0 + (e.x >> 16), cj = cj0 + (int)(short)(e.x & 0xffff);
      bool active = ci >= 0 && ci < q.H && cj >= 0 && cj < q.W;
      if (active && e.y < 0) {
        // the outer two rings: the cell centre's distance to the pose,
        // p0 - (g + 0.5) * res as one FMA, then fma(dy, dy, dx * dx)
        const float gx = __fmaf_rn(-__fadd_rn((float)ci, 0.5f), q.res, p0x);
        const float gy = __fmaf_rn(-__fadd_rn((float)cj, 0.5f), q.res, p0y);
        const float dx = __fsub_rn(gx, px), dy = __fsub_rn(gy, py);
        active = __fmaf_rn(dy, dy, __fmul_rn(dx, dx)) <= q.r2max;
      }
      if (active) {
        const float t = q.trav_plane[(size_t)ci * q.ld_trav + cj];
        const float tvf = isfinite(t) ? t : q.default_trav;
        v = q.mask_plane[(size_t)ci * q.ld_mask + cj] ? tvf : __fsub_rn(-1.0f, tvf);
        pass = v >= 0.0f;
        fail = !pass;
        v = pass ? v : 0.0f;
      }
    }
    const unsigned fails = __ballot_sync(kFull, fail);
    int take = min(32, q.K - base);  // this chunk's elements in the prefix
    if (fails) {
      first_fail = base + __ffs(fails) - 1;
      take = first_fail - base + 1;
    }
    const unsigned taken = take == 32 ? kFull : (1u << take) - 1u;
    count += __popc(__ballot_sync(kFull, pass) & taken);
    // perfect-tree sums of the aligned blocks of 1, 2, ..., 32 elements
    part[0] = v;
#pragma unroll
    for (int l = 1; l < 6; ++l)
      part[l] = __fadd_rn(part[l - 1], __shfl_down_sync(kFull, part[l - 1], 1 << (l - 1)));
    if (take == 32) {
      // a whole chunk: carry it up the counter, merging equal blocks
      float carry = __shfl_sync(kFull, part[5], 0);
      int a = 0;
      while ((chunks >> a) & 1u) {
        carry = __fadd_rn(__shfl_sync(kFull, level, a), carry);
        ++a;
      }
      if (lane == a) level = carry;
      ++chunks;
    } else {
      rest = take;
    }
    if (fails || take < 32) break;
  }
  // the prefix: the counter's blocks from the largest, then the partial
  // chunk's from the largest, added left to right
  float sum = 0.0f;
  bool started = false;
  for (int a = 31; a >= 0; --a) {
    if (!((chunks >> a) & 1u)) continue;
    const float b = __shfl_sync(kFull, level, a);
    sum = started ? __fadd_rn(sum, b) : b;
    started = true;
  }
  int off = 0;
#pragma unroll
  for (int l = 5; l >= 0; --l) {
    if (!((rest >> l) & 1)) continue;
    const float b = __shfl_sync(kFull, part[l], off);
    sum = started ? __fadd_rn(sum, b) : b;
    started = true;
    off += 1 << l;
  }
  const float mean = __fdiv_rn(sum, fmaxf((float)count, 1.0f));
  const bool any_fail = first_fail >= 0;
  if (q.rmin_zero) {
    *ok_out = !any_fail;
    *trav_out = any_fail ? 0.0f : mean;
    return;
  }
  const float r_fail = any_fail ? fabsf(__int_as_float(q.spiral[first_fail].y)) : 0.0f;
  const bool hard = any_fail && r_fail <= q.rmin;
  const bool inflate = any_fail && r_fail > q.rmin;
  // _inflation_factor: fma(r_fail - rmin, rcp(rmax - rmin), 1) * 0.5
  const float factor = __fmul_rn(__fmaf_rn(__fsub_rn(r_fail, q.rmin), q.span_rcp, 1.0f), 0.5f);
  *ok_out = !hard;
  *trav_out = inflate ? __fmul_rn(mean, factor) : (hard ? 0.0f : mean);
}

// One segment of a path, poses s -> e with cells cs -> ce: its samples'
// verdict and mean (the walk from the END cell to the START cell, as the
// reference walks it), added to the lane's sums in order.
__device__ __forceinline__ void walk_segment(const CircParams& q, float2 s, float2 e, int2 cs,
                                             int2 ce, bool& all_ok, float& sum_len,
                                             float& sum_wt, float& sum_t, float& cnt) {
  const int fi = ce.x, fj = ce.y, li = cs.x, lj = cs.y;
  const int di = abs(li - fi), dj = abs(lj - fj);
  const int si = li >= fi ? 1 : -1, sj = lj >= fj ? 1 : -1;
  const bool x_dom = di >= dj;
  const int denom = x_dom ? di : dj, num_add = x_dom ? dj : di;
  const int half = denom / 2, safe_denom = max(denom, 1);
  bool seg_ok = true;
  int n_s = 0;
  float acc = 0.0f;
  // samples k = 0, 4, 8, ... of the denom + 1 cells (at most S of them)
  for (int t = 0; t < q.S && 4 * t <= denom; ++t) {
    const int k = 4 * t;
    const int over = k == 0 ? 0 : (half + k * num_add) / safe_denom;
    const int ci = fi + si * (x_dom ? k : over);
    const int cj = fj + sj * (x_dom ? over : k);
    float v = q.fill;
    if (ci >= 0 && ci < q.H && cj >= 0 && cj < q.W) {
      const size_t g = (size_t)ci * q.W + cj;
      const float tv = q.field_trav[g];
      v = q.field_ok[g] ? tv : __fsub_rn(-1.0f, tv);
    }
    const bool ok_s = v >= 0.0f;
    seg_ok = seg_ok && ok_s;
    acc = __fadd_rn(acc, ok_s ? v : __fsub_rn(-1.0f, v));
    ++n_s;
  }
  const float seg_trav = __fdiv_rn(acc, (float)max(n_s, 1));
  const float dx = __fsub_rn(e.x, s.x), dy = __fsub_rn(e.y, s.y);
  const float len = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  all_ok = all_ok && seg_ok;
  sum_len = __fadd_rn(sum_len, len);
  sum_wt = __fadd_rn(sum_wt, __fmul_rn(len, seg_trav));
  sum_t = __fadd_rn(sum_t, seg_trav);
  cnt = __fadd_rn(cnt, 1.0f);
}

__global__ void __launch_bounds__(kThreads) circ_paths_kernel(const CircParams q) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * CIRC_WARPS;
  const int p = first + warp;
  const bool live = p < q.P;
  const int n = live ? q.n_poses[p] : 0;
  // P0 as map_origin computes it: position + (H, W) * res * 0.5
  const float p0x = __fadd_rn(q.position[0], __fmul_rn(__fmul_rn((float)q.H, q.res), 0.5f));
  const float p0y = __fadd_rn(q.position[1], __fmul_rn(__fmul_rn((float)q.W, q.res), 0.5f));
  // the block's poses (its paths', contiguous) and their cells, a stage at
  // a time: kStagePoses segment starts and the pose after the last
  const int cap = min(CIRC_WARPS * q.N, kStagePoses + 1);
  float2* s_pose = reinterpret_cast<float2*>(smem);
  int2* s_cell = reinterpret_cast<int2*>(smem + (size_t)8 * cap);
  const int total = min(CIRC_WARPS, q.P - first) * q.N;
  const float2* src = reinterpret_cast<const float2*>(q.poses) + (size_t)first * q.N;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this warp's path: its segments j < last, the lane's j = lane (mod 32)
  // in order, over the stages
  const int base = warp * q.N;  // the path's first pose in the block's
  const int last = live ? min(q.N - 1, n - 1) : 0;
  bool all_ok = true;
  float sum_len = 0.0f, sum_wt = 0.0f, sum_t = 0.0f, cnt = 0.0f;
  for (int c0 = 0, phase = 0;; c0 += kStagePoses, phase ^= 1) {
    // one bulk copy of the stage (a 16-byte multiple; an odd last pose by
    // a plain load), completion on the mbarrier
    const int count = min(kStagePoses + 1, total - c0);
    if (threadIdx.x == 0) {
      const unsigned bytes = (unsigned)count * 8u, bulk = bytes & ~15u;
      // the stage before was read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bulk)
                   : "memory");
      if (bulk > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(s_pose)),
            "l"(src + c0), "r"(bulk), "r"(b)
            : "memory");
      if (bytes != bulk) s_pose[count - 1] = src[c0 + count - 1];
    }
    __syncthreads();
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(phase)
          : "memory");
    // each pose's cell once (a segment's ends are its neighbours')
    for (int i = threadIdx.x; i < count; i += kThreads)
      s_cell[i] = make_int2(cell_of(p0x, s_pose[i].x, q.res_rcp),
                            cell_of(p0y, s_pose[i].y, q.res_rcp));
    __syncthreads();
    // the segments starting in this stage
    const int lo = max(0, c0 - base), hi = min(last, c0 + kStagePoses - base);
    for (int j = lo + ((lane - lo) & 31); j < hi; j += 32) {
      const int i = base + j - c0;
      walk_segment(q, s_pose[i], s_pose[i + 1], s_cell[i], s_cell[i + 1], all_ok, sum_len,
                   sum_wt, sum_t, cnt);
    }
    if (c0 + kStagePoses + 1 >= total) break;
    __syncthreads();  // every warp is done with the stage before the next
  }
  if (!live) return;  // a whole warp leaves

  if (q.N == 1 || n == 1) {
    // check_circles at the first pose: always for a one-pose batch, for a
    // path of one pose when asked (the plain version's has_single_pose)
    bool ok1 = false;
    float trav1 = 0.0f;
    if (q.N == 1 || q.single) {
      const float2 xy = src[base];
      single_pose(q, p0x, p0y, xy.x, xy.y, cell_of(p0x, xy.x, q.res_rcp),
                  cell_of(p0y, xy.y, q.res_rcp), &ok1, &trav1);
    }
    if (lane == 0) {
      const bool safe = ok1 && n >= 1;
      q.safe[p] = safe;
      // a one-pose batch keeps the verdict's traversability for n == 0
      q.trav[p] = (q.N == 1 ? ok1 : safe) ? trav1 : 0.0f;
    }
    return;
  }

  // the lanes combined in a fixed tree; lane 0 holds the sums
  all_ok = __all_sync(kFull, all_ok);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum_len = __fadd_rn(sum_len, __shfl_down_sync(kFull, sum_len, o));
    sum_wt = __fadd_rn(sum_wt, __shfl_down_sync(kFull, sum_wt, o));
    sum_t = __fadd_rn(sum_t, __shfl_down_sync(kFull, sum_t, o));
    cnt = __fadd_rn(cnt, __shfl_down_sync(kFull, cnt, o));
  }
  if (lane != 0) return;
  // weights: the segment lengths, or uniform where a path's lengths sum to
  // 0 (NaN lengths too, as the plain version's `w_sum > 0` reads them)
  const bool uniform = !(sum_len > 0.0f);
  const float num = uniform ? sum_t : sum_wt;
  float den = uniform ? cnt : sum_len;
  den = den < 1e-30f ? 1e-30f : den;  // clamp_min, NaN kept
  const bool safe = all_ok && n >= 1;
  q.safe[p] = safe;
  q.trav[p] = safe ? __fdiv_rn(num, den) : 0.0f;
}

// Nothing: launched at kernel 4's geometry, the floor a launch of it has.
__global__ void circ_empty_kernel() {}

extern "C" {

const char* te_circ_paths_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Resident blocks per SM of the kernel at `smem` bytes of dynamic shared
// memory, or -1.
int te_circ_paths_occupancy(int smem) {
  int blocks = -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, circ_paths_kernel, kThreads, smem);
  return e == cudaSuccess ? blocks : -1;
}

// poses (P, N, 2) f32, 16-byte aligned; n_poses (P,) i32; position (2,)
// f32; field_ok (H, W) u8 and field_trav (H, W) f32 (null when N == 1);
// trav_plane (H, ld_trav) f32 and mask_plane (H, ld_mask) u8, the state's
// planes; spiral (K, 2) i32, the spiral table of ops/circ_kernel.py
// ::spiral_table; outputs safe (P,) u8 and trav (P,) f32; all device
// pointers. S: the samples a segment takes at most (INT_MAX: all of its
// own); single: evaluate a path of one pose in a batch of N > 1; fill: the
// packed value of an off-map sample; default_trav, r2max, rmin, span_rcp,
// rmin_zero: check_circles' constants (float32(default),
// float32(rmax^2), float32(rmin), rcp(rmax - rmin), rmin == 0). grid_x,
// block_x, smem: the launch plan, launched as given once it is checked
// against this file's warps per block and stage (cudaErrorInvalidValue
// where it differs). Returns cudaGetLastError() after the launch.
int te_circ_paths(const float* poses, const int* n_poses, const float* position,
                  const uint8_t* field_ok, const float* field_trav, const float* trav_plane,
                  const uint8_t* mask_plane, const void* spiral, int P, int N, int H, int W,
                  int S, int K, int ld_trav, int ld_mask, int single, float res, float res_rcp,
                  float fill, float default_trav, float r2max, float rmin, float span_rcp,
                  int rmin_zero, int grid_x, int block_x, int smem, uint8_t* safe, float* trav,
                  void* stream) {
  if (P < 1 || N < 1 || H < 1 || W < 1 || S < 0 || K < 1 || ld_trav < W || ld_mask < W ||
      block_x != kThreads || grid_x != (P + CIRC_WARPS - 1) / CIRC_WARPS ||
      smem != 16 * min(CIRC_WARPS * N, kStagePoses + 1) || ((uintptr_t)poses & 15) != 0 ||
      trav_plane == nullptr || mask_plane == nullptr || spiral == nullptr ||
      (N > 1 && (field_ok == nullptr || field_trav == nullptr)))
    return (int)cudaErrorInvalidValue;
  CircParams q;
  q.poses = poses, q.n_poses = n_poses, q.position = position;
  q.field_ok = field_ok, q.field_trav = field_trav;
  q.trav_plane = trav_plane, q.mask_plane = mask_plane;
  q.spiral = static_cast<const int2*>(spiral);
  q.P = P, q.N = N, q.H = H, q.W = W, q.S = S, q.K = K;
  q.ld_trav = ld_trav, q.ld_mask = ld_mask, q.single = single, q.rmin_zero = rmin_zero;
  q.res = res, q.res_rcp = res_rcp, q.fill = fill, q.default_trav = default_trav;
  q.r2max = r2max, q.rmin = rmin, q.span_rcp = span_rcp;
  q.safe = safe, q.trav = trav;
  circ_paths_kernel<<<grid_x, block_x, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

// An empty kernel at the launch geometry (grid_x, block_x): kernel 4's
// launch floor. Returns cudaGetLastError() after the launch.
int te_circ_paths_empty(int grid_x, int block_x, void* stream) {
  circ_empty_kernel<<<grid_x, block_x, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
