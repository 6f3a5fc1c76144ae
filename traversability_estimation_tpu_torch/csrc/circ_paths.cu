// Circular path batch: check_circular_paths' samples, lookups and
// aggregation for every path of a batch in one launch.
//
// Not the port of a TPU kernel: the JAX package computes the batch as
// XLA-fused jnp (traversability_estimation_tpu/ops/footprint.py:378). Plain
// version: ops/footprint.py::check_circular_paths_plain. This kernel gives
// its verdicts exactly and its traversability within the rounding of its
// sums, which run in another order (built with -fmad=false, so every other
// float32 operation is the plain version's).
//
// What bounds it on the H100: neither bytes nor operations. At the main
// path's 1024 paths x 50 poses it reads ~0.4 MB of poses and 5 bytes of
// field per sample (~0.5 MB) and does ~2e6 float32 operations, a bound of
// well under a microsecond. The plain version is ~115 small torch launches,
// each a few microseconds of device time and tens of host time; this
// kernel is one launch, and the design is the simple one:
//   - one warp per path; lane l takes the path's segments l, l + 32, ...;
//   - a sample's cell comes from the Bresenham closed form over(k) =
//     (denom / 2 + k * num_add) / max(denom, 1) (grid_map's LineIterator,
//     walked from the segment's END to its START as the reference walks
//     it), so a lane computes only its stride-4 samples, never the line;
//   - each sample reads the field's ok byte and trav float (gathers that
//     L2 serves) and rounds them through the plain version's packed
//     encoding (ok ? trav : -1 - trav), as the plain version does;
//   - a lane sums its segments in order, the warp combines the lanes with
//     a fixed shuffle tree: no float atomics, two launches give the same
//     bits.
// The launch geometry (grid, block) is computed on the host by
// ops/circ_kernel.py::launch_plan and checked here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CIRC_WARPS 4

constexpr int kThreads = 32 * CIRC_WARPS;
constexpr unsigned kFull = 0xffffffffu;

struct CircParams {
  const float* poses;      // (P, N, 2)
  const int* n_poses;      // (P,)
  const float* position;   // (2,) the query state's map centre
  const uint8_t* field_ok;  // (H, W)
  const float* field_trav;  // (H, W)
  const uint8_t* ok1;      // (P,) the single-pose verdicts, or null
  const float* trav1;      // (P,) or null
  int P, N, H, W, S;
  float res, res_rcp, fill;
  uint8_t* safe;  // (P,)
  float* trav;    // (P,)
};

// The cell index of a coordinate below the origin p0: floor((p0 - x) *
// rcp(res)), as ops/footprint.py::index_from_origin rounds it.
__device__ __forceinline__ int cell_of(float p0, float x, float res_rcp) {
  return (int)floorf(__fmul_rn(__fsub_rn(p0, x), res_rcp));
}

__global__ void __launch_bounds__(kThreads) circ_paths_kernel(const CircParams q) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * CIRC_WARPS + (threadIdx.x >> 5);
  if (p >= q.P) return;  // a whole warp leaves
  const int n = q.n_poses[p];
  const bool ok1 = q.ok1 != nullptr && q.ok1[p];
  const float trav1 = q.trav1 != nullptr ? q.trav1[p] : 0.0f;
  if (q.N == 1) {  // single-pose batch: the plain version's early return
    if (lane == 0) {
      q.safe[p] = ok1 && n >= 1;
      q.trav[p] = ok1 ? trav1 : 0.0f;
    }
    return;
  }
  // P0 as map_origin computes it: position + (H, W) * res * 0.5
  const float p0x = __fadd_rn(q.position[0], __fmul_rn(__fmul_rn((float)q.H, q.res), 0.5f));
  const float p0y = __fadd_rn(q.position[1], __fmul_rn(__fmul_rn((float)q.W, q.res), 0.5f));
  const float* pp = q.poses + (size_t)p * q.N * 2;

  // per lane, over its valid segments in order: all samples ok, the
  // length-weighted and the plain sums of the segment means, the lengths,
  // the count
  bool all_ok = true;
  float sum_len = 0.0f, sum_wt = 0.0f, sum_t = 0.0f, cnt = 0.0f;
  for (int j = lane; j < q.N - 1 && j + 1 < n; j += 32) {
    const float sx = pp[2 * j], sy = pp[2 * j + 1];
    const float ex = pp[2 * j + 2], ey = pp[2 * j + 3];
    // the walk from the END cell to the START cell
    const int fi = cell_of(p0x, ex, q.res_rcp), fj = cell_of(p0y, ey, q.res_rcp);
    const int li = cell_of(p0x, sx, q.res_rcp), lj = cell_of(p0y, sy, q.res_rcp);
    const int di = abs(li - fi), dj = abs(lj - fj);
    const int si = li >= fi ? 1 : -1, sj = lj >= fj ? 1 : -1;
    const bool x_dom = di >= dj;
    const int denom = x_dom ? di : dj, num_add = x_dom ? dj : di;
    const int half = denom / 2, safe_denom = max(denom, 1);
    bool seg_ok = true;
    int n_s = 0;
    float s = 0.0f;
    // samples k = 0, 4, 8, ... of the denom + 1 cells, at most S of them
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
      s = __fadd_rn(s, ok_s ? v : __fsub_rn(-1.0f, v));
      ++n_s;
    }
    const float seg_trav = __fdiv_rn(s, (float)max(n_s, 1));
    const float dx = __fsub_rn(ex, sx), dy = __fsub_rn(ey, sy);
    const float len = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    all_ok = all_ok && seg_ok;
    sum_len = __fadd_rn(sum_len, len);
    sum_wt = __fadd_rn(sum_wt, __fmul_rn(len, seg_trav));
    sum_t = __fadd_rn(sum_t, seg_trav);
    cnt = __fadd_rn(cnt, 1.0f);
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
  const float path = __fdiv_rn(num, den);
  const bool single = n == 1;
  const bool safe = (single ? ok1 : all_ok) && n >= 1;
  q.safe[p] = safe;
  q.trav[p] = safe ? (single ? trav1 : path) : 0.0f;
}

extern "C" {

const char* te_circ_paths_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Resident blocks per SM of the kernel, or -1.
int te_circ_paths_occupancy() {
  int blocks = -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, circ_paths_kernel, kThreads, 0);
  return e == cudaSuccess ? blocks : -1;
}

// poses (P, N, 2) f32, n_poses (P,) i32, position (2,) f32, field_ok (H, W)
// u8 and field_trav (H, W) f32 (null when N == 1), ok1 (P,) u8 and trav1
// (P,) f32 or both null (not when N == 1); outputs safe (P,) u8 and trav
// (P,) f32; all device pointers, all contiguous. S: the samples a segment
// takes at most; fill: the packed value of an off-map sample. grid_x,
// block_x: the launch plan, launched as given once it is checked against
// this file's warps per block (cudaErrorInvalidValue where it differs).
// Returns cudaGetLastError() after the launch.
int te_circ_paths(const float* poses, const int* n_poses, const float* position,
                  const uint8_t* field_ok, const float* field_trav, const uint8_t* ok1,
                  const float* trav1, int P, int N, int H, int W, int S, float res,
                  float res_rcp, float fill, int grid_x, int block_x, uint8_t* safe,
                  float* trav, void* stream) {
  if (P < 1 || N < 1 || H < 0 || W < 0 || S < 0 || block_x != kThreads ||
      grid_x != (P + CIRC_WARPS - 1) / CIRC_WARPS || (ok1 == nullptr) != (trav1 == nullptr) ||
      (N == 1 && ok1 == nullptr) || (N > 1 && (field_ok == nullptr || field_trav == nullptr)))
    return (int)cudaErrorInvalidValue;
  CircParams q;
  q.poses = poses, q.n_poses = n_poses, q.position = position;
  q.field_ok = field_ok, q.field_trav = field_trav, q.ok1 = ok1, q.trav1 = trav1;
  q.P = P, q.N = N, q.H = H, q.W = W, q.S = S;
  q.res = res, q.res_rcp = res_rcp, q.fill = fill;
  q.safe = safe, q.trav = trav;
  circ_paths_kernel<<<grid_x, block_x, 0, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

}  // extern "C"
