// Dense circle field: the circular-footprint verdict of every map cell.
//
// Replaces the TPU kernel dense_circle_field_pallas
// (traversability_estimation_tpu/ops/pallas_field.py, pallas_call at :201,
// body _kernel at :42). Plain version: ops/footprint.py::dense_circle_field,
// which this kernel matches bit for bit (same float32 operations in the same
// spiral order, built with -fmad=false).
//
// What bounds it on the H100: issued instructions. Each cell walks K spiral
// offsets (697 at radius 0.45 m / 0.03 m) with one shared-memory load and a
// handful of compares, selects and adds each, and reads and writes ~10
// bytes. The walk is sequential per cell (the first failure's index, the
// count and sum before it depend on the order), so the design keeps every
// operand on chip and spends as few instructions per (cell, offset) as it
// can:
//   - small tiles (FIELD_TILE_W x FIELD_TILE_H output cells, one cell per
//     thread), so a 336^2 map gives 924 blocks of 4 warps and every SM
//     holds many warps to hide the load latency;
//   - the tile's window with a halo of the spiral reach R is staged once
//     in shared memory as ONE packed plane (-inf failing cell, NaN beyond
//     the map or outside `in_map`, else the effective traversability), in
//     rows of a compile-time stride (64 or 128 floats);
//   - the offsets arrive as one linear shared-memory delta each,
//     (oi + R) * stride + (oj + R), built once on the host and cached on
//     the device; the block copies them to shared memory in bytes, and each
//     step of the walk is one broadcast table read (4 deltas per 16-byte
//     load), one add and one load at `cell base + delta`;
//   - the offset loop is unrolled by 8, so several loads are in flight;
//   - six carries per cell stay in registers: found, the index of the
//     first failure (its radius is read once at the end), the count and sum
//     before it, the total count and sum, added in spiral order exactly as
//     the plain version adds them. The first failure is met once per cell,
//     so the walk only notes which group of 8 offsets holds it (with the
//     count and sum before that group) and re-walks that group once at the
//     end: the common step is an add, a load, a finite test, two
//     predicated adds and an or.
// The launch geometry (grid, block, shared memory) is computed on the host
// by ops/field_kernel.py::launch_plan and checked here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FIELD_TILE_W 32
#define FIELD_TILE_H 4
#define FIELD_MAX_OFFS 4096
#define FIELD_UNROLL 8

constexpr int kThreads = FIELD_TILE_W * FIELD_TILE_H;

__device__ __forceinline__ int padded_offsets(int n_off) {
  return (n_off + FIELD_UNROLL - 1) / FIELD_UNROLL * FIELD_UNROLL;
}

template <int STRIDE>
__global__ void __launch_bounds__(kThreads)
circle_field_kernel(const float* __restrict__ trav, const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ in_map, int H, int W, int R,
                    const int* __restrict__ deltas, const float* __restrict__ radii,
                    int n_off, float default_tv, float rmin, float span_rcp, int rmin_zero,
                    uint8_t* __restrict__ ok_out, float* __restrict__ trav_out) {
  extern __shared__ int4 smem4[];
  int* tab = reinterpret_cast<int*>(smem4);
  float* win = reinterpret_cast<float*>(smem4) + padded_offsets(n_off);
  const int i0 = blockIdx.y * FIELD_TILE_H;
  const int j0 = blockIdx.x * FIELD_TILE_W;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // the deltas in bytes: each tap is then one add and one load
  for (int k = ty * FIELD_TILE_W + tx; k < n_off; k += kThreads) tab[k] = deltas[k] * 4;
  // the packed window; the loads of several rows are issued before their
  // stores (unrolled), so the block waits for L2 a few times, not once per
  // row
  const int rows = FIELD_TILE_H + 2 * R, cols = FIELD_TILE_W + 2 * R;
#pragma unroll 4
  for (int r = ty; r < rows; r += FIELD_TILE_H) {
    const int gi = i0 - R + r;
#pragma unroll
    for (int c = tx; c < STRIDE; c += FIELD_TILE_W) {
      const int gj = j0 - R + c;
      float packed = NAN;
      if (c < cols && gi >= 0 && gi < H && gj >= 0 && gj < W) {
        const long g = (long)gi * W + gj;
        const bool inside = in_map == nullptr || in_map[g];
        const float t = trav[g];
        const float tv = isfinite(t) ? t : default_tv;
        const float v = mask[g] ? tv : -INFINITY;
        packed = inside ? v : NAN;
      }
      win[r * STRIDE + c] = packed;
    }
  }
  __syncthreads();

  // Groups of FIELD_UNROLL offsets. A step only adds a passing value to the
  // count and sum and ORs "some offset of this group fails"; at the end of
  // the group a cell that meets its first failure there keeps the group's
  // start index and the count and sum before the group. After the walk the
  // cell re-walks that one group to the first failure, adding the same
  // values in the same order, so the count and sum before the first failure
  // carry the plain version's bits. The plain version adds 0 for a cell
  // that does not pass; a sum that starts at +0 and adds finite values is
  // never -0, so skipping that add gives the same bits.
  const char* wb = reinterpret_cast<const char*>(win + ty * STRIDE + tx);
  bool found = false;
  int g_fail = 0, k_fail = 0;
  float cnt_b = 0.0f, cnt = 0.0f, sum_b = 0.0f, ssum = 0.0f;
  auto group = [&](int k0, int kn, const int* d) {
    const float gs_cnt = cnt, gs_sum = ssum;
    bool fails = false;
#pragma unroll
    for (int u = 0; u < FIELD_UNROLL; ++u) {
      if (k0 + u < kn) {
        const float v = *reinterpret_cast<const float*>(wb + d[u]);
        if (isfinite(v)) {
          cnt = cnt + 1.0f;
          ssum = ssum + v;
        }
        fails = fails || v == -INFINITY;
      }
    }
    if (fails && !found) {
      found = true;
      g_fail = k0;
      cnt_b = gs_cnt;
      sum_b = gs_sum;
    }
  };

  const int n8 = n_off / FIELD_UNROLL * FIELD_UNROLL;
  int k = 0;
  for (; k < n8; k += FIELD_UNROLL) {
    const int4 d0 = *reinterpret_cast<const int4*>(tab + k);
    const int4 d1 = *reinterpret_cast<const int4*>(tab + k + 4);
    const int d[FIELD_UNROLL] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    group(k, k + FIELD_UNROLL, d);
  }
  if (k < n_off) {
    int d[FIELD_UNROLL];
#pragma unroll
    for (int u = 0; u < FIELD_UNROLL; ++u) d[u] = k + u < n_off ? tab[k + u] : 0;
    group(k, n_off, d);
  }
  // the failing group, once per cell, up to its first failure
  if (found) {
    for (int kk = g_fail;; ++kk) {
      const float v = *reinterpret_cast<const float*>(wb + tab[kk]);
      if (v == -INFINITY) {
        k_fail = kk;
        break;
      }
      if (isfinite(v)) {
        cnt_b = cnt_b + 1.0f;
        sum_b = sum_b + v;
      }
    }
  }

  const int gi = i0 + ty, gj = j0 + tx;
  if (gi >= H || gj >= W) return;
  const float mean_all = ssum / fmaxf(cnt, 1.0f);
  bool ok;
  float t;
  if (rmin_zero) {
    ok = !found;
    t = ok ? mean_all : 0.0f;
  } else {
    const float r_fail = found ? radii[k_fail] : 0.0f;
    const bool hard = found && (r_fail <= rmin);
    const bool inflate = found && (r_fail > rmin);
    // ((r_fail - rmin) / (rmax - rmin) + 1) / 2, the division by the
    // constant span as a fused multiply-add by its reciprocal
    const float factor = __fmaf_rn(r_fail - rmin, span_rcp, 1.0f) * 0.5f;
    const float mean_b = sum_b / fmaxf(cnt_b, 1.0f);
    ok = !hard;
    t = inflate ? mean_b * factor : (hard ? 0.0f : mean_all);
  }
  if (cnt == 0.0f && !found) {
    ok = default_tv != 0.0f;
    t = default_tv;
  }
  const long g = (long)gi * W + gj;
  ok_out[g] = ok ? 1 : 0;
  trav_out[g] = t;
}

static size_t smem_bytes(int R, int n_off, int stride) {
  const int n_pad = (n_off + FIELD_UNROLL - 1) / FIELD_UNROLL * FIELD_UNROLL;
  return sizeof(float) * ((size_t)n_pad + (size_t)(FIELD_TILE_H + 2 * R) * stride);
}

// Raise the kernel's dynamic shared-memory cap where a launch needs more than
// the default 48 KB; never lower it.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The launch plan's grid and block tile an (H, W) map with this file's tile:
// every cell covered, no block wholly outside.
static bool plan_tiles_map(dim3 grid, dim3 block, int H, int W) {
  return block.x == FIELD_TILE_W && block.y == FIELD_TILE_H && block.z == 1 && grid.z == 1 &&
         (int)grid.x * FIELD_TILE_W >= W && ((int)grid.x - 1) * FIELD_TILE_W < W &&
         (int)grid.y * FIELD_TILE_H >= H && ((int)grid.y - 1) * FIELD_TILE_H < H;
}

template <int STRIDE>
static cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s, const float* trav,
                          const uint8_t* mask, const uint8_t* in_map, int H, int W, int R,
                          const int* deltas, const float* radii, int n_off, float default_tv,
                          float rmin, float span_rcp, int rmin_zero, uint8_t* ok_out,
                          float* trav_out) {
  const cudaError_t e = allow_smem(circle_field_kernel<STRIDE>, smem);
  if (e != cudaSuccess) return e;
  circle_field_kernel<STRIDE><<<grid, block, smem, s>>>(
      trav, mask, in_map, H, W, R, deltas, radii, n_off, default_tv, rmin, span_rcp, rmin_zero,
      ok_out, trav_out);
  return cudaGetLastError();
}

extern "C" {

const char* te_circle_field_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks per SM for a launch with this window stride and shared
// memory, or -1 on error.
int te_circle_field_occupancy(int stride, int smem) {
  int blocks = -1;
  cudaError_t e = cudaErrorInvalidValue;
  if (stride == 64) {
    e = allow_smem(circle_field_kernel<64>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, circle_field_kernel<64>,
                                                        kThreads, smem);
  } else if (stride == 128) {
    e = allow_smem(circle_field_kernel<128>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, circle_field_kernel<128>,
                                                        kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -1;
}

// deltas (n_off,) int32 and radii (n_off,) float32: device tables in spiral
// order (ops/field_kernel.py::device_tables); R: the spiral reach; stride:
// the window row stride the deltas were built for. grid_x/y, block_x/y,
// smem: the launch plan, launched as given once it is checked against this
// file's tile and shared-memory count (cudaErrorInvalidValue where they
// differ). trav (H, W) f32, mask (H, W) uint8, in_map (H, W) uint8 or null;
// outputs ok (H, W) uint8 and trav_out (H, W) f32, all device pointers.
// Returns cudaGetLastError() after the launch.
int te_circle_field(const float* trav, const uint8_t* mask, const uint8_t* in_map, int H,
                    int W, int R, const int* deltas, const float* radii, int n_off, int stride,
                    int grid_x, int grid_y, int block_x, int block_y, int smem, float default_tv,
                    float rmin, float span_rcp, int rmin_zero, uint8_t* ok_out, float* trav_out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  if (n_off < 1 || n_off > FIELD_MAX_OFFS || R < 0 || FIELD_TILE_W + 2 * R > stride ||
      grid_x < 1 || grid_y < 1 || !plan_tiles_map(grid, block, H, W) ||
      (size_t)smem != smem_bytes(R, n_off, stride))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  if (stride == 64)
    e = launch<64>(grid, block, smem, s, trav, mask, in_map, H, W, R, deltas, radii, n_off,
                   default_tv, rmin, span_rcp, rmin_zero, ok_out, trav_out);
  else if (stride == 128)
    e = launch<128>(grid, block, smem, s, trav, mask, in_map, H, W, R, deltas, radii, n_off,
                    default_tv, rmin, span_rcp, rmin_zero, ok_out, trav_out);
  return (int)e;
}

}  // extern "C"
