// Dense circle field: the circular-footprint verdict of every map cell.
//
// Replaces the TPU kernel dense_circle_field_pallas
// (traversability_estimation_tpu/ops/pallas_field.py, pallas_call at :201,
// body _kernel at :42). Plain version: ops/footprint.py::dense_circle_field,
// which this kernel matches bit for bit (same float32 operations in the same
// spiral order, built with -fmad=false).
//
// What bounds it on the H100: operations. Each cell walks K spiral offsets
// (709 at radius 0.45 m / 0.03 m) with a handful of compares, selects and
// two adds each, and reads and writes ~10 bytes; the work per byte is far
// above the card's ridge point. The walk is sequential per cell (the first
// failure's radius, count and sum depend on the order), so the design keeps
// every operand on chip:
//   - one block per 32x32 output tile; the tile's window with a halo of the
//     spiral reach R is staged once in shared memory as ONE packed plane
//     (-inf failing cell, NaN beyond the map or outside `in_map`, else the
//     effective traversability), (32+2R)^2 floats, 15 KB at R = 15;
//   - the offsets and radii sit in __constant__ memory: all threads read the
//     same offset at the same step, so each read is a broadcast;
//   - each thread owns 4 cells of one column and carries their six values
//     (found, radius of first fail, count and sum before it, total count,
//     total sum) in registers; neighbouring threads read neighbouring
//     shared-memory words, so the window reads are free of bank conflicts.
// Not done yet: filling 132 SMs when a 336^2 map has 121 tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FIELD_TILE 32
#define FIELD_ROWS_PER_THREAD 4
#define FIELD_MAX_OFFS 4096

__constant__ int2 c_offs[FIELD_MAX_OFFS];
__constant__ float c_radii[FIELD_MAX_OFFS];

__global__ void circle_field_kernel(const float* __restrict__ trav,
                                    const uint8_t* __restrict__ mask,
                                    const uint8_t* __restrict__ in_map,
                                    int H, int W, int R, int n_off,
                                    float default_tv, float rmin, float span_rcp,
                                    int rmin_zero, uint8_t* __restrict__ ok_out,
                                    float* __restrict__ trav_out) {
  extern __shared__ float win[];
  const int E = FIELD_TILE + 2 * R;
  const int i0 = blockIdx.y * FIELD_TILE;
  const int j0 = blockIdx.x * FIELD_TILE;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int idx = tid; idx < E * E; idx += nthreads) {
    const int gi = i0 - R + idx / E;
    const int gj = j0 - R + idx % E;
    float packed = NAN;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const long g = (long)gi * W + gj;
      if (in_map == nullptr || in_map[g]) {
        const float t = trav[g];
        const float tv = isfinite(t) ? t : default_tv;
        packed = mask[g] ? tv : -INFINITY;
      }
    }
    win[idx] = packed;
  }
  __syncthreads();

  const int lj = threadIdx.x;
  bool found[FIELD_ROWS_PER_THREAD];
  float r_fail[FIELD_ROWS_PER_THREAD], cnt_b[FIELD_ROWS_PER_THREAD],
      sum_b[FIELD_ROWS_PER_THREAD], cnt[FIELD_ROWS_PER_THREAD],
      ssum[FIELD_ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < FIELD_ROWS_PER_THREAD; ++r) {
    found[r] = false;
    r_fail[r] = 0.0f;
    cnt_b[r] = 0.0f;
    sum_b[r] = 0.0f;
    cnt[r] = 0.0f;
    ssum[r] = 0.0f;
  }

  for (int k = 0; k < n_off; ++k) {
    const int2 o = c_offs[k];
    const float r_k = c_radii[k];
#pragma unroll
    for (int r = 0; r < FIELD_ROWS_PER_THREAD; ++r) {
      const int li = threadIdx.y + r * blockDim.y;
      const float v = win[(li + R + o.x) * E + (lj + R + o.y)];
      const bool fail_k = v == -INFINITY;
      const bool is_pass = isfinite(v);
      const bool new_fail = fail_k && !found[r];
      r_fail[r] = new_fail ? r_k : r_fail[r];
      cnt_b[r] = new_fail ? cnt[r] : cnt_b[r];
      sum_b[r] = new_fail ? ssum[r] : sum_b[r];
      found[r] = found[r] || fail_k;
      cnt[r] = cnt[r] + (is_pass ? 1.0f : 0.0f);
      ssum[r] = ssum[r] + (is_pass ? v : 0.0f);
    }
  }

#pragma unroll
  for (int r = 0; r < FIELD_ROWS_PER_THREAD; ++r) {
    const int gi = i0 + threadIdx.y + r * blockDim.y;
    const int gj = j0 + lj;
    if (gi >= H || gj >= W) continue;
    const float mean_all = ssum[r] / fmaxf(cnt[r], 1.0f);
    bool ok;
    float t;
    if (rmin_zero) {
      ok = !found[r];
      t = ok ? mean_all : 0.0f;
    } else {
      const bool hard = found[r] && (r_fail[r] <= rmin);
      const bool inflate = found[r] && (r_fail[r] > rmin);
      // ((r_fail - rmin) / (rmax - rmin) + 1) / 2, the division by the
      // constant span as a fused multiply-add by its reciprocal
      const float factor = __fmaf_rn(r_fail[r] - rmin, span_rcp, 1.0f) * 0.5f;
      const float mean_b = sum_b[r] / fmaxf(cnt_b[r], 1.0f);
      ok = !hard;
      t = inflate ? mean_b * factor : (hard ? 0.0f : mean_all);
    }
    const bool empty = (cnt[r] == 0.0f) && !found[r];
    if (empty) {
      ok = default_tv != 0.0f;
      t = default_tv;
    }
    const long g = (long)gi * W + gj;
    ok_out[g] = ok ? 1 : 0;
    trav_out[g] = t;
  }
}

extern "C" {

int te_circle_field_max_offsets() { return FIELD_MAX_OFFS; }

const char* te_circle_field_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// offs: host (n_off, 2) int32 in spiral order; radii: host (n_off,) float32.
// trav (H, W) f32, mask (H, W) uint8, in_map (H, W) uint8 or null; outputs
// ok (H, W) uint8 and trav_out (H, W) f32, all device pointers. Returns
// cudaGetLastError() after the launch.
int te_circle_field(const float* trav, const uint8_t* mask, const uint8_t* in_map,
                    int H, int W, const int* offs, const float* radii, int n_off,
                    float default_tv, float rmin, float span_rcp, int rmin_zero,
                    uint8_t* ok_out, float* trav_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_off < 1 || n_off > FIELD_MAX_OFFS) return (int)cudaErrorInvalidValue;
  int R = 0;
  for (int k = 0; k < 2 * n_off; ++k) R = max(R, abs(offs[k]));
  cudaError_t e = cudaMemcpyToSymbolAsync(c_offs, offs, sizeof(int2) * n_off, 0,
                                          cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbolAsync(c_radii, radii, sizeof(float) * n_off, 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int E = FIELD_TILE + 2 * R;
  const size_t smem = sizeof(float) * (size_t)E * E;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(circle_field_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(FIELD_TILE, FIELD_TILE / FIELD_ROWS_PER_THREAD);
  dim3 grid((W + FIELD_TILE - 1) / FIELD_TILE, (H + FIELD_TILE - 1) / FIELD_TILE);
  circle_field_kernel<<<grid, block, smem, s>>>(trav, mask, in_map, H, W, R, n_off,
                                                default_tv, rmin, span_rcp, rmin_zero,
                                                ok_out, trav_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
