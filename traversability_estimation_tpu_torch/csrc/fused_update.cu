// Fused map update: the whole filter chain and the dense veto fields in one
// launch.
//
// Replaces the TPU kernel fused_update (traversability_estimation_tpu/ops/
// pallas_chain.py:117; pallas_call at :169, body _kernel :86 / _tile_body
// :53). Plain version: ops/update_kernel.py::fused_update_plain (the torch
// chain of ops/filters.py and veto fields of ops/veto.py), which this
// kernel matches bit for bit: the same float32 operations in the same
// order, built with -fmad=false, and the one fused multiply-add of the plain
// version (1 - x / critical) written as __fmaf_rn.
//
// What bounds it on the H100: operations. Per cell it reads 4 bytes and
// writes 17, while the chain alone is ~1000 float operations (9-cell
// moments, a 4-sweep 3x3 Jacobi, the acos polynomial) and the step veto
// another ~800 (8 bounded ray walks of up to 9 cells). The design keeps
// every intermediate on chip, in stages separated by __syncthreads():
//   A. the elevation window of one 32x32 output tile plus the halo the
//      stencils need (11 cells at the defaults) -> shared memory; cells
//      beyond the map read NaN, which reproduces the plain version's edge
//      fills exactly;
//   B. the step height over the tile + 4 cells;
//   C. step, slope (moments -> Jacobi normals -> acos) and roughness over
//      the tile + 3 cells (the count-veto and candidate reach);
//   D. the 8 ray-fail bits of the step gap walk over the tile + 2 cells
//      (the candidate disc);
//   E. per output cell: the count vetoes, the candidate-sector combine,
//      the weighted fusion, and the stores.
// Stages B-D recompute their halo cells in every tile (the price of one
// launch with no exchange between blocks). All stencil tables (offsets,
// ray directions, candidate sectors, weights) sit in __constant__ memory;
// every thread of a warp reads the same entry at the same step.
// Not done yet: cp.async/TMA staging, and filling 132 SMs on a 336^2 map
// (121 tiles).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE 32
#define MAX_WIN 32
#define MAX_COUNT 128
#define MAX_CAND 64
#define MAX_DIRS 8
#define MAX_FUSE 8
#define THREADS 256

// Mirrored field by field by ops/update_kernel.py::FusedParams.
struct FusedParams {
  int halo, r_sh, r_mid, r_ray;
  int n_mom_n, n_mom_r, rough_shared, compute_roughness, check_roughness;
  int n_s1, n_s2, n_cnt, n_dirs, n_cand, n_fuse;
  int mom_n[MAX_WIN][2];
  float mom_n_d[MAX_WIN][2];
  int mom_r[MAX_WIN][2];
  float mom_r_d[MAX_WIN][2];
  int s1[MAX_WIN][2];
  int s2[MAX_WIN][2];
  int cnt[MAX_COUNT][2];
  int dirs[MAX_DIRS][3];   // di, dj, steps
  int cand[MAX_CAND][3];   // oi, oj, bit mask of the allowed directions
  int fuse_layer[MAX_FUSE];  // 0 slope, 1 step, 2 roughness
  float fuse_w[MAX_FUSE];
  float slope_crit, slope_rcp, step_crit, step_rcp, ccn_rcp, rough_crit, rough_rcp;
  float veto_crit, slope_ncrit, rough_ncrit;
};

__constant__ FusedParams P;

// float32 sentinels of the step filter (+/-3e38) and the acos polynomial,
// as exact float32 values
#define NEG_SENT (-0x1.c363ccp+127f)
#define POS_SENT (0x1.c363ccp+127f)
#define PI_F (0x1.921fb6p+1f)
#define DEGENERATE_EIG (0x1.5798eep-27f)  // 1e-8

__device__ __forceinline__ float nan_max(float a, float b) {
  // torch.maximum: NaN propagates
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}

template <int Pi, int Qi>
__device__ __forceinline__ void jacobi_rotation(float (&a)[3][3], float (&v)[3][3]) {
  constexpr int K = 3 - Pi - Qi;
  constexpr int PK0 = Pi < K ? Pi : K, PK1 = Pi < K ? K : Pi;
  constexpr int QK0 = Qi < K ? Qi : K, QK1 = Qi < K ? K : Qi;
  const float app = a[Pi][Pi], aqq = a[Qi][Qi], apq = a[Pi][Qi];
  const float apk = a[PK0][PK1], aqk = a[QK0][QK1];
  // tan(2 theta) = 2 apq / (aqq - app); stable branchless rotation
  const float tau = (aqq - app) / (apq == 0.0f ? 1.0f : 2.0f * apq);
  const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);
  float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = tau == 0.0f ? 1.0f : t;
  t = apq == 0.0f ? 0.0f : t;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  a[Pi][Pi] = c * c * app - 2.0f * s * c * apq + s * s * aqq;
  a[Qi][Qi] = s * s * app + 2.0f * s * c * apq + c * c * aqq;
  a[Pi][Qi] = 0.0f;
  a[PK0][PK1] = c * apk - s * aqk;
  a[QK0][QK1] = s * apk + c * aqk;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vip = v[i][Pi], viq = v[i][Qi];
    v[i][Pi] = c * vip - s * viq;
    v[i][Qi] = s * vip + c * viq;
  }
}

struct Moments {
  float n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz;
};

// Windowed point moments in local coordinates around tile cell (ti, tj).
__device__ __forceinline__ Moments moments(const float* elev, int E, int halo, int ti,
                                           int tj, int n_off, const int (*off)[2],
                                           const float (*d)[2]) {
  const float ec = elev[(ti + halo) * E + tj + halo];
  const float zc = isfinite(ec) ? ec : 0.0f;
  Moments m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n_off; ++k) {
    const float nb = elev[(ti + off[k][0] + halo) * E + tj + off[k][1] + halo];
    const bool fin = isfinite(nb);
    const float v = fin ? 1.0f : 0.0f;
    const float zn = fin ? nb : 0.0f;
    const float dx = d[k][0], dy = d[k][1];
    const float z = zn - zc * v;
    m.n = m.n + v;
    m.sx = m.sx + v * dx;
    m.sy = m.sy + v * dy;
    m.sz = m.sz + z;
    m.sxx = m.sxx + v * dx * dx;
    m.sxy = m.sxy + v * dx * dy;
    m.sxz = m.sxz + z * dx;
    m.syy = m.syy + v * dy * dy;
    m.syz = m.syz + z * dy;
    m.szz = m.szz + z * z;
  }
  return m;
}

__device__ __forceinline__ float acos_poly(float x) {
  const float y = fabsf(x);
  float p = -0x1.4af458p-10f;
  p = p * y + 0x1.b5218ap-8f;
  p = p * y + -0x1.17f8ccp-6f;
  p = p * y + 0x1.fa21f0p-6f;
  p = p * y + -0x1.9b0724p-5f;
  p = p * y + 0x1.6c753cp-4f;
  p = p * y + -0x1.b77f94p-3f;
  p = p * y + 0x1.921fb4p+0f;
  const float r = sqrtf(nan_max(1.0f - y, 0.0f)) * p;
  return x < 0.0f ? PI_F - r : r;
}

__global__ void __launch_bounds__(THREADS)
fused_update_kernel(const float* __restrict__ elevation, int H, int W,
                    float* __restrict__ trav_out, float* __restrict__ slope_out,
                    float* __restrict__ step_out, float* __restrict__ rough_out,
                    uint8_t* __restrict__ bits_out) {
  extern __shared__ float smem[];
  const int halo = P.halo, r_sh = P.r_sh, r_mid = P.r_mid, r_ray = P.r_ray;
  const int E = TILE + 2 * halo, S = TILE + 2 * r_sh, M = TILE + 2 * r_mid,
            Rr = TILE + 2 * r_ray;
  float* elev = smem;
  float* sh = elev + E * E;
  float* stepb = sh + S * S;
  float* slopeb = stepb + M * M;
  float* roughb = slopeb + M * M;
  uint8_t* bits = (uint8_t*)(roughb + (P.compute_roughness ? M * M : 0));

  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;

#define ELEV(ti, tj) elev[((ti) + halo) * E + (tj) + halo]
#define SH(ti, tj) sh[((ti) + r_sh) * S + (tj) + r_sh]
#define STEP(ti, tj) stepb[((ti) + r_mid) * M + (tj) + r_mid]
#define SLOPE(ti, tj) slopeb[((ti) + r_mid) * M + (tj) + r_mid]
#define ROUGH(ti, tj) roughb[((ti) + r_mid) * M + (tj) + r_mid]
#define BITS(ti, tj) bits[((ti) + r_ray) * Rr + (tj) + r_ray]
#define INMAP(ti, tj) \
  (i0 + (ti) >= 0 && i0 + (ti) < H && j0 + (tj) >= 0 && j0 + (tj) < W)

  // A. elevation window; NaN beyond the map
  for (int idx = tid; idx < E * E; idx += THREADS) {
    const int gi = i0 - halo + idx / E, gj = j0 - halo + idx % E;
    elev[idx] = (gi >= 0 && gi < H && gj >= 0 && gj < W) ? elevation[(long)gi * W + gj]
                                                         : NAN;
  }
  __syncthreads();

  // B. step height: (max - min) over the first window, sentinel-coded
  for (int idx = tid; idx < S * S; idx += THREADS) {
    const int ti = idx / S - r_sh, tj = idx % S - r_sh;
    const bool valid = isfinite(ELEV(ti, tj));
    float hmax = NEG_SENT, hmin = POS_SENT;
    for (int k = 0; k < P.n_s1; ++k) {
      const float v = ELEV(ti + P.s1[k][0], tj + P.s1[k][1]);
      const bool fin = isfinite(v);
      hmax = fmaxf(hmax, fin ? v : NEG_SENT);
      hmin = fminf(hmin, fin ? v : POS_SENT);
    }
    const bool any1 = hmax > 0.5f * NEG_SENT;
    SH(ti, tj) = (valid && any1) ? hmax - hmin : NAN;
  }
  __syncthreads();

  // C. step, slope and roughness layers
  for (int idx = tid; idx < M * M; idx += THREADS) {
    const int ti = idx / M - r_mid, tj = idx % M - r_mid;

    float smax_raw = NEG_SENT, ncrit = 0.0f;
    for (int k = 0; k < P.n_s2; ++k) {
      const float v = SH(ti + P.s2[k][0], tj + P.s2[k][1]);
      const float shn = isfinite(v) ? v : NEG_SENT;
      smax_raw = fmaxf(smax_raw, shn);
      ncrit = ncrit + (shn > P.step_crit ? 1.0f : 0.0f);
    }
    const bool any2 = smax_raw > 0.5f * NEG_SENT;
    const float smax = fmaxf(smax_raw, 0.0f);
    const float st = fminf(smax, ncrit * P.ccn_rcp * smax);
    const float step_v = st < P.step_crit ? __fmaf_rn(-st, P.step_rcp, 1.0f) : 0.0f;
    STEP(ti, tj) = any2 ? step_v : NAN;

    const bool valid = isfinite(ELEV(ti, tj));
    const Moments m = moments(elev, E, halo, ti, tj, P.n_mom_n, P.mom_n, P.mom_n_d);
    const float ns = fmaxf(m.n, 1.0f);
    const float mx = m.sx / ns, my = m.sy / ns, mz = m.sz / ns;
    float a[3][3], v[3][3];
    a[0][0] = m.sxx / ns - mx * mx;
    a[0][1] = m.sxy / ns - mx * my;
    a[0][2] = m.sxz / ns - mx * mz;
    a[1][1] = m.syy / ns - my * my;
    a[1][2] = m.syz / ns - my * mz;
    a[2][2] = m.szz / ns - mz * mz;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) v[i][j] = (i == j) ? 1.0f : 0.0f;
#pragma unroll
    for (int sweep = 0; sweep < 4; ++sweep) {
      jacobi_rotation<0, 1>(a, v);
      jacobi_rotation<0, 2>(a, v);
      jacobi_rotation<1, 2>(a, v);
    }
    const float d0 = a[0][0], d1 = a[1][1], d2 = a[2][2];
    const bool is0 = (d0 <= d1) && (d0 <= d2);
    const bool is1 = !is0 && (d1 <= d2);
    const float eig_min = is0 ? d0 : (is1 ? d1 : d2);
    const float eig_max = nan_max(d0, nan_max(d1, d2));
    const float eig_mid = d0 + d1 + d2 - eig_min - eig_max;
    float vx = is0 ? v[0][0] : (is1 ? v[0][1] : v[0][2]);
    float vy = is0 ? v[1][0] : (is1 ? v[1][1] : v[1][2]);
    float vz = is0 ? v[2][0] : (is1 ? v[2][1] : v[2][2]);
    if (eig_mid <= DEGENERATE_EIG) {
      vx = 0.0f;
      vy = 0.0f;
      vz = 1.0f;
    }
    if (vz < 0.0f) {
      vx = -vx;
      vy = -vy;
      vz = -vz;
    }
    const float nx = valid ? vx : NAN, ny = valid ? vy : NAN, nz = valid ? vz : NAN;

    float slope_v = NAN;
    if (isfinite(nz)) {
      const float ac = acos_poly(fminf(fmaxf(nz, -1.0f), 1.0f));
      slope_v = ac < P.slope_crit ? __fmaf_rn(-ac, P.slope_rcp, 1.0f) : 0.0f;
    }
    SLOPE(ti, tj) = slope_v;

    if (P.compute_roughness) {
      const Moments q = P.rough_shared
                            ? m
                            : moments(elev, E, halo, ti, tj, P.n_mom_r, P.mom_r, P.mom_r_d);
      const bool has_normal = isfinite(nx);
      const float nx0 = has_normal ? nx : 0.0f, ny0 = has_normal ? ny : 0.0f,
                  nz0 = has_normal ? nz : 0.0f;
      const float qs = fmaxf(q.n, 1.0f);
      const float qx = q.sx / qs, qy = q.sy / qs, qz = q.sz / qs;
      const float cxx = q.sxx - q.n * qx * qx;
      const float cxy = q.sxy - q.n * qx * qy;
      const float cxz = q.sxz - q.n * qx * qz;
      const float cyy = q.syy - q.n * qy * qy;
      const float cyz = q.syz - q.n * qy * qz;
      const float czz = q.szz - q.n * qz * qz;
      float quad = nx0 * (cxx * nx0 + cxy * ny0 + cxz * nz0) +
                   ny0 * (cxy * nx0 + cyy * ny0 + cyz * nz0) +
                   nz0 * (cxz * nx0 + cyz * ny0 + czz * nz0);
      quad = nan_max(quad, 0.0f);
      const float denom = q.n - 1.0f;
      const float rough = sqrtf(quad / (denom > 0.0f ? denom : NAN));
      const float rough_v =
          rough < P.rough_crit ? __fmaf_rn(-rough, P.rough_rcp, 1.0f) : 0.0f;
      ROUGH(ti, tj) = has_normal ? rough_v : NAN;
    }
  }
  __syncthreads();

  // D. ray-fail bits of the step gap walk, relative to each cell's own
  // elevation. selev: elevation of a legal drop/candidate cell (step == 0,
  // in the map) else NaN; welev: -inf for an invalid in-map cell ("gap"),
  // NaN beyond the map ("walk ends"). NaN compares false everywhere.
  const float crit = P.veto_crit;
#define SELEV(ti, tj) \
  ((INMAP(ti, tj) && STEP(ti, tj) == 0.0f) ? ELEV(ti, tj) : NAN)
  for (int idx = tid; idx < Rr * Rr; idx += THREADS) {
    const int ti = idx / Rr - r_ray, tj = idx % Rr - r_ray;
    const float h = ELEV(ti, tj);
    const float hm = h - crit, hp = h + crit;
    int b = 0;
    for (int d = 0; d < P.n_dirs; ++d) {
      const int di = P.dirs[d][0], dj = P.dirs[d][1], K = P.dirs[d][2];
      const bool trigger = SELEV(ti + di, tj + dj) < hm;
      bool gap_started = false, ended = false, wall_fail = false, any_gap = false;
      for (int t = 1; t <= K; ++t) {
        const int wi = ti + di * t, wj = tj + dj * t;
        const float e = ELEV(wi, wj);
        const float w = INMAP(wi, wj) ? (isfinite(e) ? e : -INFINITY) : NAN;
        const bool wall = w > hp;
        const bool gap = w < hm;
        const bool mid = !isnan(w) && !wall && !gap;
        const bool end_t = mid && gap_started && !ended;
        wall_fail = wall_fail || (wall && !ended);
        any_gap = any_gap || (gap && !ended);
        gap_started = gap_started || gap;
        ended = ended || end_t;
      }
      const bool unclosed = any_gap && !ended;
      if (trigger && (wall_fail || unclosed)) b |= 1 << d;
    }
    BITS(ti, tj) = (uint8_t)b;
  }
  __syncthreads();

  // E. vetoes, mask and fusion per output cell
  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    const int ti = idx / TILE, tj = idx % TILE;
    const int gi = i0 + ti, gj = j0 + tj;
    if (gi >= H || gj >= W) continue;

    const float slope_q = SLOPE(ti, tj);
    float zc = 0.0f;
    for (int k = 0; k < P.n_cnt; ++k)
      zc = zc + (SLOPE(ti + P.cnt[k][0], tj + P.cnt[k][1]) == 0.0f ? 1.0f : 0.0f);
    const bool slope_ok = !(slope_q == 0.0f && zc > P.slope_ncrit);

    const float rough_q = P.compute_roughness ? ROUGH(ti, tj) : NAN;
    bool rough_ok = true;
    if (P.check_roughness) {
      float rc = 0.0f;
      for (int k = 0; k < P.n_cnt; ++k)
        rc = rc + (ROUGH(ti + P.cnt[k][0], tj + P.cnt[k][1]) == 0.0f ? 1.0f : 0.0f);
      rough_ok = !(rough_q == 0.0f && rc > P.rough_ncrit);
    }

    const float step_q = STEP(ti, tj);
    const float hp = ELEV(ti, tj) + crit;
    bool has_cand = false, fail_from_cand = false;
    for (int k = 0; k < P.n_cand; ++k) {
      const int oi = P.cand[k][0], oj = P.cand[k][1];
      const bool active = SELEV(ti + oi, tj + oj) > hp;
      has_cand = has_cand || active;
      fail_from_cand = fail_from_cand || (active && (BITS(ti + oi, tj + oj) & P.cand[k][2]));
    }
    const bool fail_self = BITS(ti, tj) != 0;
    const bool step_ok = !((step_q == 0.0f) && (fail_from_cand || (!has_cand && fail_self)));
    const bool mask = slope_ok && step_ok && rough_ok;

    float fused = 0.0f;
    for (int k = 0; k < P.n_fuse; ++k) {
      const int l = P.fuse_layer[k];
      const float x = l == 0 ? slope_q : (l == 1 ? step_q : rough_q);
      fused = fused + P.fuse_w[k] * x;
    }

    const long g = (long)gi * W + gj;
    trav_out[g] = fused;
    slope_out[g] = slope_q;
    step_out[g] = step_q;
    if (P.compute_roughness) rough_out[g] = rough_q;
    bits_out[g] = (uint8_t)((slope_ok ? 1 : 0) | (step_ok ? 2 : 0) | (rough_ok ? 4 : 0) |
                            (mask ? 8 : 0));
  }
#undef ELEV
#undef SH
#undef STEP
#undef SLOPE
#undef ROUGH
#undef BITS
#undef INMAP
#undef SELEV
}

static size_t smem_bytes(const FusedParams& p) {
  const size_t E = TILE + 2 * p.halo, S = TILE + 2 * p.r_sh, M = TILE + 2 * p.r_mid,
               Rr = TILE + 2 * p.r_ray;
  return sizeof(float) * (E * E + S * S + M * M * (p.compute_roughness ? 3 : 2)) + Rr * Rr;
}

extern "C" {

int te_fused_update_params_size() { return (int)sizeof(FusedParams); }

const char* te_fused_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// elevation (H, W) f32; outputs (H, W): traversability, slope, step,
// roughness (ignored unless compute_roughness) f32 and the veto bit plane
// uint8 (bit 0 slope_ok, 1 step_ok, 2 roughness_ok, 3 traversable_mask).
// All device pointers; params is a host pointer. Returns cudaGetLastError()
// after the launch.
int te_fused_update(const float* elevation, int H, int W, const FusedParams* params,
                    float* trav, float* slope, float* step, float* rough,
                    uint8_t* bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // stream-ordered: a launch reads the parameters uploaded just before it
  cudaError_t e = cudaMemcpyToSymbolAsync(P, params, sizeof(FusedParams), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(*params);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  fused_update_kernel<<<grid, THREADS, smem, s>>>(elevation, H, W, trav, slope, step,
                                                  rough, bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
