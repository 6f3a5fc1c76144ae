// Fused map update: the whole filter chain and the dense veto fields in two
// launches.
//
// Replaces the TPU kernel fused_update (traversability_estimation_tpu/ops/
// pallas_chain.py:117; pallas_call at :169, body _kernel :86 / _tile_body
// :53). Plain version: ops/update_kernel.py::fused_update_plain (the torch
// chain of ops/filters.py and veto fields of ops/veto.py), which these
// kernels match bit for bit: the same float32 operations in the same order,
// built with -fmad=false, and the one fused multiply-add of the plain version
// (1 - x / critical) written as __fmaf_rn.
//
// What bounds it on the H100: issued instructions and their latency. Per
// cell it reads 4 bytes and writes 36, while the chain is ~1000 float
// operations (9-cell moments, a 4-sweep 3x3 Jacobi with IEEE divisions and
// square roots, the acos polynomial) and the step veto another ~800 (8
// bounded ray walks of up to 9 cells). The design:
//   1. fused_layers_kernel, one thread per cell of a 32 x 8 tile (462
//      blocks of 8 warps on a 336^2 map): the elevation window (tile + the stencil and
//      walk reach, 9 cells at the defaults) in shared memory, coded once for
//      the walk (NaN beyond the map, -inf for an in-map hole, else the
//      elevation); the step height over the tile + 1; then per cell the
//      step, slope (moments -> Jacobi normals -> acos), roughness and fused
//      layers, and the 8 ray walks of the step veto relative to the cell's
//      own elevation (with the walk's early exits, which give the same
//      verdict as the plain version's full scan). Every heavy stage runs
//      once per cell: no halo is recomputed. Out: the four float layers and
//      one byte of ray-walk failures per cell.
//   2. fused_veto_kernel, one thread per cell of a 32 x 16 tile: the layers
//      and walk failures of the tile + 3 cells from L2 into shared memory,
//      coded once: the
//      raw elevation, the candidate plane (the elevation of an in-map cell
//      with step == 0, else NaN) and the zero flags of step, slope and
//      roughness; the ray-fail bits (walk failures gated by their triggers)
//      over the tile + 2; then per cell the count vetoes, the
//      candidate-sector combine and the stores of every plane the
//      estimator keeps (the *_ok planes, traversable_mask, *_footprint).
// Stencil offsets become linear shared-memory deltas once per block, so
// every tap is one table read and one load. FusedParams (3,928 bytes, so that
// each kernel's arguments stay under 4 KB) is a __grid_constant__ kernel
// parameter: no copy before the launch. The launch geometry is computed on the
// host by ops/update_kernel.py::launch_plan and checked here.
//
// The fused layer is either the weighted sum of the chain's layers or, when
// the configuration carries a fusion expression (MathExpressionFilter), that
// expression: the TPU kernel traces it into its body, and a CUDA kernel
// cannot be re-traced without a rebuild, so the host compiles the expression
// into a postfix program (ops/expr.py::to_program) that travels in FusedParams
// and run_program interprets per cell. Its stack is eight named registers
// that shift on a push and a pop, so no stack slot is indexed by a run-time
// value and nothing spills to local memory; the interpreter is one call, out
// of line, so the kernel's other code compiles as it does without it. Each
// arithmetic entry is one IEEE float32 instruction and the functions are the
// CUDA math library's (no fast variants), as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K1_TILE_W 32
#define K1_TILE_H 8    // layers kernel
#define K1V_TILE_H 16  // veto kernel: light, and its halo costs less on a taller tile
#define K1_THREADS (K1_TILE_W * K1_TILE_H)
#define K1V_THREADS (K1_TILE_W * K1V_TILE_H)
#define MAX_WIN 32
#define MAX_COUNT 128
#define MAX_CAND 64
#define MAX_DIRS 8
#define MAX_FUSE 8
#define MAX_PROG 64   // entries of the fusion expression's postfix program
#define MAX_STACK 8   // its stack; the host checks a program's depth against it
static_assert(K1_THREADS >= MAX_WIN + MAX_DIRS, "the table prologue needs one thread per entry");

// Mirrored field by field by ops/update_kernel.py::FusedParams.
struct FusedParams {
  int halo;   // layers kernel: elevation window reach (stencils and walk)
  int r_sh;   // layers kernel: step-height plane reach (second step window)
  int r_mid;  // veto kernel: window reach (count disc, candidate + trigger)
  int r_ray;  // veto kernel: reach of the ray-fail bits (candidate disc)
  int n_mom_n, n_mom_r, rough_shared, compute_roughness, check_roughness;
  int n_s1, n_s2, n_cnt, n_dirs, n_cand, n_fuse;
  int n_prog;  // entries of the fusion program; 0: the weighted sum
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
  uint8_t prog_op[MAX_PROG];  // opcodes of ops/expr.py
  float prog_arg[MAX_PROG];   // a constant, or a layer: 0 slope, 1 step, 2 roughness
  float slope_crit, slope_rcp, step_crit, step_rcp, ccn_rcp, rough_crit, rough_rcp;
  float veto_crit, slope_ncrit, rough_ncrit;
  // the map's global frame: array cell (i, j) is global cell (i + gi0, j + gj0)
  // of a (gh, gw) map. Cells beyond it are out of map: no elevation, and the
  // step veto's walk ends there (a tile's halo beyond the global map, or the
  // padding that makes a map divide the process grid). (0, 0, H, W): the
  // array is the map.
  int gi0, gj0, gh, gw;
};

// Is array cell (i, j) inside the global map?
__device__ __forceinline__ bool in_global(const FusedParams& p, int i, int j) {
  return (unsigned)(i + p.gi0) < (unsigned)p.gh && (unsigned)(j + p.gj0) < (unsigned)p.gw;
}

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

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
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

// Windowed point moments in local coordinates around the window cell `ec`;
// lin: the taps' linear deltas, d: their metric offsets.
__device__ __forceinline__ Moments moments(const float* ec, int n_off, const int* lin,
                                           const float (*d)[2]) {
  const float zc = isfinite(ec[0]) ? ec[0] : 0.0f;
  Moments m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n_off; ++k) {
    const float nb = ec[lin[k]];
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

// Opcodes of the fusion program, mirrored by ops/expr.py.
enum {
  OP_CONST = 0, OP_LAYER, OP_NEG, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MIN, OP_MAX,
  OP_SQUARE, OP_SQRT, OP_ABS, OP_EXP, OP_LOG, OP_SIN, OP_COS, OP_TAN, OP_ACOS, OP_ASIN,
  OP_ATAN, OP_FLOOR, OP_CEIL, OP_SIGN
};
#define HALF_PI_F (0x1.921fb6p+0f)

// The fusion expression of one cell: the postfix program over the cell's
// slope, step and roughness layers. s0 is the top of the stack; a push
// shifts s0..s6 down into s1..s7, a binary entry folds s1 and s0 into s0 and
// shifts s2..s7 up. The host has checked that the program never holds more
// than MAX_STACK values and ends with one.
__device__ __noinline__ float run_program(const FusedParams& p, float slope, float step,
                                          float rough) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f, s6 = 0.f, s7 = 0.f;
  for (int pc = 0; pc < p.n_prog; ++pc) {
    const int op = p.prog_op[pc];
    if (op <= OP_LAYER) {
      const float a = p.prog_arg[pc];
      s7 = s6; s6 = s5; s5 = s4; s4 = s3; s3 = s2; s2 = s1; s1 = s0;
      s0 = op == OP_CONST ? a : (a == 0.0f ? slope : (a == 1.0f ? step : rough));
    } else if (op >= OP_ADD && op <= OP_MAX) {
      const float a = s1, b = s0;
      float r;
      switch (op) {
        case OP_ADD: r = a + b; break;
        case OP_SUB: r = a - b; break;
        case OP_MUL: r = a * b; break;
        case OP_DIV: r = a / b; break;
        case OP_POW: r = powf(a, b); break;
        case OP_MIN: r = nan_min(a, b); break;
        default: r = nan_max(a, b); break;
      }
      s0 = r;
      s1 = s2; s2 = s3; s3 = s4; s4 = s5; s5 = s6; s6 = s7;
    } else {
      const float x = s0;
      float r;
      switch (op) {
        case OP_NEG: r = -x; break;
        case OP_SQUARE: r = x * x; break;
        case OP_SQRT: r = sqrtf(x); break;
        case OP_ABS: r = fabsf(x); break;
        case OP_EXP: r = expf(x); break;
        case OP_LOG: r = logf(x); break;
        case OP_SIN: r = sinf(x); break;
        case OP_COS: r = cosf(x); break;
        case OP_TAN: r = tanf(x); break;
        case OP_ACOS: r = acos_poly(x); break;
        case OP_ASIN: r = HALF_PI_F - acos_poly(x); break;
        case OP_ATAN: r = atanf(x); break;
        case OP_FLOOR: r = floorf(x); break;
        case OP_CEIL: r = ceilf(x); break;
        default: r = x != x ? x : (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)); break;  // sign
      }
      s0 = r;
    }
  }
  return s0;
}

// Step height at window cell `e`: (max - min) over the first window,
// sentinel-coded; NaN where the cell or the whole window is invalid.
__device__ __forceinline__ float step_height(const float* e, int n_s1, const int* lin) {
  const bool valid = isfinite(e[0]);
  float hmax = NEG_SENT, hmin = POS_SENT;
  for (int k = 0; k < n_s1; ++k) {
    const float v = e[lin[k]];
    const bool fin = isfinite(v);
    hmax = fmaxf(hmax, fin ? v : NEG_SENT);
    hmin = fminf(hmin, fin ? v : POS_SENT);
  }
  const bool any1 = hmax > 0.5f * NEG_SENT;
  return (valid && any1) ? hmax - hmin : NAN;
}

// The layers of one cell: step from the step-height plane at `sc`, slope
// and roughness from the elevation window at `ec`, and the fused layer.
struct CellLayers {
  float step, slope, rough, fused;
};

__device__ __forceinline__ CellLayers cell_layers(const FusedParams& p, const float* ec,
                                                  const float* sc, const int* t_s2,
                                                  const int* t_mn, const int* t_mr) {
  float smax_raw = NEG_SENT, ncrit = 0.0f;
  for (int k = 0; k < p.n_s2; ++k) {
    const float v = sc[t_s2[k]];
    const float shn = isfinite(v) ? v : NEG_SENT;
    smax_raw = fmaxf(smax_raw, shn);
    ncrit = ncrit + (shn > p.step_crit ? 1.0f : 0.0f);
  }
  const bool any2 = smax_raw > 0.5f * NEG_SENT;
  const float smax = fmaxf(smax_raw, 0.0f);
  const float st = fminf(smax, ncrit * p.ccn_rcp * smax);
  const float step_v = st < p.step_crit ? __fmaf_rn(-st, p.step_rcp, 1.0f) : 0.0f;
  CellLayers out;
  out.step = any2 ? step_v : NAN;

  const bool valid = isfinite(ec[0]);
  const Moments m = moments(ec, p.n_mom_n, t_mn, p.mom_n_d);
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

  out.slope = NAN;
  if (isfinite(nz)) {
    const float ac = acos_poly(fminf(fmaxf(nz, -1.0f), 1.0f));
    out.slope = ac < p.slope_crit ? __fmaf_rn(-ac, p.slope_rcp, 1.0f) : 0.0f;
  }

  out.rough = NAN;
  if (p.compute_roughness) {
    const Moments q = p.rough_shared ? m : moments(ec, p.n_mom_r, t_mr, p.mom_r_d);
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
    const float rough_v = rough < p.rough_crit ? __fmaf_rn(-rough, p.rough_rcp, 1.0f) : 0.0f;
    out.rough = has_normal ? rough_v : NAN;
  }

  if (p.n_prog > 0) {
    out.fused = run_program(p, out.slope, out.step, out.rough);
    return out;
  }
  float fused = 0.0f;
  for (int k = 0; k < p.n_fuse; ++k) {
    const int l = p.fuse_layer[k];
    const float x = l == 0 ? out.slope : (l == 1 ? out.step : out.rough);
    fused = fused + p.fuse_w[k] * x;
  }
  out.fused = fused;
  return out;
}

// Ray-walk failures of the step veto from a cell of elevation h, one bit per
// direction, on the walk-coded window at `ec` (t_dir: linear delta of one
// step). A ray fails on a wall (> h + crit) before the walk ends, or on a gap
// (< h - crit; an in-map hole is -inf) that no later in-between cell closes;
// NaN (beyond the map) is neither and does not end the walk. The early exits
// give the verdict of the plain version's full scan: nothing after a wall
// or after the walk's end can change it. A ray whose first cell is no gap
// gets bit 0 without a walk: its trigger (that same neighbour a legal drop
// below h - crit, fused_veto_kernel) is false, so the veto never reads the
// bit.
__device__ __forceinline__ int walk_bits(const FusedParams& p, const float* ec, float h,
                                         const int* t_dir) {
  const float hm = h - p.veto_crit, hp = h + p.veto_crit;
  int b = 0;
  for (int d = 0; d < p.n_dirs; ++d) {
    const int K = p.dirs[d][2], dl = t_dir[d];
    const float* w = ec + dl;
    if (!(*w < hm)) continue;
    bool fail = false, gap = true;
    for (int t = 2; t <= K; ++t) {
      w += dl;
      const float x = *w;
      if (x > hp) {
        fail = true;
        break;
      }
      if (x < hm) {
        gap = true;
      } else if (gap && !isnan(x)) {
        gap = false;
        break;
      }
    }
    if (fail || gap) b |= 1 << d;
  }
  return b;
}

// Candidate-plane value: the elevation of an in-map cell whose step layer is
// 0, else NaN.
__device__ __forceinline__ float cand_elev(float e, float step) {
  return step == 0.0f ? e : NAN;
}

// The veto verdicts of one cell at window index `idx` of the veto planes.
struct CellVeto {
  bool slope_ok, step_ok, rough_ok;
};

__device__ __forceinline__ CellVeto cell_veto(const FusedParams& p, const float* elev,
                                              const float* selev, const uint8_t* zf,
                                              const uint8_t* bits, int idx, const int* t_cnt,
                                              const int* t_cand) {
  const uint8_t zq = zf[idx];
  int zc = 0, rc = 0;
  for (int k = 0; k < p.n_cnt; ++k) {
    const int f = zf[idx + t_cnt[k]];
    zc += f & 1;
    rc += (f >> 1) & 1;
  }
  CellVeto out;
  // counts are small integers: the plain version's float sums are exact
  out.slope_ok = !((zq & 1) && (float)zc > p.slope_ncrit);
  out.rough_ok = !(p.check_roughness && (zq & 2) && (float)rc > p.rough_ncrit);

  const float hp = elev[idx] + p.veto_crit;
  bool has_cand = false, fail_from_cand = false;
  for (int k = 0; k < p.n_cand; ++k) {
    const int c = idx + t_cand[k];
    const bool active = selev[c] > hp;
    has_cand = has_cand || active;
    fail_from_cand = fail_from_cand || (active && (bits[c] & p.cand[k][2]));
  }
  const bool fail_self = bits[idx] != 0;
  out.step_ok = !((zq & 4) && (fail_from_cand || (!has_cand && fail_self)));
  return out;
}

__global__ void __launch_bounds__(K1_THREADS)
fused_layers_kernel(const __grid_constant__ FusedParams p, const float* __restrict__ elevation,
                    int H, int W, float* __restrict__ trav_out, float* __restrict__ slope_out,
                    float* __restrict__ step_out, float* __restrict__ rough_out,
                    uint8_t* __restrict__ walk_out) {
  __shared__ int t_s1[MAX_WIN], t_s2[MAX_WIN], t_mn[MAX_WIN], t_mr[MAX_WIN], t_dir[MAX_DIRS];
  extern __shared__ float smem[];
  const int halo = p.halo, r_sh = p.r_sh;
  const int EA = K1_TILE_W + 2 * halo, RA = K1_TILE_H + 2 * halo;
  const int ES = K1_TILE_W + 2 * r_sh, RS = K1_TILE_H + 2 * r_sh;
  float* walk = smem;
  float* sh = walk + RA * EA;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * K1_TILE_W + tx;
  const int i0 = blockIdx.y * K1_TILE_H, j0 = blockIdx.x * K1_TILE_W;

  if (tid < MAX_WIN) {
    t_s1[tid] = p.s1[tid][0] * EA + p.s1[tid][1];
    t_s2[tid] = p.s2[tid][0] * ES + p.s2[tid][1];
    t_mn[tid] = p.mom_n[tid][0] * EA + p.mom_n[tid][1];
    t_mr[tid] = p.mom_r[tid][0] * EA + p.mom_r[tid][1];
  } else if (tid < MAX_WIN + MAX_DIRS) {
    const int d = tid - MAX_WIN;
    t_dir[d] = p.dirs[d][0] * EA + p.dirs[d][1];
  }
  // A. the walk-coded elevation window
#pragma unroll 4
  for (int r = ty; r < RA; r += K1_TILE_H) {
    const int gi = i0 - halo + r;
#pragma unroll 2
    for (int c = tx; c < EA; c += K1_TILE_W) {
      const int gj = j0 - halo + c;
      float w = NAN;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W && in_global(p, gi, gj)) {
        const float e = elevation[(long)gi * W + gj];
        w = isfinite(e) ? e : -INFINITY;
      }
      walk[r * EA + c] = w;
    }
  }
  __syncthreads();

  // B. step height over the tile + r_sh
  for (int r = ty; r < RS; r += K1_TILE_H)
    for (int c = tx; c < ES; c += K1_TILE_W)
      sh[r * ES + c] = step_height(walk + (r - r_sh + halo) * EA + (c - r_sh + halo), p.n_s1, t_s1);
  __syncthreads();

  // C. the layers and the ray walks of this thread's cell
  const int gi = i0 + ty, gj = j0 + tx;
  if (gi >= H || gj >= W) return;
  const float* ec = walk + (ty + halo) * EA + tx + halo;
  const CellLayers l = cell_layers(p, ec, sh + (ty + r_sh) * ES + tx + r_sh, t_s2, t_mn, t_mr);
  const long g = (long)gi * W + gj;
  trav_out[g] = l.fused;
  slope_out[g] = l.slope;
  step_out[g] = l.step;
  if (p.compute_roughness) rough_out[g] = l.rough;
  walk_out[g] = (uint8_t)walk_bits(p, ec, in_global(p, gi, gj) ? elevation[g] : NAN, t_dir);
}

__global__ void __launch_bounds__(K1V_THREADS)
fused_veto_kernel(const __grid_constant__ FusedParams p, const float* __restrict__ elevation,
                  const float* __restrict__ step, const float* __restrict__ slope,
                  const float* __restrict__ rough, const uint8_t* __restrict__ walk_in, int H,
                  int W, uint8_t* __restrict__ slope_ok_out, uint8_t* __restrict__ step_ok_out,
                  uint8_t* __restrict__ rough_ok_out, uint8_t* __restrict__ mask_out,
                  float* __restrict__ slope_fp, float* __restrict__ step_fp,
                  float* __restrict__ rough_fp) {
  __shared__ int t_cnt[MAX_COUNT], t_cand[MAX_CAND], t_dir[MAX_DIRS];
  extern __shared__ float smem[];
  const int r_mid = p.r_mid, r_ray = p.r_ray;
  const int EM = K1_TILE_W + 2 * r_mid, RM = K1V_TILE_H + 2 * r_mid;
  float* elev = smem;
  float* selev = elev + RM * EM;
  uint8_t* zf = reinterpret_cast<uint8_t*>(selev + RM * EM);  // bit 0 slope, 1 rough, 2 step == 0
  uint8_t* bits = zf + RM * EM;  // the walk failures, then the ray-fail bits
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * K1_TILE_W + tx;
  const int i0 = blockIdx.y * K1V_TILE_H, j0 = blockIdx.x * K1_TILE_W;

  for (int k = tid; k < MAX_COUNT + MAX_CAND + MAX_DIRS; k += K1V_THREADS) {
    if (k < MAX_COUNT) {
      t_cnt[k] = p.cnt[k][0] * EM + p.cnt[k][1];
    } else if (k < MAX_COUNT + MAX_CAND) {
      const int c = k - MAX_COUNT;
      t_cand[c] = p.cand[c][0] * EM + p.cand[c][1];
    } else {
      const int d = k - MAX_COUNT - MAX_CAND;
      t_dir[d] = p.dirs[d][0] * EM + p.dirs[d][1];
    }
  }
  // the veto planes over the tile + r_mid
#pragma unroll 4
  for (int r = ty; r < RM; r += K1V_TILE_H) {
    const int gi = i0 - r_mid + r;
#pragma unroll 2
    for (int c = tx; c < EM; c += K1_TILE_W) {
      const int gj = j0 - r_mid + c;
      float e = NAN, se = NAN;
      int f = 0, wb = 0;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
        const long g = (long)gi * W + gj;
        const float st = step[g];
        e = in_global(p, gi, gj) ? elevation[g] : NAN;
        se = cand_elev(e, st);
        f = (slope[g] == 0.0f ? 1 : 0) | (p.check_roughness && rough[g] == 0.0f ? 2 : 0) |
            (st == 0.0f ? 4 : 0);
        wb = walk_in[g];
      }
      elev[r * EM + c] = e;
      selev[r * EM + c] = se;
      zf[r * EM + c] = (uint8_t)f;
      bits[r * EM + c] = (uint8_t)wb;
    }
  }
  __syncthreads();

  // ray-fail bits over the tile + r_ray, in place: walk failures whose
  // trigger holds (the neighbour one step along the ray is a legal drop
  // below h - crit). A thread reads and writes only its own cells' bytes
  // here; other threads read no bits until the barrier.
  for (int r = ty; r < K1V_TILE_H + 2 * r_ray; r += K1V_TILE_H) {
    const int rr = r + r_mid - r_ray;
    for (int c = tx; c < K1_TILE_W + 2 * r_ray; c += K1_TILE_W) {
      const int idx = rr * EM + c + r_mid - r_ray;
      const int wb = bits[idx];
      const float hm = elev[idx] - p.veto_crit;
      int b = 0;
      for (int d = 0; d < p.n_dirs; ++d)
        if (((wb >> d) & 1) && selev[idx + t_dir[d]] < hm) b |= 1 << d;
      bits[idx] = (uint8_t)b;
    }
  }
  __syncthreads();

  const int gi = i0 + ty, gj = j0 + tx;
  if (gi >= H || gj >= W) return;
  const int idx = (ty + r_mid) * EM + tx + r_mid;
  const CellVeto v = cell_veto(p, elev, selev, zf, bits, idx, t_cnt, t_cand);
  const uint8_t zq = zf[idx];
  const long g = (long)gi * W + gj;
  slope_ok_out[g] = v.slope_ok;
  step_ok_out[g] = v.step_ok;
  mask_out[g] = v.slope_ok && v.step_ok && v.rough_ok;
  slope_fp[g] = (zq & 1) ? (v.slope_ok ? 1.0f : 0.0f) : NAN;
  step_fp[g] = (zq & 4) ? (v.step_ok ? 1.0f : 0.0f) : NAN;
  if (p.check_roughness) {
    rough_ok_out[g] = v.rough_ok;
    rough_fp[g] = (zq & 2) ? (v.rough_ok ? 1.0f : 0.0f) : NAN;
  }
}

static size_t smem_layers(const FusedParams& p) {
  const size_t EA = K1_TILE_W + 2 * p.halo, RA = K1_TILE_H + 2 * p.halo;
  const size_t ES = K1_TILE_W + 2 * p.r_sh, RS = K1_TILE_H + 2 * p.r_sh;
  return sizeof(float) * (EA * RA + ES * RS);
}

static size_t smem_veto(const FusedParams& p) {
  const size_t EM = K1_TILE_W + 2 * p.r_mid, RM = K1V_TILE_H + 2 * p.r_mid;
  return (2 * sizeof(float) + 2) * EM * RM;
}

// Raise a kernel's dynamic shared-memory cap where a launch needs more than
// the default 48 KB; never lower it.
static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The launch plan's grid and block tile an (H, W) map with this tile:
// every cell covered, no block wholly outside.
static bool plan_tiles_map(const int* grid, const int* block, int tile_h, int H, int W) {
  return block[0] == K1_TILE_W && block[1] == tile_h && grid[0] >= 1 && grid[1] >= 1 &&
         grid[0] * K1_TILE_W >= W && (grid[0] - 1) * K1_TILE_W < W && grid[1] * tile_h >= H &&
         (grid[1] - 1) * tile_h < H;
}

extern "C" {

int te_fused_update_params_size() { return (int)sizeof(FusedParams); }

const char* te_fused_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks per SM of the layers (which == 0) or veto (1) kernel with
// this dynamic shared memory, or -1 on error.
int te_fused_update_occupancy(int which, int smem) {
  const void* k = which == 0 ? (const void*)fused_layers_kernel : (const void*)fused_veto_kernel;
  int blocks = -1;
  cudaError_t e = allow_smem(k, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      which == 0 ? K1_THREADS : K1V_THREADS, smem);
  return e == cudaSuccess ? blocks : -1;
}

// elevation (H, W) f32 in; scratch walk (H, W) uint8; outputs (H, W):
// traversability, slope, step, roughness (written only with
// compute_roughness) f32; slope_ok, step_ok, roughness_ok (only with
// check_roughness), traversable_mask uint8 0/1; slope, step, roughness (only
// with check_roughness) footprint f32. All device pointers; params is a host
// pointer, passed by value to both kernels. plan: the launch plan,
// {layers grid x, y, block x, y, dynamic shared memory, then the same five
// for the veto kernel}, launched as given once it is checked against this
// file's tiles and shared-memory counts (cudaErrorInvalidValue where they
// differ). Returns the first launch error.
int te_fused_update(const float* elevation, int H, int W, const FusedParams* params,
                    const int* plan, float* trav, float* slope, float* step, float* rough,
                    uint8_t* walk, uint8_t* slope_ok, uint8_t* step_ok, uint8_t* rough_ok,
                    uint8_t* mask, float* slope_fp, float* step_fp, float* rough_fp,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const FusedParams& p = *params;
  const int *lg = plan, *lb = plan + 2, *vg = plan + 5, *vb = plan + 7;
  const int smem_l = plan[4], smem_v = plan[9];
  if (!plan_tiles_map(lg, lb, K1_TILE_H, H, W) || !plan_tiles_map(vg, vb, K1V_TILE_H, H, W) ||
      (size_t)smem_l != smem_layers(p) || (size_t)smem_v != smem_veto(p))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)fused_layers_kernel, smem_l);
  if (e == cudaSuccess) e = allow_smem((const void*)fused_veto_kernel, smem_v);
  if (e != cudaSuccess) return (int)e;
  fused_layers_kernel<<<dim3(lg[0], lg[1]), dim3(lb[0], lb[1]), smem_l, s>>>(
      p, elevation, H, W, trav, slope, step, rough, walk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_veto_kernel<<<dim3(vg[0], vg[1]), dim3(vb[0], vb[1]), smem_v, s>>>(
      p, elevation, step, slope, rough, walk, H, W, slope_ok, step_ok, rough_ok, mask, slope_fp,
      step_fp, rough_fp);
  return (int)cudaGetLastError();
}

}  // extern "C"
