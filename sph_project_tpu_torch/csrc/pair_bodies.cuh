// The SPH pair bodies of the ported steps (DFSPH, WCSPH, PCISPH, IISPH, over
// fluid, static walls and dynamic rigid bodies, with standard or implicit
// viscosity) as device functors, the arguments they read and the cubic
// spline. Both pair kernels include this header
// (pair_pass.cu: the cell-list engine; pair_slab.cu: the slab-window
// engine), so a body is written once and runs under either engine, as a body
// of the JAX package written against ops/pair_exec.Cx runs under either of
// its executors. Each functor stands next to its plain PyTorch body in
// ops/pair_kernels.py and keeps that body's expression order.
//
// A body has NOUT output sums; load() reads row i's own fields, pair() adds
// one neighbour j that the engine accepted (j != i, |x_i - x_j|^2 < h^2),
// given R = x_i - x_j and d2 = |R|^2. A body with outputs for dynamic rigid
// bodies (the fluid->rigid wrenches, the same-object kernel sum) is a
// template on RIGID; flags & FLAG_RIGID launches the instance that adds them,
// into sums after its other outputs, and the instance without it is the body
// with no rigid outputs at all.
//
// Rounding: both kernels are built with -fmad=false and without fast math,
// so the squared distance ((R0*R0 + R1*R1) + R2*R2) and every body
// expression round like the unfused float32 tensor ops of the plain versions.
// All constants arrive in c[] as floats the host folded in double.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MATERIAL_FLUID 1
#define MATERIAL_RIGID 2
#define N_CONST 16
#define FLAG_COUNT 1  // divergence: also count the neighbours
#define FLAG_RIGID 2  // the outputs of dynamic rigid bodies

enum Body {
  BODY_DENSITY = 0,
  BODY_ALPHA = 1,
  BODY_NONPRESSURE = 2,
  BODY_DIVERGENCE = 3,
  BODY_CORRECTION = 4,
  BODY_DENSITY_ALPHA_DIVERGENCE = 5,
  BODY_RIGID_VOLUME = 6,
  BODY_NONPRESSURE_WARM = 7,
  BODY_PRESSURE = 8,
  BODY_PCISPH_DENSITY_PRED = 9,
  BODY_IISPH_DII = 10,
  BODY_IISPH_AII = 11,
  BODY_IISPH_DENSITY_STAR = 12,
  BODY_IISPH_DIJ_PJ = 13,
  BODY_IISPH_SUM_I = 14,
  BODY_RIGID_CONTACT = 15,
  BODY_VISC_PREP = 16,
  BODY_VISC_MATVEC = 17,
};

// Mirrors ops/pair_kernels.py PairArgs (ctypes), field for field.
struct PairArgs {
  const float* pos;          // (n, 3)
  const float* vel;          // (n, 3)
  const int* cells;          // (n,) sorted flat cell ids
  const int* cell_start;     // (gx*gy*gz + 1,)                 [cell-list]
  const uint8_t* produce;    // (n,) rows whose sums are read
  const int* material;       // (n,)
  const int* object_id;      // (n,)
  const int* is_dynamic;     // (n,)                            [FLAG_RIGID]
  const float* rest_volume;  // (n,)
  const float* mass;         // (n,)
  const float* inv_rho;      // (n,)
  const float* kappa;        // (n,)
  const float* k_rho;        // (n,)
  const float* pressure;     // (n,)
  const float* density;      // (n,)
  const float* p_rho2;       // (n,) pressure / max(density^2, 1e-12)
  const float* dpi;          // (n,) rho0 V / max(density^2, 1e-12)
  const float* inv_star2;    // (n,) 1 / max(previous rho*^2, 1e-12)
  const float* pred;         // (n, 3) predicted positions
  const float* dii;          // (n, 3)
  const float* dij_pj;       // (n, 3)
  const float* x;            // (n, 3) the CG's vector            [visc_matvec]
  const float* com;          // (objects, 3) body com table     [pressure]
  const int* chan;           // (objects,) contact channel      [contact]
  const int* starts;         // (n / block, 9) window starts    [slab]
  const int* lens;           // (n / block, 9) window lengths   [slab]
  float* out;                // (n_out, n)
  int n, gx, gy, gz;
  int flags;                 // FLAG_COUNT, FLAG_RIGID
  int block;                 // rows per particle block         [slab]
  int n_chan;                // contact channels                [contact]
  float dh2;
  // c[0..3] = h, k, 2k, 6k/h^2 (cubic spline); c[4..] body constants
  float c[N_CONST];
};

// cubic spline W and gw (gradW = gw * R) from the squared distance, as
// ops/kernels.py cubic_w_gw_d2
__device__ __forceinline__ float cubic_q(float d2, const float* c, float* inv_r) {
  *inv_r = sqrtf(1.0f / fmaxf(d2, 1e-24f));
  return fminf(d2 * *inv_r / c[0], 1.0f);
}

__device__ __forceinline__ float cubic_w(float d2, const float* c) {
  float inv_r;
  const float q = cubic_q(d2, c, &inv_r);
  if (q <= 0.5f) {
    const float q2 = q * q;
    return c[1] * (6.0f * q * q2 - 6.0f * q2 + 1.0f);
  }
  const float one_q = 1.0f - q;
  return c[2] * one_q * one_q * one_q;
}

__device__ __forceinline__ float cubic_gw(float d2, const float* c) {
  float inv_r;
  const float q = cubic_q(d2, c, &inv_r);
  const float one_q = 1.0f - q;
  const float g = (q <= 0.5f) ? (3.0f * q - 2.0f) : (-one_q * one_q * (c[0] * inv_r));
  return d2 > 1e-10f ? c[3] * g : 0.0f;
}

struct Density {  // common.compute_density: s
  static constexpr int NOUT = 1;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float*, float d2, float* acc) {
    acc[0] += a.rest_volume[j] * cubic_w(d2, a.c);
  }
};

struct Alpha {  // dfsph.compute_alpha: sum_sq, vec0..2
  static constexpr int NOUT = 4;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float cc = -a.rest_volume[j] * cubic_gw(d2, a.c);
    if (a.material[j] == MATERIAL_FLUID) acc[0] += cc * cc * d2;
    for (int d = 0; d < 3; ++d) acc[1 + d] += cc * R[d];
  }
};

// A functor with outputs for dynamic rigid bodies takes them as a template
// flag RIGID: launch_body picks the instance from flags & FLAG_RIGID, so the
// instance without it is the plain body, with no wrench sums, loads or
// branches. Row i of a RIGID instance is a wrench row when it is a dynamic
// rigid particle.
__device__ __forceinline__ bool wrench_row(const PairArgs& a, int i) {
  return a.material[i] == MATERIAL_RIGID && a.is_dynamic[i] > 0;
}

// common._nonpressure_outputs: st0..2, acc0..2, and under RIGID on dynamic
// rigid rows the viscosity force from fluid neighbours at acc[W..W+2]
// (fpp0..2). c[4] diam^2, c[5] W(diam), c[6] 0.01 h^2, c[7] d2c*viscosity,
// c[8] d2c*viscosity_b, c[9] density0
template <bool RIGID, int W = 6>
struct NonpressureAt {
  static constexpr int NOUT = RIGID ? W + 3 : 6;
  float v[3], m_i, inv_rho_i, vol_i;
  bool wrench;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
    m_i = a.mass[i];
    inv_rho_i = a.inv_rho[i];
    if (RIGID) {
      wrench = wrench_row(a, i);
      vol_i = a.rest_volume[i];
    }
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const float gw = cubic_gw(d2, c);
    const int mat_j = a.material[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID;
    const bool rigid_j = mat_j == MATERIAL_RIGID;
    const float m_j = a.mass[j];
    if (fluid_j) {
      const float wst = d2 > c[4] ? cubic_w(d2, c) : c[5];
      const float mw = m_j * wst;
      for (int d = 0; d < 3; ++d) acc[d] += mw * R[d];
    }
    const float v_xy = (v[0] - a.vel[3 * j]) * R[0] + (v[1] - a.vel[3 * j + 1]) * R[1] +
                       (v[2] - a.vel[3 * j + 2]) * R[2];
    const float inv_denom = 1.0f / (d2 + c[6]);
    float coef = 0.0f;
    if (fluid_j) {
      const float m_ij = 0.5f * (m_i + m_j);
      coef = c[7] * m_ij * a.inv_rho[j] * inv_denom * v_xy;
    } else if (rigid_j) {
      const float m_b = c[9] * a.rest_volume[j];
      coef = c[8] * m_b * inv_rho_i * inv_denom * v_xy;
    }
    coef = coef * gw;
    for (int d = 0; d < 3; ++d) acc[3 + d] += coef * R[d];
    if (RIGID && wrench && fluid_j) {
      const float cw = c[8] * vol_i * m_j * a.inv_rho[j] * inv_denom * v_xy * gw;
      for (int d = 0; d < 3; ++d) acc[W + d] += cw * R[d];
    }
  }
};

struct Divergence {  // dfsph._divergence_sum: s (, cnt)
  static constexpr int NOUT = 2;
  float v[3];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float dv_r = (v[0] - a.vel[3 * j]) * R[0] + (v[1] - a.vel[3 * j + 1]) * R[1] +
                       (v[2] - a.vel[3 * j + 2]) * R[2];
    acc[0] += a.rest_volume[j] * dv_r * cubic_gw(d2, a.c);
    acc[1] += 1.0f;
  }
};

// dfsph._correction_outputs: dv0..2, and under RIGID on dynamic rigid rows
// the force from fluid neighbours at acc[W..W+2] (fp0..2). c[C0]
// dfsph_eps*dt, c[C0 + 1] density0, c[C0 + 2] dt
template <bool RIGID, int C0 = 4, int W = 3>
struct CorrectionAt {
  static constexpr int NOUT = RIGID ? W + 3 : 3;
  float k_i, kr_i, vol_i;
  bool wrench;
  __device__ void load(const PairArgs& a, int i) {
    k_i = a.kappa[i];
    kr_i = a.k_rho[i];
    if (RIGID) {
      wrench = wrench_row(a, i);
      vol_i = a.rest_volume[i];
    }
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const int mat_j = a.material[j];
    if (!RIGID) {
      const bool fluid_j = mat_j == MATERIAL_FLUID && fabsf(k_i + a.kappa[j]) > c[C0];
      const bool rigid_j = mat_j == MATERIAL_RIGID && fabsf(k_i) > c[C0];
      if (!(fluid_j || rigid_j)) return;
      const float vgw = a.rest_volume[j] * cubic_gw(d2, c);
      const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
      const float coef = k * c[C0 + 1] * vgw;
      for (int d = 0; d < 3; ++d) acc[d] += -coef * R[d];
      return;
    }
    const float k_j = a.kappa[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID && fabsf(k_i + k_j) > c[C0];
    const bool rigid_j = mat_j == MATERIAL_RIGID && fabsf(k_i) > c[C0];
    const bool wrench_j = wrench && mat_j == MATERIAL_FLUID && fabsf(k_j) > c[C0];
    if (!(fluid_j || rigid_j || wrench_j)) return;
    const float gw = cubic_gw(d2, c);
    if (fluid_j || rigid_j) {
      const float vgw = a.rest_volume[j] * gw;
      const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
      const float coef = k * c[C0 + 1] * vgw;
      for (int d = 0; d < 3; ++d) acc[d] += -coef * R[d];
    }
    if (wrench_j) {
      const float cw = -vol_i * a.k_rho[j] * c[C0 + 1] / c[C0 + 2] *
                       (a.rest_volume[j] * c[C0 + 1]) * gw;
      for (int d = 0; d < 3; ++d) acc[W + d] += cw * R[d];
    }
  }
};

// dfsph.nonpressure_warm_fused: the non-pressure sums and the warm-start
// correction in one pass: st0..2, acc0..2, wdv0..2, then under RIGID on
// dynamic rigid rows both wrenches, fpp0..2 and wfp0..2. Constants: the
// non-pressure ones at c[4..9], the correction's at c[10..12].
template <bool RIGID>
struct NonpressureWarm {
  static constexpr int NOUT = RIGID ? 15 : 9;
  NonpressureAt<RIGID, 9> nonpressure;     // st, acc at 0..5; fpp at 9..11
  CorrectionAt<RIGID, 10, 6> correction;  // at 6: wdv at 6..8; wfp at 12..14
  __device__ void load(const PairArgs& a, int i) {
    nonpressure.load(a, i);
    correction.load(a, i);
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    nonpressure.pair(a, j, R, d2, acc);
    correction.pair(a, j, R, d2, acc + 6);
  }
};

template <bool RIGID>
struct DensityAlphaDivergence {  // dfsph.density_alpha_divergence
  // outputs: sd, sum_sq, sv, cnt, vec0..2, and under RIGID svol, the
  // same-object W sum of the rigid pseudo-volumes
  static constexpr int NOUT = RIGID ? 8 : 7;
  float v[3];
  int obj;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
    if (RIGID) obj = a.object_id[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float vj = a.rest_volume[j];
    const float gw = cubic_gw(d2, a.c);
    const float cc = -vj * gw;
    const float dv_r = (v[0] - a.vel[3 * j]) * R[0] + (v[1] - a.vel[3 * j + 1]) * R[1] +
                       (v[2] - a.vel[3 * j + 2]) * R[2];
    const float w = cubic_w(d2, a.c);
    acc[0] += vj * w;
    if (a.material[j] == MATERIAL_FLUID) acc[1] += cc * cc * d2;
    acc[2] += vj * dv_r * gw;
    acc[3] += 1.0f;
    for (int d = 0; d < 3; ++d) acc[4 + d] += cc * R[d];
    if (RIGID && a.object_id[j] == obj) acc[7] += w;
  }
};

struct RigidVolume {  // same-object W sum (common.compute_rigid_volume_fixedk)
  static constexpr int NOUT = 1;
  int obj;
  __device__ void load(const PairArgs& a, int i) { obj = a.object_id[i]; }
  __device__ void pair(const PairArgs& a, int j, const float*, float d2, float* acc) {
    if (a.object_id[j] == obj) acc[0] += cubic_w(d2, a.c);
  }
};

// cubic spline W from the distance, with its own q <= 1 cutoff, as
// ops/kernels.py cubic_W (the r-form; the d2-form above leaves the cutoff to
// the pair mask)
__device__ __forceinline__ float cubic_W_r(float r, const float* c) {
  const float q = r / c[0];
  const float q2 = q * q;
  float w;
  if (q <= 0.5f) {
    w = c[1] * (6.0f * q * q2 - 6.0f * q2 + 1.0f);
  } else {
    const float one_q = 1.0f - q;
    w = c[2] * one_q * one_q * one_q;
  }
  return q <= 1.0f ? w : 0.0f;
}

// The bodies of WCSPH, PCISPH and IISPH. A neighbour that is neither fluid
// nor rigid adds a signed zero in the plain versions and is skipped here,
// which leaves every sum unchanged. c[4] is density0 where a body reads it.

// common.pressure_acceleration: acc0..2, and under RIGID on dynamic rigid
// rows the force fpp0..2 and torque tpp0..2 from fluid neighbours, the torque
// per pair about the body's com (com, a table per object) with the fluid
// particle's position x_i - R as its point.
template <bool RIGID>
struct Pressure {
  static constexpr int NOUT = RIGID ? 9 : 3;
  float pr_i, vol_i, x[3], com[3];
  bool wrench;
  __device__ void load(const PairArgs& a, int i) {
    pr_i = a.p_rho2[i];
    if (!RIGID) return;
    wrench = wrench_row(a, i);
    vol_i = a.rest_volume[i];
    const int o = wrench ? a.object_id[i] : 0;
    for (int d = 0; d < 3; ++d) {
      x[d] = a.pos[3 * i + d];
      com[d] = wrench ? a.com[3 * o + d] : 0.0f;
    }
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    float term;
    if (mat_j == MATERIAL_FLUID) {
      term = a.mass[j] * (pr_i + a.p_rho2[j]);
    } else if (mat_j == MATERIAL_RIGID) {
      term = a.c[4] * a.rest_volume[j] * pr_i;
    } else {
      return;
    }
    const float gw = cubic_gw(d2, a.c);
    term = term * gw;
    for (int d = 0; d < 3; ++d) acc[d] += -term * R[d];
    if (RIGID && wrench && mat_j == MATERIAL_FLUID) {
      const float cw = -(a.c[4] * vol_i) * a.p_rho2[j] * (a.c[4] * a.rest_volume[j]) * gw;
      float f[3], arm[3];
      for (int d = 0; d < 3; ++d) {
        f[d] = cw * R[d];
        arm[d] = x[d] - R[d] - com[d];
      }
      for (int d = 0; d < 3; ++d) acc[3 + d] += f[d];
      acc[6] += arm[1] * f[2] - arm[2] * f[1];
      acc[7] += arm[2] * f[0] - arm[0] * f[2];
      acc[8] += arm[0] * f[1] - arm[1] * f[0];
    }
  }
};

// pcisph._density_star_predicted: s. The engine accepted j on the sorted
// positions; W is taken at the predicted distance, where a non-fluid j keeps
// its position.
struct PcisphDensityPred {
  static constexpr int NOUT = 1;
  float p[3];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) p[d] = a.pred[3 * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float*, float, float* acc) {
    const float* xj = (a.material[j] == MATERIAL_FLUID ? a.pred : a.pos) + 3 * j;
    const float r0 = p[0] - xj[0], r1 = p[1] - xj[1], r2 = p[2] - xj[2];
    const float d2p = r0 * r0 + r1 * r1 + r2 * r2;
    acc[0] += a.rest_volume[j] * cubic_W_r(sqrtf(d2p), a.c);
  }
};

struct IisphDii {  // iisph.compute_dii: dii0..2
  static constexpr int NOUT = 3;
  float inv_star2_i;
  __device__ void load(const PairArgs& a, int i) { inv_star2_i = a.inv_star2[i]; }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    const float rho0v = a.c[4] * a.rest_volume[j];
    float cc;
    if (mat_j == MATERIAL_FLUID) {
      const float rho = a.density[j];
      cc = -rho0v / fmaxf(rho * rho, 1e-12f);
    } else if (mat_j == MATERIAL_RIGID) {
      cc = -rho0v * inv_star2_i;
    } else {
      return;
    }
    cc = cc * cubic_gw(d2, a.c);
    for (int d = 0; d < 3; ++d) acc[d] += cc * R[d];
  }
};

struct IisphAii {  // iisph.compute_aii, before the dt^2 factor: s
  static constexpr int NOUT = 1;
  float dii[3], dpi;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) dii[d] = a.dii[3 * i + d];
    dpi = a.dpi[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float gw = cubic_gw(d2, a.c);
    const float rho0v_j = a.c[4] * a.rest_volume[j];
    float term = 0.0f;
    for (int d = 0; d < 3; ++d) term = term + (dii[d] - dpi * gw * R[d]) * gw * R[d];
    acc[0] += rho0v_j * term;
  }
};

struct IisphDensityStar {  // iisph.compute_density_star, before the dt factor: s
  static constexpr int NOUT = 1;
  float v[3];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float dv_r = (v[0] - a.vel[3 * j]) * R[0] + (v[1] - a.vel[3 * j + 1]) * R[1] +
                       (v[2] - a.vel[3 * j + 2]) * R[2];
    acc[0] += a.c[4] * a.rest_volume[j] * dv_r * cubic_gw(d2, a.c);
  }
};

struct IisphDijPj {  // dij_pj_op of iisph.refine: dp0..2 (fluid j only)
  static constexpr int NOUT = 3;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (a.material[j] != MATERIAL_FLUID) return;
    const float rho = a.density[j];
    const float rho_j2 = fmaxf(rho * rho, 1e-12f);
    const float rho0v = a.c[4] * a.rest_volume[j];
    const float cc = -rho0v * a.pressure[j] / rho_j2 * cubic_gw(d2, a.c);
    for (int d = 0; d < 3; ++d) acc[d] += cc * R[d];
  }
};

// sum_i_op of iisph.refine, before the dt^2 factor: s. dij_pj is row i's
// (loaded) and neighbour j's (read per pair) from one array.
struct IisphSumI {
  static constexpr int NOUT = 1;
  float dij[3], dpi, pr_i;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) dij[d] = a.dij_pj[3 * i + d];
    dpi = a.dpi[i];
    pr_i = a.pressure[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    if (mat_j != MATERIAL_FLUID && mat_j != MATERIAL_RIGID) return;
    const float gw = cubic_gw(d2, a.c);
    const float rho0v_j = a.c[4] * a.rest_volume[j];
    float t = 0.0f;
    if (mat_j == MATERIAL_FLUID) {
      const float pr_j = a.pressure[j];
      for (int d = 0; d < 3; ++d) {
        const float d_ji_pi = dpi * gw * R[d] * pr_i;
        const float inner = dij[d] - a.dii[3 * j + d] * pr_j - (a.dij_pj[3 * j + d] - d_ji_pi);
        t = t + inner * gw * R[d];
      }
    } else {
      for (int d = 0; d < 3; ++d) t = t + dij[d] * gw * R[d];
    }
    acc[0] += rho0v_j * t;
  }
};

// integrator.rigid_contact_data: on a rigid row, per contact channel k, the
// penetration-weighted sums over rigid neighbours of another object closer
// than one particle diameter (c[4]): weight cw at acc[4k], normal cn at
// acc[4k+1..4k+3]. The neighbour's channel is chan[its object]: the object's
// index among the dynamic bodies, the last channel for static geometry, < 0
// for none. The channel count is a launch argument (n_chan <= CMAX); the
// sums stay in registers because the loop over channels is unrolled, each
// channel's sums indexed by a constant.
template <int CMAX>
struct RigidContact {
  static constexpr int NOUT = 4 * CMAX;
  int obj;
  bool rigid_i;
  __device__ void load(const PairArgs& a, int i) {
    obj = a.object_id[i];
    rigid_i = a.material[i] == MATERIAL_RIGID;
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (!rigid_i || a.material[j] != MATERIAL_RIGID) return;
    const int oj = a.object_id[j];
    if (oj == obj || oj < 0) return;
    const float dist = sqrtf(d2);
    if (!(dist < a.c[4])) return;
    const int ch = a.chan[oj];
    if (ch < 0) return;
    const float pen = a.c[4] - dist;
    const float inv_dist = 1.0f / fmaxf(dist, 1e-9f);
#pragma unroll
    for (int k = 0; k < CMAX; ++k) {
      if (k == ch) {
        acc[4 * k] += pen;
        for (int d = 0; d < 3; ++d) acc[4 * k + 1 + d] += pen * R[d] * inv_dist;
      }
    }
  }
};

// The two passes of the implicit viscosity solve (viscosity_cg.py). Both
// produce on fluid rows and skip a neighbour that is neither fluid nor rigid
// (the plain versions add a signed zero for it). c_ij is the coefficient of
// A_ij = c_ij gradW (x) R (cij): for fluid j c[5] m_ij / rho_j / (d2 + c[4]),
// for rigid j c[6] (c[7] V_j) / rho_i / (d2 + c[4]). c[4] 0.01 h^2, c[5]
// -d2c*viscosity, c[6] -d2c*viscosity_b, c[7] density0, c[8]
// d2c*viscosity_b*density0.
__device__ __forceinline__ float visc_c_fluid(const PairArgs& a, int j, float m_i,
                                              float inv_denom) {
  float rho_j = a.density[j];
  rho_j = rho_j > 0.0f ? rho_j : 1.0f;
  const float m_ij = 0.5f * (m_i + a.mass[j]);
  return a.c[5] * m_ij / rho_j * inv_denom;
}

// prep_kern: Axx, Axy, Axz, Ayy, Ayz, Azz (sums of c_ij gw R_a R_b over fluid
// and rigid j), then br0..2 (the rigid neighbours' velocity term of b)
struct ViscPrep {
  static constexpr int NOUT = 9;
  float m_i, inv_rho_i;
  __device__ void load(const PairArgs& a, int i) {
    m_i = a.mass[i];
    inv_rho_i = a.inv_rho[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const int mat_j = a.material[j];
    const bool rigid_j = mat_j == MATERIAL_RIGID;
    if (mat_j != MATERIAL_FLUID && !rigid_j) return;
    const float gw = cubic_gw(d2, c);
    const float inv_denom = 1.0f / (d2 + c[4]);
    const float cc = rigid_j ? c[6] * (c[7] * a.rest_volume[j]) * inv_rho_i * inv_denom
                             : visc_c_fluid(a, j, m_i, inv_denom);
    const float cg = cc * gw;
    acc[0] += cg * R[0] * R[0];
    acc[1] += cg * R[0] * R[1];
    acc[2] += cg * R[0] * R[2];
    acc[3] += cg * R[1] * R[1];
    acc[4] += cg * R[1] * R[2];
    acc[5] += cg * R[2] * R[2];
    if (rigid_j) {
      const float v_dot_r = a.vel[3 * j] * R[0] + a.vel[3 * j + 1] * R[1] + a.vel[3 * j + 2] * R[2];
      const float cb = c[8] * a.rest_volume[j] * inv_rho_i * v_dot_r * inv_denom * gw;
      for (int d = 0; d < 3; ++d) acc[6 + d] += cb * R[d];
    }
  }
};

// the CG matvec kern: acc0..2, sums over fluid j of -c_ij gw (R . x_j) R
struct ViscMatvec {
  static constexpr int NOUT = 3;
  float m_i;
  __device__ void load(const PairArgs& a, int i) { m_i = a.mass[i]; }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (a.material[j] != MATERIAL_FLUID) return;
    const float gw = cubic_gw(d2, a.c);
    const float inv_denom = 1.0f / (d2 + a.c[4]);
    const float cc = visc_c_fluid(a, j, m_i, inv_denom);
    const float s = R[0] * a.x[3 * j] + R[1] * a.x[3 * j + 1] + R[2] * a.x[3 * j + 2];
    const float contrib = -cc * gw * s;
    for (int d = 0; d < 3; ++d) acc[d] += contrib * R[d];
  }
};

// channel counts the contact body is built for: the count of a launch picks
// the least that holds it
#define CONTACT_CHANNELS_SMALL 4
#define CONTACT_CHANNELS_MEDIUM 12
#define CONTACT_CHANNELS_MAX 27

// Runs Launch<Body>::run(a, outputs written, stream) for body id `body` and
// returns its CUDA error code (0 = launched). Each engine gives its own Launch.
template <template <class> class Launch>
static int launch_body(int body, const PairArgs& a, cudaStream_t s) {
  const bool rigid = a.flags & FLAG_RIGID;
  switch (body) {
    case BODY_DENSITY: return Launch<Density>::run(a, 1, s);
    case BODY_ALPHA: return Launch<Alpha>::run(a, 4, s);
    case BODY_NONPRESSURE:
      return rigid ? Launch<NonpressureAt<true>>::run(a, 9, s)
                   : Launch<NonpressureAt<false>>::run(a, 6, s);
    case BODY_DIVERGENCE: return Launch<Divergence>::run(a, (a.flags & FLAG_COUNT) ? 2 : 1, s);
    case BODY_CORRECTION:
      return rigid ? Launch<CorrectionAt<true>>::run(a, 6, s)
                   : Launch<CorrectionAt<false>>::run(a, 3, s);
    case BODY_DENSITY_ALPHA_DIVERGENCE:
      return rigid ? Launch<DensityAlphaDivergence<true>>::run(a, 8, s)
                   : Launch<DensityAlphaDivergence<false>>::run(a, 7, s);
    case BODY_RIGID_VOLUME: return Launch<RigidVolume>::run(a, 1, s);
    case BODY_NONPRESSURE_WARM:
      return rigid ? Launch<NonpressureWarm<true>>::run(a, 15, s)
                   : Launch<NonpressureWarm<false>>::run(a, 9, s);
    case BODY_PRESSURE:
      return rigid ? Launch<Pressure<true>>::run(a, 9, s)
                   : Launch<Pressure<false>>::run(a, 3, s);
    case BODY_PCISPH_DENSITY_PRED: return Launch<PcisphDensityPred>::run(a, 1, s);
    case BODY_IISPH_DII: return Launch<IisphDii>::run(a, 3, s);
    case BODY_IISPH_AII: return Launch<IisphAii>::run(a, 1, s);
    case BODY_IISPH_DENSITY_STAR: return Launch<IisphDensityStar>::run(a, 1, s);
    case BODY_IISPH_DIJ_PJ: return Launch<IisphDijPj>::run(a, 3, s);
    case BODY_IISPH_SUM_I: return Launch<IisphSumI>::run(a, 1, s);
    case BODY_RIGID_CONTACT:
      if (a.n_chan < 1 || a.n_chan > CONTACT_CHANNELS_MAX) return (int)cudaErrorInvalidValue;
      if (a.n_chan <= CONTACT_CHANNELS_SMALL)
        return Launch<RigidContact<CONTACT_CHANNELS_SMALL>>::run(a, 4 * a.n_chan, s);
      if (a.n_chan <= CONTACT_CHANNELS_MEDIUM)
        return Launch<RigidContact<CONTACT_CHANNELS_MEDIUM>>::run(a, 4 * a.n_chan, s);
      return Launch<RigidContact<CONTACT_CHANNELS_MAX>>::run(a, 4 * a.n_chan, s);
    case BODY_VISC_PREP: return Launch<ViscPrep>::run(a, 9, s);
    case BODY_VISC_MATVEC: return Launch<ViscMatvec>::run(a, 3, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
