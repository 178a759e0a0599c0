// The SPH pair bodies of the ported steps (DFSPH, WCSPH, PCISPH, IISPH, PBF,
// over fluid, static walls and dynamic rigid bodies under either rigid
// backend, with standard or implicit viscosity) as device functors, the
// arguments they read and the smoothing kernels: the cubic spline, and PBF's
// poly6 W with the spiky gradient. Both pair kernels include this header
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
// Every body is a template on the kernel kind K (Cubic, or PBF's Poly6: the
// poly6 W with the spiky gradient) and the dimension D (its member DIM, the
// dimension the walk runs in); a library holds the instances of one kind and
// one dimension (PAIR_KIND, PAIR_DIM below). The cubic 3D instances are the
// bodies as they were before the kind and the dimension became parameters.
//
// Rounding: both kernels are built with -fmad=false and without fast math,
// so the squared distance ((R0*R0 + R1*R1) + R2*R2) and every body
// expression round like the unfused float32 tensor ops of the plain versions.
// All constants arrive in c[] and kc[] as floats the host folded in double.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MATERIAL_FLUID 1
#define MATERIAL_RIGID 2
#define N_CONST 16
#define FLAG_COUNT 1  // divergence, pbf_density: also count the neighbours
#define FLAG_RIGID 2  // the outputs of dynamic rigid bodies
#define KIND_CUBIC 0
#define KIND_POLY6 1

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
  BODY_PBF_DENSITY = 18,
  BODY_PBF_LAMBDA = 19,
  BODY_PBF_FIX = 20,
  BODY_RIGID_DEM = 21,
};

// Mirrors ops/pair_kernels.py PairArgs (ctypes), field for field.
struct PairArgs {
  const float* pos;          // (n, dim)
  const float* vel;          // (n, dim)
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
  const float* pred;         // (n, dim) predicted positions
  const float* dii;          // (n, dim)
  const float* dij_pj;       // (n, dim)
  const float* x;            // (n, dim) the CG's vector          [visc_matvec]
  const float* com;          // (objects, dim) body com table   [pressure]
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
  const float* lam;          // (n,) PBF's lambda                [pbf_fix]
  int dim;                   // 3 or 2
  int kind;                  // KIND_CUBIC, KIND_POLY6
  // the distance forms of either kind (ops/kernels.py kind_constants): h,
  // h^2, h^3, the poly6 factor, the spiky factor, the cubic gradient's 6k
  float kc[6];
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

// The kernel kinds, each with the two forms the passes take, as the JAX
// package's solvers take them: w and gw from the squared distance
// (common._w_d2, _gw_coef), w_r and gw_r from the distance (kernels.W,
// grad_W_coef). gradW = gw * R.
struct Cubic {
  __device__ static float w(float d2, const PairArgs& a) { return cubic_w(d2, a.c); }
  __device__ static float gw(float d2, const PairArgs& a) { return cubic_gw(d2, a.c); }
  __device__ static float w_r(float r, const PairArgs& a) { return cubic_W_r(r, a.c); }
  __device__ static float gw_r(float dist, const PairArgs& a) {
    const float h = a.c[0], k6 = a.kc[5];
    const float q = dist / h;
    const float safe = fmaxf(dist, 1e-12f);
    const float one_q = 1.0f - q;
    float c = q <= 0.5f ? k6 * q * (3.0f * q - 2.0f) : -k6 * one_q * one_q;
    c = (dist > 1e-5f && q <= 1.0f) ? c : 0.0f;
    return c / (safe * h);
  }
};

// PBF's poly6 W (zero at r == 0, like the reference) and spiky gradient,
// both at sqrt(d2) in the d2-forms (kernels.W(sqrt(d2)), as the JAX
// package's shared passes take them under poly6)
struct Poly6 {
  __device__ static float w_r(float r, const PairArgs& a) {
    const float x = (a.kc[1] - r * r) / a.kc[2];
    const float w = a.kc[3] * x * x * x;
    return (r > 0.0f && r < a.kc[0]) ? w : 0.0f;
  }
  __device__ static float gw_r(float dist, const PairArgs& a) {
    const float safe = fmaxf(dist, 1e-12f);
    const float x = (a.kc[0] - dist) / a.kc[2];
    const float c = a.kc[4] * x * x / safe;
    return (dist > 0.0f && dist < a.kc[0]) ? c : 0.0f;
  }
  __device__ static float w(float d2, const PairArgs& a) { return w_r(sqrtf(d2), a); }
  __device__ static float gw(float d2, const PairArgs& a) { return gw_r(sqrtf(d2), a); }
};

// (v_i - v_j) . R in the plain versions' order, ((t0 + t1) + t2)
template <int D>
__device__ __forceinline__ float dv_dot(const float* v, const float* vj, const float* R) {
  float s = (v[0] - vj[0]) * R[0] + (v[1] - vj[1]) * R[1];
  if (D == 3) s = s + (v[2] - vj[2]) * R[2];
  return s;
}

// A body's row loads and per-pair sums below loop over its dimension D: a
// vector field of n rows is (n, D), and a vector output has D components.

template <class K = Cubic, int D = 3>
struct Density {  // common.compute_density: s
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float*, float d2, float* acc) {
    acc[0] += a.rest_volume[j] * K::w(d2, a);
  }
};

template <class K = Cubic, int D = 3>
struct Alpha {  // dfsph.compute_alpha: sum_sq, vec0..D-1
  static constexpr int DIM = D;
  static constexpr int NOUT = 1 + D;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float cc = -a.rest_volume[j] * K::gw(d2, a);
    if (a.material[j] == MATERIAL_FLUID) acc[0] += cc * cc * d2;
    for (int d = 0; d < D; ++d) acc[1 + d] += cc * R[d];
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

// common._nonpressure_outputs: st0..D-1, acc0..D-1, and under RIGID on
// dynamic rigid rows the viscosity force from fluid neighbours at
// acc[W..W+D-1] (fpp). c[4] diam^2, c[5] W(diam), c[6] 0.01 h^2, c[7]
// d2c*viscosity, c[8] d2c*viscosity_b, c[9] density0.
template <bool RIGID, int W = 6, class K = Cubic, int D = 3>
struct NonpressureAt {
  static constexpr int DIM = D;
  static constexpr int NOUT = RIGID ? W + D : 2 * D;
  float v[D], m_i, inv_rho_i, vol_i;
  bool wrench;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) v[d] = a.vel[D * i + d];
    m_i = a.mass[i];
    inv_rho_i = a.inv_rho[i];
    if (RIGID) {
      wrench = wrench_row(a, i);
      vol_i = a.rest_volume[i];
    }
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const float gw = K::gw(d2, a);
    const int mat_j = a.material[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID;
    const bool rigid_j = mat_j == MATERIAL_RIGID;
    const float m_j = a.mass[j];
    if (fluid_j) {
      const float wst = d2 > c[4] ? K::w(d2, a) : c[5];
      const float mw = m_j * wst;
      for (int d = 0; d < D; ++d) acc[d] += mw * R[d];
    }
    const float v_xy = dv_dot<D>(v, a.vel + D * j, R);
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
    for (int d = 0; d < D; ++d) acc[D + d] += coef * R[d];
    if (RIGID && wrench && fluid_j) {
      const float cw = c[8] * vol_i * m_j * a.inv_rho[j] * inv_denom * v_xy * gw;
      for (int d = 0; d < D; ++d) acc[W + d] += cw * R[d];
    }
  }
};

template <class K = Cubic, int D = 3>
struct Divergence {  // dfsph._divergence_sum: s (, cnt)
  static constexpr int DIM = D;
  static constexpr int NOUT = 2;
  float v[D];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) v[d] = a.vel[D * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float dv_r = dv_dot<D>(v, a.vel + D * j, R);
    acc[0] += a.rest_volume[j] * dv_r * K::gw(d2, a);
    acc[1] += 1.0f;
  }
};

// dfsph._correction_outputs: dv0..D-1, and under RIGID on dynamic rigid rows
// the force from fluid neighbours at acc[W..W+D-1] (fp0..D-1). c[C0]
// dfsph_eps*dt, c[C0 + 1] density0, c[C0 + 2] dt
template <bool RIGID, int C0 = 4, int W = 3, class K = Cubic, int D = 3>
struct CorrectionAt {
  static constexpr int DIM = D;
  static constexpr int NOUT = RIGID ? W + D : D;
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
      const float vgw = a.rest_volume[j] * K::gw(d2, a);
      const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
      const float coef = k * c[C0 + 1] * vgw;
      for (int d = 0; d < D; ++d) acc[d] += -coef * R[d];
      return;
    }
    const float k_j = a.kappa[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID && fabsf(k_i + k_j) > c[C0];
    const bool rigid_j = mat_j == MATERIAL_RIGID && fabsf(k_i) > c[C0];
    const bool wrench_j = wrench && mat_j == MATERIAL_FLUID && fabsf(k_j) > c[C0];
    if (!(fluid_j || rigid_j || wrench_j)) return;
    const float gw = K::gw(d2, a);
    if (fluid_j || rigid_j) {
      const float vgw = a.rest_volume[j] * gw;
      const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
      const float coef = k * c[C0 + 1] * vgw;
      for (int d = 0; d < D; ++d) acc[d] += -coef * R[d];
    }
    if (wrench_j) {
      const float cw = -vol_i * a.k_rho[j] * c[C0 + 1] / c[C0 + 2] *
                       (a.rest_volume[j] * c[C0 + 1]) * gw;
      for (int d = 0; d < D; ++d) acc[W + d] += cw * R[d];
    }
  }
};

// dfsph.nonpressure_warm_fused: the non-pressure sums and the warm-start
// correction in one pass: st, acc, wdv (D each), then under RIGID on
// dynamic rigid rows both wrenches, fpp and wfp. Constants: the non-pressure
// ones at c[4..9], the correction's at c[10..12].
template <bool RIGID, class K = Cubic, int D = 3>
struct NonpressureWarm {
  static constexpr int DIM = D;
  static constexpr int NOUT = RIGID ? 5 * D : 3 * D;
  NonpressureAt<RIGID, 3 * D, K, D> nonpressure;      // st, acc; fpp at 3D
  CorrectionAt<RIGID, 10, 2 * D, K, D> correction;  // at 2D: wdv; wfp at 4D
  __device__ void load(const PairArgs& a, int i) {
    nonpressure.load(a, i);
    correction.load(a, i);
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    nonpressure.pair(a, j, R, d2, acc);
    correction.pair(a, j, R, d2, acc + 2 * D);
  }
};

template <bool RIGID, class K = Cubic, int D = 3>
struct DensityAlphaDivergence {  // dfsph.density_alpha_divergence
  // outputs: sd, sum_sq, sv, cnt, vec0..D-1, and under RIGID svol, the
  // same-object W sum of the rigid pseudo-volumes
  static constexpr int DIM = D;
  static constexpr int NOUT = RIGID ? 5 + D : 4 + D;
  float v[D];
  int obj;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) v[d] = a.vel[D * i + d];
    if (RIGID) obj = a.object_id[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float vj = a.rest_volume[j];
    const float gw = K::gw(d2, a);
    const float cc = -vj * gw;
    const float dv_r = dv_dot<D>(v, a.vel + D * j, R);
    const float w = K::w(d2, a);
    acc[0] += vj * w;
    if (a.material[j] == MATERIAL_FLUID) acc[1] += cc * cc * d2;
    acc[2] += vj * dv_r * gw;
    acc[3] += 1.0f;
    for (int d = 0; d < D; ++d) acc[4 + d] += cc * R[d];
    if (RIGID && a.object_id[j] == obj) acc[4 + D] += w;
  }
};

// same-object W sum (common.compute_rigid_volume_fixedk)
template <class K = Cubic, int D = 3>
struct RigidVolume {
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  int obj;
  __device__ void load(const PairArgs& a, int i) { obj = a.object_id[i]; }
  __device__ void pair(const PairArgs& a, int j, const float*, float d2, float* acc) {
    if (a.object_id[j] == obj) acc[0] += K::w(d2, a);
  }
};

// The bodies of WCSPH, PCISPH and IISPH. A neighbour that is neither fluid
// nor rigid adds a signed zero in the plain versions and is skipped here,
// which leaves every sum unchanged. c[4] is density0 where a body reads it.

// common.pressure_acceleration: acc0..D-1, and under RIGID on dynamic rigid
// rows the force fpp0..D-1 and torque tpp (3 components in 3D, 1 in 2D) from
// fluid neighbours, the torque per pair about the body's com (com, a table
// (objects, D)) with the fluid particle's position x_i - R as its point.
template <bool RIGID, class K = Cubic, int D = 3>
struct Pressure {
  static constexpr int DIM = D;
  static constexpr int NT = D == 3 ? 3 : 1;  // torque components (pair_cross)
  static constexpr int NOUT = RIGID ? 2 * D + NT : D;
  float pr_i, vol_i, x[D], com[D];
  bool wrench;
  __device__ void load(const PairArgs& a, int i) {
    pr_i = a.p_rho2[i];
    if (!RIGID) return;
    wrench = wrench_row(a, i);
    vol_i = a.rest_volume[i];
    const int o = wrench ? a.object_id[i] : 0;
    for (int d = 0; d < D; ++d) {
      x[d] = a.pos[D * i + d];
      com[d] = wrench ? a.com[D * o + d] : 0.0f;
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
    const float gw = K::gw(d2, a);
    term = term * gw;
    for (int d = 0; d < D; ++d) acc[d] += -term * R[d];
    if (RIGID && wrench && mat_j == MATERIAL_FLUID) {
      const float cw = -(a.c[4] * vol_i) * a.p_rho2[j] * (a.c[4] * a.rest_volume[j]) * gw;
      float f[D], arm[D];
      for (int d = 0; d < D; ++d) {
        f[d] = cw * R[d];
        arm[d] = x[d] - R[d] - com[d];
      }
      for (int d = 0; d < D; ++d) acc[D + d] += f[d];
      if constexpr (D == 3) {
        acc[6] += arm[1] * f[2] - arm[2] * f[1];
        acc[7] += arm[2] * f[0] - arm[0] * f[2];
        acc[8] += arm[0] * f[1] - arm[1] * f[0];
      } else {
        acc[2 * D] += arm[0] * f[1] - arm[1] * f[0];
      }
    }
  }
};

// pcisph._density_star_predicted: s. The engine accepted j on the sorted
// positions; W is taken at the predicted distance, where a non-fluid j keeps
// its position.
template <class K = Cubic, int D = 3>
struct PcisphDensityPred {
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  float p[D];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) p[d] = a.pred[D * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float*, float, float* acc) {
    const float* xj = (a.material[j] == MATERIAL_FLUID ? a.pred : a.pos) + D * j;
    float d2p;
    if constexpr (D == 3) {
      const float r0 = p[0] - xj[0], r1 = p[1] - xj[1], r2 = p[2] - xj[2];
      d2p = r0 * r0 + r1 * r1 + r2 * r2;
    } else {
      const float r0 = p[0] - xj[0], r1 = p[1] - xj[1];
      d2p = r0 * r0 + r1 * r1;
    }
    acc[0] += a.rest_volume[j] * K::w_r(sqrtf(d2p), a);
  }
};

template <class K = Cubic, int D = 3>
struct IisphDii {  // iisph.compute_dii: dii0..D-1
  static constexpr int DIM = D;
  static constexpr int NOUT = D;
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
    cc = cc * K::gw(d2, a);
    for (int d = 0; d < D; ++d) acc[d] += cc * R[d];
  }
};

template <class K = Cubic, int D = 3>
struct IisphAii {  // iisph.compute_aii, before the dt^2 factor: s
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  float dii[D], dpi;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) dii[d] = a.dii[D * i + d];
    dpi = a.dpi[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float gw = K::gw(d2, a);
    const float rho0v_j = a.c[4] * a.rest_volume[j];
    float term = 0.0f;
    for (int d = 0; d < D; ++d) term = term + (dii[d] - dpi * gw * R[d]) * gw * R[d];
    acc[0] += rho0v_j * term;
  }
};

template <class K = Cubic, int D = 3>
struct IisphDensityStar {  // iisph.compute_density_star, before the dt factor: s
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  float v[D];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) v[d] = a.vel[D * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float dv_r = dv_dot<D>(v, a.vel + D * j, R);
    acc[0] += a.c[4] * a.rest_volume[j] * dv_r * K::gw(d2, a);
  }
};

template <class K = Cubic, int D = 3>
struct IisphDijPj {  // dij_pj_op of iisph.refine: dp0..D-1 (fluid j only)
  static constexpr int DIM = D;
  static constexpr int NOUT = D;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (a.material[j] != MATERIAL_FLUID) return;
    const float rho = a.density[j];
    const float rho_j2 = fmaxf(rho * rho, 1e-12f);
    const float rho0v = a.c[4] * a.rest_volume[j];
    const float cc = -rho0v * a.pressure[j] / rho_j2 * K::gw(d2, a);
    for (int d = 0; d < D; ++d) acc[d] += cc * R[d];
  }
};

// sum_i_op of iisph.refine, before the dt^2 factor: s. dij_pj is row i's
// (loaded) and neighbour j's (read per pair) from one array.
template <class K = Cubic, int D = 3>
struct IisphSumI {
  static constexpr int DIM = D;
  static constexpr int NOUT = 1;
  float dij[D], dpi, pr_i;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) dij[d] = a.dij_pj[D * i + d];
    dpi = a.dpi[i];
    pr_i = a.pressure[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    if (mat_j != MATERIAL_FLUID && mat_j != MATERIAL_RIGID) return;
    const float gw = K::gw(d2, a);
    const float rho0v_j = a.c[4] * a.rest_volume[j];
    float t = 0.0f;
    if (mat_j == MATERIAL_FLUID) {
      const float pr_j = a.pressure[j];
      for (int d = 0; d < D; ++d) {
        const float d_ji_pi = dpi * gw * R[d] * pr_i;
        const float inner = dij[d] - a.dii[D * j + d] * pr_j - (a.dij_pj[D * j + d] - d_ji_pi);
        t = t + inner * gw * R[d];
      }
    } else {
      for (int d = 0; d < D; ++d) t = t + dij[d] * gw * R[d];
    }
    acc[0] += rho0v_j * t;
  }
};

// integrator.rigid_contact_data: on a rigid row, per contact channel k, the
// penetration-weighted sums over rigid neighbours of another object closer
// than one particle diameter (c[4]): weight cw at acc[(1+D)k], normal cn at
// acc[(1+D)k+1..(1+D)k+D]. The neighbour's channel is chan[its object]: the
// object's index among the dynamic bodies, the last channel for static
// geometry, < 0 for none. The channel count is a launch argument (n_chan <=
// CMAX); the sums stay in registers because the loop over channels is
// unrolled, each channel's sums indexed by a constant. The kernel kind does
// not enter.
template <int CMAX, class K = Cubic, int D = 3>
struct RigidContact {
  static constexpr int DIM = D;
  static constexpr int NOUT = (1 + D) * CMAX;
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
        acc[(1 + D) * k] += pen;
        for (int d = 0; d < D; ++d) acc[(1 + D) * k + 1 + d] += pen * R[d] * inv_dist;
      }
    }
  }
};

// integrator.rigid_contact_wrench (the shape-matching backend's DEM
// contact): on a rigid row, the spring-damper force f0..D-1 from rigid
// neighbours of another object that touch, pen = d0 - |R| > 0:
// max(k pen - c k dt vn, 0) / |R| R, vn = (v_i - v_j) . R / |R|. c[4] d0
// (the particle diameter), c[5] k (contact_stiffness), c[6] c k dt
// (contact_damping * contact_stiffness * dt). The kernel kind does not enter.
template <class K = Cubic, int D = 3>
struct RigidDem {
  static constexpr int DIM = D;
  static constexpr int NOUT = D;
  float v[D];
  int obj;
  bool rigid_i;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < D; ++d) v[d] = a.vel[D * i + d];
    obj = a.object_id[i];
    rigid_i = a.material[i] == MATERIAL_RIGID;
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (!rigid_i || a.material[j] != MATERIAL_RIGID || a.object_id[j] == obj) return;
    const float dist = sqrtf(d2);
    const float pen = a.c[4] - dist;
    if (!(pen > 0.0f)) return;
    const float inv_dist = 1.0f / fmaxf(dist, 1e-9f);
    const float vn = dv_dot<D>(v, a.vel + D * j, R) * inv_dist;
    const float fmag = a.c[5] * pen - a.c[6] * vn;
    const float f = fmaxf(fmag, 0.0f) * inv_dist;
    for (int d = 0; d < D; ++d) acc[d] += f * R[d];
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

// prep_kern: the D(D+1)/2 sums of c_ij gw R_a R_b over fluid and rigid j,
// a <= b row-major (Axx, Axy, Axz, Ayy, Ayz, Azz; in 2D Axx, Axy, Ayy), then
// br0..D-1 (the rigid neighbours' velocity term of b)
template <class K = Cubic, int D = 3>
struct ViscPrep {
  static constexpr int DIM = D;
  static constexpr int NA = D * (D + 1) / 2;
  static constexpr int NOUT = NA + D;
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
    const float gw = K::gw(d2, a);
    const float inv_denom = 1.0f / (d2 + c[4]);
    const float cc = rigid_j ? c[6] * (c[7] * a.rest_volume[j]) * inv_rho_i * inv_denom
                             : visc_c_fluid(a, j, m_i, inv_denom);
    const float cg = cc * gw;
    // the 3D sums as the parent's code spells them: a loop over (r, s)
    // moved ptxas's cubic 3D instance from 56 registers to 48 with a spill
    if constexpr (D == 3) {
      acc[0] += cg * R[0] * R[0];
      acc[1] += cg * R[0] * R[1];
      acc[2] += cg * R[0] * R[2];
      acc[3] += cg * R[1] * R[1];
      acc[4] += cg * R[1] * R[2];
      acc[5] += cg * R[2] * R[2];
    } else {
      acc[0] += cg * R[0] * R[0];
      acc[1] += cg * R[0] * R[1];
      acc[2] += cg * R[1] * R[1];
    }
    if (rigid_j) {
      float v_dot_r = a.vel[D * j] * R[0] + a.vel[D * j + 1] * R[1];
      if constexpr (D == 3) v_dot_r = v_dot_r + a.vel[D * j + 2] * R[2];
      const float cb = c[8] * a.rest_volume[j] * inv_rho_i * v_dot_r * inv_denom * gw;
      for (int d = 0; d < D; ++d) acc[NA + d] += cb * R[d];
    }
  }
};

// the CG matvec kern: acc0..D-1, sums over fluid j of -c_ij gw (R . x_j) R
template <class K = Cubic, int D = 3>
struct ViscMatvec {
  static constexpr int DIM = D;
  static constexpr int NOUT = D;
  float m_i;
  __device__ void load(const PairArgs& a, int i) { m_i = a.mass[i]; }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    if (a.material[j] != MATERIAL_FLUID) return;
    const float gw = K::gw(d2, a);
    const float inv_denom = 1.0f / (d2 + a.c[4]);
    const float cc = visc_c_fluid(a, j, m_i, inv_denom);
    const float* xj = a.x + D * j;
    float s = R[0] * xj[0] + R[1] * xj[1];
    if (D == 3) s = s + R[2] * xj[2];
    const float contrib = -cc * gw * s;
    for (int d = 0; d < D; ++d) acc[d] += contrib * R[d];
  }
};

// The three passes of PBF's position iterations (pbf.py), on the moved
// positions (pos) over the environment of the step's sort; the kernel forms
// are the distance forms (w_r, gw_r at sqrt(d2)), as the JAX bodies take
// them. A neighbour that is neither fluid nor rigid is skipped where the
// plain versions add a signed zero for it.

// compute_density_moving: s, and under FLAG_COUNT the neighbour count cnt
template <class K, int D>
struct PbfDensity {
  static constexpr int DIM = D;
  static constexpr int NOUT = 2;
  __device__ void load(const PairArgs&, int) {}
  __device__ void pair(const PairArgs& a, int j, const float*, float d2, float* acc) {
    acc[0] += a.rest_volume[j] * K::w_r(sqrtf(d2), a);
    acc[1] += 1.0f;
  }
};

// compute_lambda: sum_sq, vec0..D-1 over fluid and rigid j; a rigid j weighs
// V_j rho_i / rho0 with row i's density of the iteration. c[4] density0.
template <class K, int D>
struct PbfLambda {
  static constexpr int DIM = D;
  static constexpr int NOUT = 1 + D;
  float rho_i;
  __device__ void load(const PairArgs& a, int i) { rho_i = a.density[i]; }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    float w;
    if (mat_j == MATERIAL_FLUID) {
      w = a.mass[j] / a.c[4];
    } else if (mat_j == MATERIAL_RIGID) {
      w = a.rest_volume[j] * rho_i / a.c[4];
    } else {
      return;
    }
    w = w * K::gw_r(sqrtf(d2), a);
    acc[0] += w * w * d2;
    for (int d = 0; d < D; ++d) acc[1 + d] += w * R[d];
  }
};

// fix_position, before the 1 / rho0 factor: dx0..D-1, the sums of (lam_i +
// lam_j + s_corr) m_j gradW over fluid j and (2 lam_i + s_corr) V_j rho0
// gradW over rigid j, s_corr = -k (W / W(dq h))^4 with the fourth power
// squared twice (lax.integer_pow). c[4] density0, c[5] -k, c[6]
// max(W(dq h), 1e-30).
template <class K, int D>
struct PbfFix {
  static constexpr int DIM = D;
  static constexpr int NOUT = D;
  float lam_i;
  __device__ void load(const PairArgs& a, int i) { lam_i = a.lam[i]; }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const int mat_j = a.material[j];
    if (mat_j != MATERIAL_FLUID && mat_j != MATERIAL_RIGID) return;
    const float dist = sqrtf(d2);
    const float gw = K::gw_r(dist, a);
    const float ratio = K::w_r(dist, a) / a.c[6];
    const float r2 = ratio * ratio;
    const float scorr = a.c[5] * (r2 * r2);
    const float coef = mat_j == MATERIAL_FLUID
                           ? (lam_i + a.lam[j] + scorr) * a.mass[j]
                           : (2.0f * lam_i + scorr) * a.rest_volume[j] * a.c[4];
    const float cg = coef * gw;
    for (int d = 0; d < D; ++d) acc[d] += cg * R[d];
  }
};

// The bodies with a flag or a channel count beside the kind and the
// dimension, as templates on (K, D) alone for launch_kd
template <class K, int D>
using NonpressureKD = NonpressureAt<false, 2 * D, K, D>;
template <class K, int D>
using NonpressureRigidKD = NonpressureAt<true, 2 * D, K, D>;
template <class K, int D>
using CorrectionKD = CorrectionAt<false, 4, D, K, D>;
template <class K, int D>
using CorrectionRigidKD = CorrectionAt<true, 4, D, K, D>;
template <class K, int D>
using NonpressureWarmKD = NonpressureWarm<false, K, D>;
template <class K, int D>
using NonpressureWarmRigidKD = NonpressureWarm<true, K, D>;
template <class K, int D>
using DensityAlphaDivergenceKD = DensityAlphaDivergence<false, K, D>;
template <class K, int D>
using DensityAlphaDivergenceRigidKD = DensityAlphaDivergence<true, K, D>;
template <class K, int D>
using PressureKD = Pressure<false, K, D>;
template <class K, int D>
using PressureRigidKD = Pressure<true, K, D>;

// channel counts the contact body is built for: the count of a launch picks
// the least that holds it
#define CONTACT_CHANNELS_SMALL 4
#define CONTACT_CHANNELS_MEDIUM 12
#define CONTACT_CHANNELS_MAX 27
template <class K, int D>
using ContactSmallKD = RigidContact<CONTACT_CHANNELS_SMALL, K, D>;
template <class K, int D>
using ContactMediumKD = RigidContact<CONTACT_CHANNELS_MEDIUM, K, D>;
template <class K, int D>
using ContactMaxKD = RigidContact<CONTACT_CHANNELS_MAX, K, D>;

// One library holds the instances of one kernel kind and one dimension: the
// build compiles each engine once per (PAIR_KIND, PAIR_DIM) (ops/_build.py),
// the four in parallel. A launch for another kind or dimension is refused.
#ifndef PAIR_KIND
#define PAIR_KIND KIND_CUBIC
#endif
#ifndef PAIR_DIM
#define PAIR_DIM 3
#endif
#if PAIR_KIND == KIND_CUBIC
using PairKind = Cubic;
#elif PAIR_KIND == KIND_POLY6
using PairKind = Poly6;
#else
#error "PAIR_KIND must be KIND_CUBIC or KIND_POLY6"
#endif
static_assert(PAIR_DIM == 2 || PAIR_DIM == 3, "PAIR_DIM must be 2 or 3");

// Runs Launch<Body<K, D>> for this library's kind and dimension.
template <template <class> class Launch, template <class, int> class Body>
static int launch_kd(const PairArgs& a, int n_out, cudaStream_t s) {
  if (a.kind != PAIR_KIND || a.dim != PAIR_DIM) return (int)cudaErrorInvalidValue;
  return Launch<Body<PairKind, PAIR_DIM>>::run(a, n_out, s);
}

// Runs Launch<Body>::run(a, outputs written, stream) for body id `body` and
// returns its CUDA error code (0 = launched). Each engine gives its own Launch.
template <template <class> class Launch>
static int launch_body(int body, const PairArgs& a, cudaStream_t s) {
  const bool rigid = a.flags & FLAG_RIGID;
  const bool count = a.flags & FLAG_COUNT;
  const int d = a.dim;
  switch (body) {
    case BODY_DENSITY: return launch_kd<Launch, Density>(a, 1, s);
    case BODY_ALPHA: return launch_kd<Launch, Alpha>(a, 1 + d, s);
    case BODY_NONPRESSURE:
      return rigid ? launch_kd<Launch, NonpressureRigidKD>(a, 3 * d, s)
                   : launch_kd<Launch, NonpressureKD>(a, 2 * d, s);
    case BODY_DIVERGENCE: return launch_kd<Launch, Divergence>(a, count ? 2 : 1, s);
    case BODY_CORRECTION:
      return rigid ? launch_kd<Launch, CorrectionRigidKD>(a, 2 * d, s)
                   : launch_kd<Launch, CorrectionKD>(a, d, s);
    case BODY_DENSITY_ALPHA_DIVERGENCE:
      return rigid ? launch_kd<Launch, DensityAlphaDivergenceRigidKD>(a, 5 + d, s)
                   : launch_kd<Launch, DensityAlphaDivergenceKD>(a, 4 + d, s);
    case BODY_RIGID_VOLUME: return launch_kd<Launch, RigidVolume>(a, 1, s);
    case BODY_NONPRESSURE_WARM:
      return rigid ? launch_kd<Launch, NonpressureWarmRigidKD>(a, 5 * d, s)
                   : launch_kd<Launch, NonpressureWarmKD>(a, 3 * d, s);
    case BODY_PRESSURE:
      return rigid ? launch_kd<Launch, PressureRigidKD>(a, 2 * d + (d == 3 ? 3 : 1), s)
                   : launch_kd<Launch, PressureKD>(a, d, s);
    case BODY_PCISPH_DENSITY_PRED: return launch_kd<Launch, PcisphDensityPred>(a, 1, s);
    case BODY_IISPH_DII: return launch_kd<Launch, IisphDii>(a, d, s);
    case BODY_IISPH_AII: return launch_kd<Launch, IisphAii>(a, 1, s);
    case BODY_IISPH_DENSITY_STAR: return launch_kd<Launch, IisphDensityStar>(a, 1, s);
    case BODY_IISPH_DIJ_PJ: return launch_kd<Launch, IisphDijPj>(a, d, s);
    case BODY_IISPH_SUM_I: return launch_kd<Launch, IisphSumI>(a, 1, s);
    case BODY_RIGID_CONTACT: {
      if (a.n_chan < 1 || a.n_chan > CONTACT_CHANNELS_MAX) return (int)cudaErrorInvalidValue;
      const int n_out = (1 + d) * a.n_chan;
      if (a.n_chan <= CONTACT_CHANNELS_SMALL) return launch_kd<Launch, ContactSmallKD>(a, n_out, s);
      if (a.n_chan <= CONTACT_CHANNELS_MEDIUM)
        return launch_kd<Launch, ContactMediumKD>(a, n_out, s);
      return launch_kd<Launch, ContactMaxKD>(a, n_out, s);
    }
    case BODY_VISC_PREP: return launch_kd<Launch, ViscPrep>(a, d * (d + 1) / 2 + d, s);
    case BODY_VISC_MATVEC: return launch_kd<Launch, ViscMatvec>(a, d, s);
    case BODY_PBF_DENSITY: return launch_kd<Launch, PbfDensity>(a, count ? 2 : 1, s);
    case BODY_PBF_LAMBDA: return launch_kd<Launch, PbfLambda>(a, 1 + d, s);
    case BODY_PBF_FIX: return launch_kd<Launch, PbfFix>(a, d, s);
    case BODY_RIGID_DEM: return launch_kd<Launch, RigidDem>(a, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
