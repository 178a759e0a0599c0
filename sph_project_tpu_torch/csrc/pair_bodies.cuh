// The SPH pair bodies of the ported steps (DFSPH, WCSPH, PCISPH, IISPH) as
// device functors, the arguments they read and the cubic spline. Both pair kernels include this header
// (pair_pass.cu: the cell-list engine; pair_slab.cu: the slab-window
// engine), so a body is written once and runs under either engine, as a body
// of the JAX package written against ops/pair_exec.Cx runs under either of
// its executors. Each functor stands next to its plain PyTorch body in
// ops/pair_kernels.py and keeps that body's expression order.
//
// A body has NOUT output sums; load() reads row i's own fields, pair() adds
// one neighbour j that the engine accepted (j != i, |x_i - x_j|^2 < h^2),
// given R = x_i - x_j and d2 = |R|^2.
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
  const int* starts;         // (n / block, 9) window starts    [slab]
  const int* lens;           // (n / block, 9) window lengths   [slab]
  float* out;                // (n_out, n)
  int n, gx, gy, gz;
  int flags;                 // divergence: bit 0 = also count neighbours
  int block;                 // rows per particle block         [slab]
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

struct Nonpressure {  // common._nonpressure_outputs: st0..2, acc0..2
  // c[4] diam^2, c[5] W(diam), c[6] 0.01 h^2, c[7] d2c*viscosity,
  // c[8] d2c*viscosity_b, c[9] density0
  static constexpr int NOUT = 6;
  float v[3], m_i, inv_rho_i;
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
    m_i = a.mass[i];
    inv_rho_i = a.inv_rho[i];
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

// dfsph._correction_outputs: dv0..2; c[C0] dfsph_eps*dt, c[C0 + 1] density0
template <int C0>
struct CorrectionAt {
  static constexpr int NOUT = 3;
  float k_i, kr_i;
  __device__ void load(const PairArgs& a, int i) {
    k_i = a.kappa[i];
    kr_i = a.k_rho[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const int mat_j = a.material[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID && fabsf(k_i + a.kappa[j]) > c[C0];
    const bool rigid_j = mat_j == MATERIAL_RIGID && fabsf(k_i) > c[C0];
    if (!(fluid_j || rigid_j)) return;
    const float vgw = a.rest_volume[j] * cubic_gw(d2, c);
    const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
    const float coef = k * c[C0 + 1] * vgw;
    for (int d = 0; d < 3; ++d) acc[d] += -coef * R[d];
  }
};

using Correction = CorrectionAt<4>;

// dfsph.nonpressure_warm_fused: the non-pressure sums and the warm-start
// correction in one pass: st0..2, acc0..2, wdv0..2. Constants: Nonpressure's
// at c[4..9], the correction's at c[10..11].
struct NonpressureWarm {
  static constexpr int NOUT = Nonpressure::NOUT + Correction::NOUT;
  Nonpressure nonpressure;
  CorrectionAt<10> correction;
  __device__ void load(const PairArgs& a, int i) {
    nonpressure.load(a, i);
    correction.load(a, i);
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    nonpressure.pair(a, j, R, d2, acc);
    correction.pair(a, j, R, d2, acc + Nonpressure::NOUT);
  }
};

struct DensityAlphaDivergence {  // dfsph.density_alpha_divergence
  // outputs: sd, sum_sq, sv, cnt, vec0..2
  static constexpr int NOUT = 7;
  float v[3];
  __device__ void load(const PairArgs& a, int i) {
    for (int d = 0; d < 3; ++d) v[d] = a.vel[3 * i + d];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float vj = a.rest_volume[j];
    const float gw = cubic_gw(d2, a.c);
    const float cc = -vj * gw;
    const float dv_r = (v[0] - a.vel[3 * j]) * R[0] + (v[1] - a.vel[3 * j + 1]) * R[1] +
                       (v[2] - a.vel[3 * j + 2]) * R[2];
    acc[0] += vj * cubic_w(d2, a.c);
    if (a.material[j] == MATERIAL_FLUID) acc[1] += cc * cc * d2;
    acc[2] += vj * dv_r * gw;
    acc[3] += 1.0f;
    for (int d = 0; d < 3; ++d) acc[4 + d] += cc * R[d];
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

struct Pressure {  // common.pressure_acceleration (no wrench): acc0..2
  static constexpr int NOUT = 3;
  float pr_i;
  __device__ void load(const PairArgs& a, int i) { pr_i = a.p_rho2[i]; }
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
    term = term * cubic_gw(d2, a.c);
    for (int d = 0; d < 3; ++d) acc[d] += -term * R[d];
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

// Runs Launch<Body>::run(a, outputs written, stream) for body id `body` and
// returns its CUDA error code (0 = launched). Each engine gives its own Launch.
template <template <class> class Launch>
static int launch_body(int body, const PairArgs& a, cudaStream_t s) {
  switch (body) {
    case BODY_DENSITY: return Launch<Density>::run(a, 1, s);
    case BODY_ALPHA: return Launch<Alpha>::run(a, 4, s);
    case BODY_NONPRESSURE: return Launch<Nonpressure>::run(a, 6, s);
    case BODY_DIVERGENCE: return Launch<Divergence>::run(a, (a.flags & 1) ? 2 : 1, s);
    case BODY_CORRECTION: return Launch<Correction>::run(a, 3, s);
    case BODY_DENSITY_ALPHA_DIVERGENCE: return Launch<DensityAlphaDivergence>::run(a, 7, s);
    case BODY_RIGID_VOLUME: return Launch<RigidVolume>::run(a, 1, s);
    case BODY_NONPRESSURE_WARM: return Launch<NonpressureWarm>::run(a, 9, s);
    case BODY_PRESSURE: return Launch<Pressure>::run(a, 3, s);
    case BODY_PCISPH_DENSITY_PRED: return Launch<PcisphDensityPred>::run(a, 1, s);
    case BODY_IISPH_DII: return Launch<IisphDii>::run(a, 3, s);
    case BODY_IISPH_AII: return Launch<IisphAii>::run(a, 1, s);
    case BODY_IISPH_DENSITY_STAR: return Launch<IisphDensityStar>::run(a, 1, s);
    case BODY_IISPH_DIJ_PJ: return Launch<IisphDijPj>::run(a, 3, s);
    case BODY_IISPH_SUM_I: return Launch<IisphSumI>::run(a, 1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
