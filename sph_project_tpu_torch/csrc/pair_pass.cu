// Cell-list pair pass: for every particle row i whose sums are read
// (produce[i] != 0), the masked sums of one SPH pair body over all j with
// |x_i - x_j|^2 < h^2 and j != i. One template kernel, one device body per
// pass of the DFSPH main path.
//
// Replaces the TPU kernel sph_project_tpu/ops/pair_dma.py `_kernel` /
// `_kernel_body` (launched by `run`). That kernel DMA'd plane-padded union
// windows of a packed field matrix into VMEM under fixed caps and counted
// what the caps lost. This one reads straight from device memory through the
// cell table: particles are sorted by flat cell id (x*gy + y)*gz + z, so each
// of the 9 (x+-1, y+-1) neighbour rows is one contiguous index range
// [cell_start[row+z-1], cell_start[row+z+1+1]), clamped to the grid. There
// are no caps, so nothing is lost.
//
// Bound: on this card the pass is bound by the candidate loop, not by
// compulsory bytes: each row tests ~200 candidates (27 cells of ~8 particles)
// to keep ~30, and every candidate costs a position load and a distance
// test. The compulsory traffic (each field read once, each output written
// once) is tens of MB per pass. Design, first version: one thread per row,
// sums in registers, outputs written once; neighbouring rows are neighbours
// in space, so a warp's candidate loads mostly hit L1/L2. Staging cell rows
// in shared memory and a warp per row are later work.
//
// Rounding: built with -fmad=false and without fast math, so the squared
// distance ((R0*R0 + R1*R1) + R2*R2) and every body expression round like
// the unfused float32 tensor ops of the plain versions (ops/pair_kernels.py).
// All constants arrive in c[] as floats the host folded in double.

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
};

// Mirrors ops/pair_kernels.py PairArgs (ctypes), field for field.
struct PairArgs {
  const float* pos;          // (n, 3)
  const float* vel;          // (n, 3)
  const int* cells;          // (n,) sorted flat cell ids
  const int* cell_start;     // (gx*gy*gz + 1,)
  const uint8_t* produce;    // (n,) rows whose sums are read
  const int* material;       // (n,)
  const int* object_id;      // (n,)
  const float* rest_volume;  // (n,)
  const float* mass;         // (n,)
  const float* inv_rho;      // (n,)
  const float* kappa;        // (n,)
  const float* k_rho;        // (n,)
  float* out;                // (n_out, n)
  int n, gx, gy, gz;
  int flags;                 // divergence: bit 0 = also count neighbours
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

// ---- bodies: load() reads row i's own fields, pair() adds one neighbour ----

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

struct Correction {  // dfsph._correction_outputs: dv0..2
  // c[4] dfsph_eps*dt, c[5] density0
  static constexpr int NOUT = 3;
  float k_i, kr_i;
  __device__ void load(const PairArgs& a, int i) {
    k_i = a.kappa[i];
    kr_i = a.k_rho[i];
  }
  __device__ void pair(const PairArgs& a, int j, const float* R, float d2, float* acc) {
    const float* c = a.c;
    const int mat_j = a.material[j];
    const bool fluid_j = mat_j == MATERIAL_FLUID && fabsf(k_i + a.kappa[j]) > c[4];
    const bool rigid_j = mat_j == MATERIAL_RIGID && fabsf(k_i) > c[4];
    if (!(fluid_j || rigid_j)) return;
    const float vgw = a.rest_volume[j] * cubic_gw(d2, c);
    const float k = fluid_j ? kr_i + a.k_rho[j] : kr_i;
    const float coef = k * c[5] * vgw;
    for (int d = 0; d < 3; ++d) acc[d] += -coef * R[d];
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

// The arguments stay in the constant parameter space (__grid_constant__):
// the bodies take them by reference, which would otherwise copy the struct
// into every thread's local memory.
template <class B>
__global__ void __launch_bounds__(128) pair_kernel(const __grid_constant__ PairArgs a,
                                                   int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float acc[B::NOUT];
#pragma unroll
  for (int k = 0; k < B::NOUT; ++k) acc[k] = 0.0f;
  if (a.produce[i]) {
    B body;
    body.load(a, i);
    const float x0 = a.pos[3 * i], x1 = a.pos[3 * i + 1], x2 = a.pos[3 * i + 2];
    const int cell = a.cells[i];
    const int cz = cell % a.gz;
    const int rest = cell / a.gz;
    const int cy = rest % a.gy;
    const int cx = rest / a.gy;
    const int zlo = max(cz - 1, 0), zhi = min(cz + 1, a.gz - 1);
    const int xlo = max(cx - 1, 0), xhi = min(cx + 1, a.gx - 1);
    const int ylo = max(cy - 1, 0), yhi = min(cy + 1, a.gy - 1);
    for (int x = xlo; x <= xhi; ++x) {
      for (int y = ylo; y <= yhi; ++y) {
        const int row = (x * a.gy + y) * a.gz;
        const int js = a.cell_start[row + zlo];
        const int je = a.cell_start[row + zhi + 1];
        for (int j = js; j < je; ++j) {
          if (j == i) continue;
          float R[3];
          R[0] = x0 - a.pos[3 * j];
          R[1] = x1 - a.pos[3 * j + 1];
          R[2] = x2 - a.pos[3 * j + 2];
          const float d2 = R[0] * R[0] + R[1] * R[1] + R[2] * R[2];
          if (!(d2 < a.dh2)) continue;
          body.pair(a, j, R, d2, acc);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < B::NOUT; ++k)
    if (k < n_out) a.out[(size_t)k * a.n + i] = acc[k];
}

template <class B>
static void launch(const PairArgs& a, int n_out, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  pair_kernel<B><<<blocks, threads, 0, s>>>(a, n_out);
}

// Launches one pass; returns cudaGetLastError() (0 = launched).
extern "C" int sph_pair_pass(int body, const PairArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->n <= 0) return 0;
  switch (body) {
    case BODY_DENSITY: launch<Density>(*a, 1, s); break;
    case BODY_ALPHA: launch<Alpha>(*a, 4, s); break;
    case BODY_NONPRESSURE: launch<Nonpressure>(*a, 6, s); break;
    case BODY_DIVERGENCE: launch<Divergence>(*a, (a->flags & 1) ? 2 : 1, s); break;
    case BODY_CORRECTION: launch<Correction>(*a, 3, s); break;
    case BODY_DENSITY_ALPHA_DIVERGENCE: launch<DensityAlphaDivergence>(*a, 7, s); break;
    case BODY_RIGID_VOLUME: launch<RigidVolume>(*a, 1, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
