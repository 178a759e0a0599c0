// The rotation factor of the polar decomposition A = R S, batched: one
// thread per body, the (dim, dim) float32 covariance of each body of the
// shape-matching rigid backend (rigid/shape_matching.py, O =
// params.max_objects bodies, dim 3 or 2).
//
// Replaces no Pallas kernel: the JAX package takes jnp.linalg.svd and
// jnp.linalg.det of the covariances inside its jitted step
// (sph_project_tpu/rigid/shape_matching.py:21 `_polar_rotation`), which XLA
// runs on the device. PyTorch's torch.linalg.svd and det on a CUDA tensor
// check their convergence on the host, which a captured step cannot hold,
// so the port computes the factor here.
//
// What it computes is what ops/polar.py `polar_rotation_plain` computes:
// U V^T of the SVD A = U diag(s) V^T, with the column of U that belongs to
// the smallest singular value scaled by det(U V^T), so that a reflection
// becomes a rotation (det R = +1).
//
// Design. A one-sided (Hestenes) Jacobi SVD in float64 registers: plane
// rotations from the right, B = A V, until the columns of B are orthogonal
// (each pair's cosine below POLAR_EPS, at most POLAR_MAX_SWEEPS sweeps; a 2x2
// takes one rotation). The singular values are the column norms, sorted
// descending with their columns of V, so that "the last column" means what it
// means in LAPACK's and JAX's SVD. U's columns are B's normalised, except
// the last, which is taken as det(V) times the cross product of the others
// (in 2D, det(V) times the first turned by 90 degrees): that is the fixed
// column det(U) det(V) u_last, and it needs no division by the smallest
// singular value, so a near rank-deficient body keeps a proper rotation. A
// column of norm 0 (a body of one particle: A = 0) is completed to an
// orthonormal basis, which gives R = I for A = 0 as LAPACK's SVD does. R is
// rounded to float32 once, at the end.
//
// Bound: latency. The work is a few hundred float64 operations on each of
// 32 bodies of 9 floats (2.3 KB in and out); one launch costs more than the
// arithmetic. What the kernel saves is the host round trip of the library's
// check, which would break the captured step.

#include <cuda_runtime.h>
#include <stdint.h>

#define POLAR_THREADS 128
#define POLAR_MAX_SWEEPS 12
// a pair of columns is orthogonal when |b_p . b_q| <= POLAR_EPS |b_p| |b_q|
#define POLAR_EPS 1e-15

template <int D>
__device__ void unit_orthogonal_to(const double* u, double* out) {
  // e_k for the axis along which u is smallest, minus its part along u
  int k = 0;
  for (int i = 1; i < D; ++i)
    if (fabs(u[i]) < fabs(u[k])) k = i;
  double e[D];
  for (int i = 0; i < D; ++i) e[i] = (i == k ? 1.0 : 0.0) - u[k] * u[i];
  double n = 0.0;
  for (int i = 0; i < D; ++i) n += e[i] * e[i];
  n = sqrt(n);
  for (int i = 0; i < D; ++i) out[i] = e[i] / n;
}

template <int D>
__global__ void polar_kernel(const float* __restrict__ A, float* __restrict__ R,
                             long long n, int* __restrict__ sweeps_out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const float* a = A + b * D * D;
  double B[D][D], V[D][D];
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      B[i][j] = (double)a[i * D + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }

  int sweeps = 0;
  for (; sweeps < POLAR_MAX_SWEEPS; ++sweeps) {
    bool rotated = false;
    for (int p = 0; p < D - 1; ++p)
      for (int q = p + 1; q < D; ++q) {
        double al = 0.0, be = 0.0, ga = 0.0;
        for (int i = 0; i < D; ++i) {
          al += B[i][p] * B[i][p];
          be += B[i][q] * B[i][q];
          ga += B[i][p] * B[i][q];
        }
        if (!(fabs(ga) > POLAR_EPS * sqrt(al * be))) continue;
        rotated = true;
        const double zeta = (be - al) / (2.0 * ga);
        const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
        for (int i = 0; i < D; ++i) {
          const double bp = B[i][p], bq = B[i][q];
          B[i][p] = c * bp - s * bq;
          B[i][q] = s * bp + c * bq;
          const double vp = V[i][p], vq = V[i][q];
          V[i][p] = c * vp - s * vq;
          V[i][q] = s * vp + c * vq;
        }
      }
    if (!rotated) break;
  }

  // singular values, sorted descending with their columns (a stable
  // insertion sort of D <= 3)
  double sig[D];
  int ord[D];
  for (int j = 0; j < D; ++j) {
    double s2 = 0.0;
    for (int i = 0; i < D; ++i) s2 += B[i][j] * B[i][j];
    sig[j] = sqrt(s2);
    ord[j] = j;
  }
  for (int j = 1; j < D; ++j)
    for (int k = j; k > 0 && sig[ord[k]] > sig[ord[k - 1]]; --k) {
      const int t = ord[k];
      ord[k] = ord[k - 1];
      ord[k - 1] = t;
    }
  double U[D][D], W[D][D];  // columns: U's, and V's in the same order
  for (int j = 0; j < D; ++j)
    for (int i = 0; i < D; ++i) W[i][j] = V[i][ord[j]];
  double detv;
  if constexpr (D == 3)
    detv = W[0][0] * (W[1][1] * W[2][2] - W[1][2] * W[2][1]) -
           W[0][1] * (W[1][0] * W[2][2] - W[1][2] * W[2][0]) +
           W[0][2] * (W[1][0] * W[2][1] - W[1][1] * W[2][0]);
  else
    detv = W[0][0] * W[1][1] - W[0][1] * W[1][0];

  // u_1 (and u_2 in 3D): the normalised columns, Gram-Schmidt against the
  // ones before, completed where a column vanishes
  double u[D][D];  // u[j] = column j of U
  for (int j = 0; j < D - 1; ++j) {
    double c[D];
    for (int i = 0; i < D; ++i) c[i] = B[i][ord[j]];
    for (int k = 0; k < j; ++k) {
      double d = 0.0;
      for (int i = 0; i < D; ++i) d += u[k][i] * c[i];
      for (int i = 0; i < D; ++i) c[i] -= d * u[k][i];
    }
    double nn = 0.0;
    for (int i = 0; i < D; ++i) nn += c[i] * c[i];
    nn = sqrt(nn);
    if (nn > 1e-300 && nn > 1e-12 * sig[ord[0]]) {
      for (int i = 0; i < D; ++i) u[j][i] = c[i] / nn;
    } else if (j == 0) {
      for (int i = 0; i < D; ++i) u[0][i] = i == 0 ? 1.0 : 0.0;
    } else {
      unit_orthogonal_to<D>(u[0], u[j]);
    }
  }
  // the last column: det(V) times the right-handed completion
  if constexpr (D == 3) {
    u[2][0] = detv * (u[0][1] * u[1][2] - u[0][2] * u[1][1]);
    u[2][1] = detv * (u[0][2] * u[1][0] - u[0][0] * u[1][2]);
    u[2][2] = detv * (u[0][0] * u[1][1] - u[0][1] * u[1][0]);
  } else {
    u[1][0] = -detv * u[0][1];
    u[1][1] = detv * u[0][0];
  }
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) U[i][j] = u[j][i];

  float* r = R + b * D * D;
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      double acc = 0.0;
      for (int k = 0; k < D; ++k) acc += U[i][k] * W[j][k];
      r[i * D + j] = (float)acc;
    }
  if (sweeps_out != nullptr) sweeps_out[b] = sweeps;
}

// R (n, dim, dim) float32 from A (n, dim, dim) float32, both contiguous;
// sweeps_out (n) int32 or null: the Jacobi sweeps each body took. Returns
// a CUDA error code (0: launched).
extern "C" int sph_polar(const float* A, float* R, long long n, int dim,
                         int* sweeps_out, void* stream) {
  if (n <= 0) return 0;
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + POLAR_THREADS - 1) / POLAR_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3)
    polar_kernel<3><<<blocks, POLAR_THREADS, 0, s>>>(A, R, n, sweeps_out);
  else
    polar_kernel<2><<<blocks, POLAR_THREADS, 0, s>>>(A, R, n, sweeps_out);
  return (int)cudaGetLastError();
}
