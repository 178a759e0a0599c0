// Cell-list pair pass: for every particle row i whose sums are read
// (produce[i] != 0), the masked sums of one SPH pair body over all j with
// |x_i - x_j|^2 < h^2 and j != i. One template kernel over the device bodies
// of pair_bodies.cuh.
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

#include "pair_bodies.cuh"

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
struct Launch {
  static void run(const PairArgs& a, int n_out, cudaStream_t s) {
    const int threads = 128;
    const int blocks = (a.n + threads - 1) / threads;
    pair_kernel<B><<<blocks, threads, 0, s>>>(a, n_out);
  }
};

// Launches one pass; returns cudaGetLastError() (0 = launched).
extern "C" int sph_pair_pass(int body, const PairArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  return launch_body<Launch>(body, *a, (cudaStream_t)stream);
}
