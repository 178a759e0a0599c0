// Slab-window pair pass: for every row i of every particle block, the masked
// sums of one SPH pair body over the candidates of the block's 9 windows.
// One template kernel over the device bodies of pair_bodies.cuh.
//
// Replaces the TPU kernel sph_project_tpu/ops/pair_exec.py `kernel_fn` in
// `_exec_pallas`. There, blocks of B consecutive cell-sorted rows read 9
// pre-gathered slabs of a fixed width S per field, tiled over a (blocks,
// window tiles) grid with the outputs accumulated across the tile axis; a
// window longer than S was cut and counted, and outlier blocks reran against
// wider slabs. Here a block reads its windows straight from the sorted
// fields and walks each to its true length, so there are no slabs, no cap,
// nothing is cut and one launch covers the outlier blocks too.
//
// What is computed (ops/pairs.py make_slab_env builds the table): segment
// s = (dx, dy) of block b is the index range [starts[b,s], starts[b,s] +
// lens[b,s]), the union over the block's rows of the three z-cells around
// each row's cell in the (x+dx, y+dy) row of cells. A candidate j of segment
// s counts for row i only if rows[j] == rows[i] + dx*gy + dy (and that row of
// cells exists): a block that spans several (x, y) rows has overlapping
// windows, and this keeps every pair counted once. Then j != i and
// |x_i - x_j|^2 < h^2, as in the cell-list kernel, and in the same order for
// one row (segments in (dx, dy) order, j ascending).
//
// Bound: compulsory bytes are the fields, the table and the outputs, tens of
// MB per pass; the cost of this design is the candidate loop, every row of a
// block testing the whole union window (about ten times the candidates of
// the cell-list kernel). Design: one thread block per particle block, one
// thread per row, sums in registers, outputs written once. A window is
// staged through shared memory a tile of `block` candidates at a time
// (position and row id), so each candidate is loaded from device memory once
// per block and tested by every row from shared memory; a candidate of
// another row of cells is rejected on its row id alone. A block none of
// whose rows produce writes zeros and returns.

#include "pair_bodies.cuh"

#define NSEG 9
#define MAX_BLOCK 512

template <class B>
__global__ void __launch_bounds__(MAX_BLOCK) slab_kernel(const __grid_constant__ PairArgs a,
                                                         int n_out) {
  extern __shared__ float smem[];
  const int T = blockDim.x;  // == a.block; n == gridDim.x * T (checked by the caller)
  float* spos = smem;                                // (T, 3)
  int* srow = reinterpret_cast<int*>(smem + 3 * T);  // (T,)
  const int tid = threadIdx.x;
  const int i = blockIdx.x * T + tid;
  float acc[B::NOUT];
#pragma unroll
  for (int k = 0; k < B::NOUT; ++k) acc[k] = 0.0f;
  const bool mine = a.produce[i] != 0;
  if (__syncthreads_or(mine)) {
    B body;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
    int row_i = 0, cx = 0, cy = 0;
    if (mine) {
      body.load(a, i);
      x0 = a.pos[3 * i];
      x1 = a.pos[3 * i + 1];
      x2 = a.pos[3 * i + 2];
      row_i = a.rows[i];
      cy = row_i % a.gy;
      cx = row_i / a.gy;
    }
    const int* starts = a.starts + (size_t)blockIdx.x * NSEG;
    const int* lens = a.lens + (size_t)blockIdx.x * NSEG;
    for (int s = 0; s < NSEG; ++s) {
      const int dx = s / 3 - 1, dy = s % 3 - 1;
      const int start = starts[s], len = lens[s];
      const bool take = mine && cx + dx >= 0 && cx + dx < a.gx && cy + dy >= 0 &&
                        cy + dy < a.gy;
      const int want = row_i + dx * a.gy + dy;
      for (int t0 = 0; t0 < len; t0 += T) {
        const int m = min(T, len - t0);
        const int j0 = start + t0;
        if (tid < m) {
          const int j = j0 + tid;
          spos[3 * tid] = a.pos[3 * j];
          spos[3 * tid + 1] = a.pos[3 * j + 1];
          spos[3 * tid + 2] = a.pos[3 * j + 2];
          srow[tid] = a.rows[j];
        }
        __syncthreads();
        if (take) {
          for (int k = 0; k < m; ++k) {
            if (srow[k] != want) continue;
            const int j = j0 + k;
            if (j == i) continue;
            float R[3];
            R[0] = x0 - spos[3 * k];
            R[1] = x1 - spos[3 * k + 1];
            R[2] = x2 - spos[3 * k + 2];
            const float d2 = R[0] * R[0] + R[1] * R[1] + R[2] * R[2];
            if (!(d2 < a.dh2)) continue;
            body.pair(a, j, R, d2, acc);
          }
        }
        __syncthreads();
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
    const size_t shared = (size_t)a.block * 4 * sizeof(float);
    slab_kernel<B><<<a.n / a.block, a.block, shared, s>>>(a, n_out);
  }
};

// Launches one pass over all n / block particle blocks; returns
// cudaGetLastError() (0 = launched).
extern "C" int sph_pair_slab(int body, const PairArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->block <= 0 || a->block > MAX_BLOCK || a->n % a->block != 0)
    return (int)cudaErrorInvalidValue;
  return launch_body<Launch>(body, *a, (cudaStream_t)stream);
}
