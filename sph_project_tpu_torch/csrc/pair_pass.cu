// Cell-list pair pass: for every particle row i whose sums are read
// (produce[i] != 0), the masked sums of one SPH pair body over all j with
// |x_i - x_j|^2 < h^2 and j != i. One template kernel over the device bodies
// of pair_bodies.cuh, around the compacted walk of pair_walk.cuh.
//
// Replaces the TPU kernel sph_project_tpu/ops/pair_dma.py `_kernel` /
// `_kernel_body` (launched by `run`). That kernel DMA'd plane-padded union
// windows of a packed field matrix into VMEM under fixed caps and counted
// what the caps lost. This one reads through the cell table: particles are
// sorted by flat cell id (x*gy + y)*gz + z, so each of the 9 (x+-1, y+-1)
// neighbour rows of cells is one contiguous index range
// [cell_start[row+z-1], cell_start[row+z+1+1]), clamped to the grid. There
// are no caps, so nothing is lost.
//
// Bound: not the compulsory bytes (each field read once, each output written
// once: tens of MB, 0.02-0.05 ms) but instruction throughput. A row tests about 7
// candidates for every neighbour it keeps, a dozen instructions each, and
// runs the body (IEEE sqrt and divisions, no fused multiply-add) on what it
// keeps; chip_smoke.py computes that floor per body (`issue_floor_ms`).
//
// Design: one thread per row, one warp per 32 consecutive sorted rows. Those
// rows lie in a few neighbouring cells of one column, so per segment (dx, dy)
// the union of their runs is one short index range: the warp finds it with
// two warp reductions, stages its positions in shared memory with coalesced
// cp.async copies and each lane tests its own run from there (lanes of one
// cell read the same words). Accepted candidates go to per-row lists and the
// body runs on dense warps (pair_walk.cuh). A warp none of whose rows produce
// writes zeros before it loads anything. Warps never wait for each other.
//
// No tensor cores: the work has no matrix product. A Gram-matrix distance
// (-2 x_i.x_j through wgmma, TF32 or split float32) rounds differently from
// (R0*R0 + R1*R1) + R2*R2 and moves lattice pairs at exactly |R| = h across
// the test, which changes neighbour counts and with them the solver's
// iteration counts.

#include <limits.h>

#include "pair_bodies.cuh"
#include "pair_walk.cuh"

#define PASS_THREADS 128
#define PASS_WARPS (PASS_THREADS / 32)
#define PASS_STAGE_CAP 64  // candidates a warp stages per tile
// a tile per warp, then the rows' lists
#define PASS_SHARED \
  (sizeof(float4) * PASS_WARPS * PASS_STAGE_CAP + sizeof(int) * LIST_CAP * PASS_THREADS)

// The arguments stay in the constant parameter space (__grid_constant__):
// the bodies take them by reference, which would otherwise copy the struct
// into every thread's local memory.
template <class B>
__global__ void __launch_bounds__(PASS_THREADS) pair_kernel(const __grid_constant__ PairArgs a,
                                                            int n_out) {
  extern __shared__ __align__(16) float smem[];
  // per warp one tile of positions, then the rows' lists (LIST_CAP, T)
  float4* spos = reinterpret_cast<float4*>(smem) + (threadIdx.x >> 5) * PASS_STAGE_CAP;
  int* lists = reinterpret_cast<int*>(reinterpret_cast<float4*>(smem) + PASS_WARPS * PASS_STAGE_CAP);
  const int i = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int num_cells = a.gx * a.gy * a.gz;
  int cell = num_cells;
  if (i < a.n && a.produce[i]) cell = a.cells[i];
  const bool mine = cell < num_cells;
  Row<B> r;
  r.init(a, i, mine, lists + threadIdx.x, PASS_THREADS);
  if (__any_sync(FULL_MASK, mine)) {
    const WarpGroup g{(int)(threadIdx.x & 31)};
    const int cz = cell % a.gz;
    const int rest = cell / a.gz;
    const int cy = rest % a.gy;
    const int cx = rest / a.gy;
    const int zlo = max(cz - 1, 0), zhi = min(cz + 1, a.gz - 1);
    for (int s = 0; s < NSEG; ++s) {
      // the row's run in the cell table ...
      const int x = cx + s / 3 - 1, y = cy + s % 3 - 1;
      int lo = 0, hi = 0;
      if (mine && x >= 0 && x < a.gx && y >= 0 && y < a.gy) {
        const int row = (x * a.gy + y) * a.gz;
        lo = a.cell_start[row + zlo];
        hi = a.cell_start[row + zhi + 1];
      }
      // ... and the warp's window: from the least start to the greatest end
      const int ws = __reduce_min_sync(FULL_MASK, lo < hi ? lo : INT_MAX);
      const int we = __reduce_max_sync(FULL_MASK, lo < hi ? hi : 0);
      walk_window(r, a, g, spos, PASS_STAGE_CAP, ws, we, lo, hi);
    }
    r.flush(a);
  }
  if (i < a.n) store_row(r, a, n_out);
}

template <class B>
struct Launch {
  static int run(const PairArgs& a, int n_out, cudaStream_t s) {
    const int blocks = (a.n + PASS_THREADS - 1) / PASS_THREADS;
    pair_kernel<B><<<blocks, PASS_THREADS, PASS_SHARED, s>>>(a, n_out);
    return (int)cudaGetLastError();
  }
};

// Launches one pass; returns the CUDA error code (0 = launched).
extern "C" int sph_pair_pass(int body, const PairArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  return launch_body<Launch>(body, *a, (cudaStream_t)stream);
}
