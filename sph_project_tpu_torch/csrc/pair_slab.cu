// Slab-window pair pass: for every row i of every particle block, the masked
// sums of one SPH pair body over the row's candidates in the block's 9
// windows (3 in 2D: the grid (gx, 1, gy), flat id x*gy + y, segments dx).
// One template kernel over the device bodies of pair_bodies.cuh, around the
// compacted walk of pair_walk.cuh.
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
// each row's cell in the (x+dx, y+dy) row of cells. The window is sorted by
// flat cell id, so the candidates row i can accept there are one contiguous
// piece of it, those with cell id in [want*gz + z-1, want*gz + z+1] for
// want = (x+dx)*gy + (y+dy) (if that row of cells exists): each row finds the
// two ends of its piece by binary search over the window's cell ids and
// tests nothing else. The plain version (ops/pairs.py run_plain_slab) and the
// JAX executors take the test the other way round: every candidate of the
// window whose row of cells is `want`, whatever its z-cell. The two differ
// only in candidates two or more z-cells away from the row's: at the
// positions of the sort these lie at least one cell width (>= h) off and
// fail the distance test, so the pairs kept are the same. On positions moved
// since (PBF's iterations) the JAX executors keep such pairs and this kernel
// does not: a row's candidates are those of its stencil at the sort, as
// under the cell-list kernel (the port's plain version takes the same piece). A block that spans several (x, y) rows has overlapping
// windows; the pieces keep every pair counted once. Then j != i and
// |x_i - x_j|^2 < h^2, as in the cell-list kernel and in the same order for
// one row (segments in (dx, dy) order, j ascending), so the two kernels'
// sums are bit-equal.
//
// Bound: as the cell-list kernel's, instruction throughput (about 7 tests per
// neighbour kept, then the body), plus 18 binary searches per row; the
// compulsory bytes are tens of MB per pass. Design: one thread block per
// particle block, one thread per row. The block stages each window through
// shared memory in tiles (positions only, coalesced cp.async copies), every
// row tests its piece of the tile from there, accepted candidates go to
// per-row lists and the body runs on dense warps (pair_walk.cuh). A tile in
// which no row has a piece is skipped; a block none of whose rows produce
// writes zeros and returns.

#include "pair_bodies.cuh"
#include "pair_walk.cuh"

#define MAX_BLOCK 512
#define SLAB_STAGE_CAP 512  // candidates a block stages per tile
// one tile, then the lists of a block's rows
#define SLAB_SHARED(block) (sizeof(float4) * SLAB_STAGE_CAP + sizeof(int) * LIST_CAP * (block))

// first index in [lo, hi) of the ascending v whose value is >= key
__device__ __forceinline__ int lower_bound(const int* v, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class B>
__global__ void __launch_bounds__(MAX_BLOCK) slab_kernel(const __grid_constant__ PairArgs a,
                                                         int n_out) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;  // == a.block; n == gridDim.x * T (checked by the caller)
  // one tile of positions, then the rows' lists (LIST_CAP, T)
  float4* spos = reinterpret_cast<float4*>(smem);
  int* lists = reinterpret_cast<int*>(spos + SLAB_STAGE_CAP);
  const int i = blockIdx.x * T + threadIdx.x;
  const int num_cells = a.gx * a.gy * a.gz;
  int cell = num_cells;
  if (a.produce[i]) cell = a.cells[i];
  // 0 <= cell < num_cells in one unsigned compare: a halo slot no rank sent
  // has cell -1 (parallel/spatial.py) and is never mine
  const bool mine =
      static_cast<unsigned>(cell) < static_cast<unsigned>(num_cells);
  Row<B> r;
  r.init(a, i, mine, lists + threadIdx.x, T);
  if (__syncthreads_or(mine)) {
    const BlockGroup g{(int)threadIdx.x};
    const int cz = cell % a.gz;
    const int rest = cell / a.gz;
    const int cy = rest % a.gy;
    const int cx = rest / a.gy;
    const int zlo = max(cz - 1, 0), zhi = min(cz + 1, a.gz - 1);
    constexpr int NSEG = Row<B>::DIM == 3 ? 9 : 3;
    const int* starts = a.starts + (size_t)blockIdx.x * NSEG;
    const int* lens = a.lens + (size_t)blockIdx.x * NSEG;
    // segment s, of row of cells (x, y)
    auto segment = [&](int s, int x, int y) {
      const int ws = starts[s], we = ws + lens[s];
      // the row's piece of the window: the candidates whose cell id lies in
      // the three z-cells around the row's in that row of cells
      int lo = 0, hi = 0;
      if (mine && x >= 0 && x < a.gx && y >= 0 && y < a.gy) {
        const int want = (x * a.gy + y) * a.gz;
        lo = lower_bound(a.cells, ws, we, want + zlo);
        hi = lower_bound(a.cells, lo, we, want + zhi + 1);
      }
      walk_window(r, a, g, spos, SLAB_STAGE_CAP, ws, we, lo, hi);
    };
    // the 9 segments (dx, dy), or in 2D the 3 columns dx (y is 0 in (gx, 1, gy))
    if constexpr (NSEG == 9) {
      for (int s = 0; s < 9; ++s) segment(s, cx + s / 3 - 1, cy + s % 3 - 1);
    } else {
      for (int s = 0; s < 3; ++s) segment(s, cx + s - 1, cy);
    }
    r.flush(a);
  }
  store_row(r, a, n_out);
}

template <class B>
struct Launch {
  static int run(const PairArgs& a, int n_out, cudaStream_t s) {
    // the widest block needs more shared memory than a kernel gets unasked:
    // raised once per body, when its first pass is launched
    static const cudaError_t raised =
        cudaFuncSetAttribute(slab_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SLAB_SHARED(MAX_BLOCK));
    if (raised != cudaSuccess) return (int)raised;
    slab_kernel<B><<<a.n / a.block, a.block, SLAB_SHARED(a.block), s>>>(a, n_out);
    return (int)cudaGetLastError();
  }
};

// Launches one pass over all n / block particle blocks; returns the CUDA
// error code (0 = launched).
extern "C" int sph_pair_slab(int body, const PairArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->block <= 0 || a->block > MAX_BLOCK || a->block % 32 != 0 || a->n % a->block != 0)
    return (int)cudaErrorInvalidValue;
  return launch_body<Launch>(body, *a, (cudaStream_t)stream);
}
