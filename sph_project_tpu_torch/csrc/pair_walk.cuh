// The compacted candidate walk both pair kernels share (pair_pass.cu: the
// cell-list engine; pair_slab.cu: the slab-window engine).
//
// One thread owns one row i and keeps its sums in registers. A group of
// threads (a warp in the cell-list kernel, a block in the slab-window kernel)
// owns a run of consecutive sorted rows. Per segment s = (dx, dy) the group
// has one window [ws, we) of sorted particles that holds the candidates of
// all its rows, and each row has one contiguous run [lo, hi) inside it; the
// engine says where both lie. walk_window() stages the window's positions in
// shared memory with cp.async, a tile at a time, 16 bytes a candidate so
// that one load fetches a position (8 bytes in 2D, in the same room: the
// tiles keep their size, so the kernels keep their shared memory and
// occupancy in 2D); a tile no row has a run in is skipped before it is
// loaded. The work per candidate is split in two so that the expensive half
// runs on full warps:
//
//   test   R = x_i - x_j, d2 = (R0*R0 + R1*R1) + R2*R2 (2D: R0*R0 + R1*R1),
//          d2 < h^2, j != i,
//          from the staged positions (rows of one cell read the same
//          words); a candidate that passes is appended to the row's own
//          short list in shared memory (LIST_CAP indices j);
//   body   when any lane of the warp has filled its list, or the walk has
//          ended, every lane runs body.pair over its list, reading j's
//          fields from device memory.
//
// About one candidate in seven passes the test; the body loop runs about as
// many iterations as the fullest list of the warp holds. A list is flushed
// and refilled, never cut: a row may have any number of neighbours. Lists
// keep j ascending and are flushed in order, so a row's sums are added in the
// same order under both engines and are bit-equal between them. The body
// phase recomputes R and d2 from the same operands in the same order as the
// test, so the rounding at the support radius is the test's.
//
// The walk is a template on the dimension, the body's DIM. A 2D
// grid (gx, gy), whose flat cell id is x*gy + y, arrives as the 3D grid
// (gx, 1, gy) with the same ids (ops/pairs.py grid3): a row of cells is one
// x, and a row's stencil is the 3 segments dx = -1, 0, 1, each over the
// three cells y-1..y+1 of that column.
#pragma once

#include "pair_bodies.cuh"

#define FULL_MASK 0xffffffffu
#define LIST_CAP 32  // entries of a row's list

// a staged candidate position: 16 bytes in 3D, 8 in 2D
template <int DIM>
struct Staged {
  using type = float4;
};
template <>
struct Staged<2> {
  using type = float2;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The threads that stage and synchronise together: the 32 lanes of a warp ...
struct WarpGroup {
  int tid;  // lane
  __device__ int size() const { return 32; }
  __device__ bool any(bool p) const { return __any_sync(FULL_MASK, p); }
  __device__ void sync() const { __syncwarp(); }
};

// ... or all threads of a block.
struct BlockGroup {
  int tid;
  __device__ int size() const { return blockDim.x; }
  __device__ bool any(bool p) const { return __syncthreads_or(p); }
  __device__ void sync() const { __syncthreads(); }
};

// A body that counts the candidates its row tests (PairCount, the counting
// walk) says so with COUNTS_TESTS: the walk adds them to its last sum. No
// other body declares it, and their walks compile as they would without it.
template <class B, class = void>
struct CountsTests {
  static constexpr bool value = false;
};
template <class B>
struct CountsTests<B, decltype(void(B::COUNTS_TESTS))> {
  static constexpr bool value = B::COUNTS_TESTS;
};

// One row's state: its position, the body's own fields, the sums and the list.
template <class B>
struct Row {
  static constexpr int DIM = B::DIM;
  using S = typename Staged<DIM>::type;
  B body;
  float acc[B::NOUT];
  float x[DIM];
  int i;
  int* list;  // entry k at list[k * stride]
  int* top;   // where the next entry goes
  int stride;

  __device__ void init(const PairArgs& a, int row, bool mine, int* list_, int stride_) {
#pragma unroll
    for (int k = 0; k < B::NOUT; ++k) acc[k] = 0.0f;
    i = row;
    list = top = list_;
    stride = stride_;
#pragma unroll
    for (int d = 0; d < DIM; ++d) x[d] = 0.0f;
    if (mine) {
      body.load(a, row);
#pragma unroll
      for (int d = 0; d < DIM; ++d) x[d] = a.pos[DIM * row + d];
    }
  }

  __device__ __forceinline__ float dist2(const float* R) const {
    return DIM == 3 ? R[0] * R[0] + R[1] * R[1] + R[2] * R[2] : R[0] * R[0] + R[1] * R[1];
  }

  // The body over the listed neighbours, in the order they were found.
  __device__ void flush(const PairArgs& a) {
    for (const int* q = list; q != top; q += stride) {
      const int j = *q;
      float R[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) R[d] = x[d] - a.pos[DIM * j + d];
      body.pair(a, j, R, dist2(R), acc);
    }
    top = list;
  }

  // One candidate, j, at position p. The index is written whether or not the
  // candidate passes (the entry is free) and kept only if it does, so the
  // lanes of a warp do not part ways here.
  __device__ __forceinline__ void test(const PairArgs& a, const float4 p, int j) {
    const float R[3] = {x[0] - p.x, x[1] - p.y, x[DIM - 1] - p.z};
    test_d2(a, dist2(R), j);
  }
  __device__ __forceinline__ void test(const PairArgs& a, const float2 p, int j) {
    const float R[2] = {x[0] - p.x, x[1] - p.y};
    test_d2(a, dist2(R), j);
  }
  __device__ __forceinline__ void test_d2(const PairArgs& a, float d2, int j) {
    *top = j;
    top += (d2 < a.dh2 && j != i) ? stride : 0;
  }

  // Tests candidates j0 <= j < j1, candidate j's position staged at sp[j].
  // Every lane of the warp calls it, with an empty run if it has none: the
  // decision to flush is taken by the warp.
  __device__ void walk(const PairArgs& a, const S* sp, int j0, int j1) {
    if constexpr (CountsTests<B>::value) acc[B::NOUT - 1] += (float)max(j1 - j0, 0);
    int j = j0;
    const int* const full = list + LIST_CAP * stride;
    for (;;) {
      while (j < j1 && top != full) {
        test(a, sp[j], j);
        ++j;
      }
      // a lane that stopped short of its run's end has a full list
      if (!__any_sync(FULL_MASK, j < j1)) break;
      flush(a);
    }
  }
};

// One segment of one group: stages the window [ws, we) of sorted positions
// through `room` (room for `cap` candidates of 16 bytes) a tile at a time;
// each row tests its run [lo, hi) (empty: lo >= hi) as the tiles pass. ws,
// we and cap are the same for every thread of the group.
template <class G, class B>
__device__ void walk_window(Row<B>& r, const PairArgs& a, const G& g, float4* room, int cap,
                            int ws, int we, int lo, int hi) {
  constexpr int DIM = Row<B>::DIM;
  using S = typename Row<B>::S;
  S* spos = reinterpret_cast<S*>(room);
  for (int t0 = ws; t0 < we; t0 += cap) {
    const int t1 = min(t0 + cap, we);
    const int j0 = max(lo, t0), j1 = min(hi, t1);
    if (!g.any(j0 < j1)) continue;
    const float* src = a.pos + DIM * (size_t)t0;
    for (int c = g.tid; c < t1 - t0; c += g.size()) {
      float* dst = reinterpret_cast<float*>(spos + c);
#pragma unroll
      for (int d = 0; d < DIM; ++d) cp_async4(dst + d, src + DIM * c + d);
    }
    cp_async_wait_all();
    g.sync();
    r.walk(a, spos - t0, j0, j1);
    g.sync();
  }
}

// Writes a row's sums, component-major (n_out, n).
template <class B>
__device__ void store_row(const Row<B>& r, const PairArgs& a, int n_out) {
#pragma unroll
  for (int k = 0; k < B::NOUT; ++k)
    if (k < n_out) a.out[(size_t)k * a.n + r.i] = r.acc[k];
}
