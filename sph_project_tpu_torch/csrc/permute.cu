// Fused multi-field gather: out_k[i, :] = in_k[perm[i], :] for every field k
// in one launch. Applies the per-step cell-sort permutation to all carried
// particle fields, and packs and unpacks the rows of the global resort
// (parallel/spatial.py), whose fields travel side by side in one (n, W)
// int32 word buffer.
//
// Replaces the TPU kernel sph_project_tpu/ops/permute.py `_kernel` (launched
// by `permute_fields`), which turned the permutation into one-hot MXU matmuls
// over a DMA'd source span plus a budgeted sparse fix. Here a gather is just
// a gather: every field is moved as raw 32-bit words, so float and int
// fields are copied bit for bit and there is no budget and no overflow.
//
// Bound: device-memory bytes. Each output word is written once and each
// input word read once, plus the permutation once. The sort leaves the
// permutation near-identity, so the source rows of a tile of destination
// rows lie mostly in one span.
//
// Design. A block owns a tile of PERMUTE_TILE destination rows. It reads
// perm for its rows once (int64, as torch.sort gives it) into shared memory,
// then stages every word of the tile in shared memory with 4-byte cp.async:
// for each source, consecutive threads take consecutive words of its rows
// (coalesced reads of near-identity rows), with the word width a
// compile-time case (1, 2, 3) so the copy is unrolled, and all of the
// tile's copies are issued before any is waited for: 32 a thread for the
// flagship's 16 words a row, so the few blocks an SM holds keep many times
// the bytes in flight that the memory's latency needs. The staged tile has
// the destinations' layout: each destination's rows are one contiguous
// span there, written out with uint4 stores after a shared-memory load of
// 16 bytes, a few scalar words at the ends where the span's base is not
// 16-byte aligned or its length not a multiple of 4 words (the host places
// each span so that the two alignments agree). A source and a destination
// are each contiguous rows of some words, and a table of columns says where
// each word of a source's row goes in the tile, so one kernel serves three
// uses:
//   - the sort's gather: each field a source and a destination;
//   - the resort's pack: the fields the sources, one (n, W) buffer the
//     destination;
//   - the resort's unpack: the buffer's rows the one source, each field a
//     destination (the column table sends each word to its field's span;
//     the spans start in different banks, so a row's words collide less).

#include <cuda_runtime.h>
#include <stdint.h>

// destination rows per block (ops/permute.py TILE) and threads per block:
// the fastest on the flagship's shapes of the tiles of 64-1024 rows and
// blocks of 64-512 threads tried on the H100
#define PERMUTE_TILE 256
#define PERMUTE_THREADS 128
#define MAX_SEGS 24        // sources, and destinations, per launch
#define MAX_COLS 64        // 32-bit words of a destination row over all fields

static_assert(PERMUTE_TILE % PERMUTE_THREADS == 0 && PERMUTE_TILE % 4 == 0,
              "a tile is whole rounds of the block's threads and of uint4s");

struct Source {
  const uint32_t* ptr;  // rows of `words` words, contiguous
  int words;
  int col;           // its first column in the column table
  int at, step;      // staged word of (row r, word c): at + r * step + c;
                     // step 0: through the column table
};

struct Dest {
  uint32_t* ptr;     // rows of `words` words, contiguous
  int words;
  int at;            // its staged span's first word
};

struct PermuteArgs {
  Source src[MAX_SEGS];
  Dest dst[MAX_SEGS];
  int col_at[MAX_COLS];    // staged word of column c in row 0
  int col_step[MAX_COLS];  // staged words between rows of column c
  long long n;             // rows
  int nsrc, ndst, ncols;
};

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Stage a source of W words a row whose columns lie in one destination.
template <int W>
__device__ __forceinline__ void stage(uint32_t* tile, const Source& s,
                                      const int64_t* rows, int nrows) {
#pragma unroll
  for (int k = 0; k < W * PERMUTE_TILE / PERMUTE_THREADS; ++k) {
    const int e = threadIdx.x + k * PERMUTE_THREADS;
    const int r = e / W, c = e - r * W;
    if (r < nrows)
      cp_async4(tile + s.at + r * s.step + c, s.ptr + rows[r] * W + c);
  }
}

// Any other source: a wider row, or columns spread over destinations.
__device__ void stage_any(uint32_t* tile, const Source& s, const int* col_at,
                          const int* col_step, const int64_t* rows,
                          int nrows) {
  const int w = s.words, total = nrows * w;
  const int dr = PERMUTE_THREADS / w, dc = PERMUTE_THREADS % w;
  int r = threadIdx.x / w, c = threadIdx.x % w;
  for (int e = threadIdx.x; e < total; e += PERMUTE_THREADS) {
    const int at = s.step ? s.at + r * s.step + c
                          : col_at[s.col + c] + r * col_step[s.col + c];
    cp_async4(tile + at, s.ptr + rows[r] * w + c);
    r += dr;
    c += dc;
    if (c >= w) { c -= w; ++r; }
  }
}

// A destination's span of `len` words from its staged span `s`.
__device__ __forceinline__ void store_span(const uint32_t* s, uint32_t* d,
                                           int len) {
  const int head = min(len, (int)(((16u - ((unsigned)(uintptr_t)d & 15u)) &
                                   15u) >> 2));
  const int nvec = (len - head) >> 2;
  const int tail = head + 4 * nvec;
  if ((int)threadIdx.x < head) d[threadIdx.x] = s[threadIdx.x];
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* dv = reinterpret_cast<uint4*>(d + head);
#pragma unroll 4
  for (int v = threadIdx.x; v < nvec; v += PERMUTE_THREADS) dv[v] = sv[v];
  if ((int)threadIdx.x < len - tail) d[tail + threadIdx.x] = s[tail + threadIdx.x];
}

__global__ void __launch_bounds__(PERMUTE_THREADS)
permute_kernel(const int64_t* __restrict__ perm,
               const __grid_constant__ PermuteArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  int64_t* rows = reinterpret_cast<int64_t*>(smem);  // source row of each row
  int* col_at = reinterpret_cast<int*>(rows + PERMUTE_TILE);
  int* col_step = col_at + MAX_COLS;
  uint32_t* tile = reinterpret_cast<uint32_t*>(col_step + MAX_COLS);

  const long long r0 = (long long)blockIdx.x * PERMUTE_TILE;
  const int nrows = (int)min((long long)PERMUTE_TILE, a.n - r0);
  for (int t = threadIdx.x; t < nrows; t += PERMUTE_THREADS) rows[t] = perm[r0 + t];
  for (int c = threadIdx.x; c < a.ncols; c += PERMUTE_THREADS) {
    col_at[c] = a.col_at[c];
    col_step[c] = a.col_step[c];
  }
  __syncthreads();

  for (int i = 0; i < a.nsrc; ++i) {
    const Source& s = a.src[i];
    if (s.step && s.words == 1) stage<1>(tile, s, rows, nrows);
    else if (s.step && s.words == 2) stage<2>(tile, s, rows, nrows);
    else if (s.step && s.words == 3) stage<3>(tile, s, rows, nrows);
    else stage_any(tile, s, col_at, col_step, rows, nrows);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int o = 0; o < a.ndst; ++o) {
    const Dest& d = a.dst[o];
    store_span(tile + d.at, d.ptr + r0 * d.words, nrows * d.words);
  }
}

// layout (ops/permute.py `plan`): tile, nsrc, ndst, ncols, tile_words; per
// source words, col, at, step; per destination words, at; per column at,
// step. src / dst: the sources' and destinations' addresses.
extern "C" int sph_permute(const int64_t* perm, long long n, const int* layout,
                           const void* const* src, void* const* dst,
                           void* stream) {
  PermuteArgs a;
  a.n = n;
  a.nsrc = layout[1];
  a.ndst = layout[2];
  a.ncols = layout[3];
  const int tile_words = layout[4];
  if (layout[0] != PERMUTE_TILE || n < 1 || a.nsrc < 1 || a.nsrc > MAX_SEGS ||
      a.ndst < 1 || a.ndst > MAX_SEGS || a.ncols < 1 || a.ncols > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  const int* p = layout + 5;
  for (int i = 0; i < a.nsrc; ++i, p += 4)
    a.src[i] = Source{(const uint32_t*)src[i], p[0], p[1], p[2], p[3]};
  for (int o = 0; o < a.ndst; ++o, p += 2)
    a.dst[o] = Dest{(uint32_t*)dst[o], p[0], p[1]};
  for (int c = 0; c < a.ncols; ++c, p += 2) {
    a.col_at[c] = p[0];
    a.col_step[c] = p[1];
  }
  const size_t smem = PERMUTE_TILE * sizeof(int64_t) + 2 * MAX_COLS * sizeof(int) +
                      (size_t)tile_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + PERMUTE_TILE - 1) / PERMUTE_TILE;
  permute_kernel<<<(unsigned)blocks, PERMUTE_THREADS, smem, (cudaStream_t)stream>>>(
      perm, a);
  return (int)cudaGetLastError();
}
