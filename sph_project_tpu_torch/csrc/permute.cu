// Fused multi-field gather: out_k[i, :] = in_k[perm[i], :] for every field k
// in one launch. Applies the per-step cell-sort permutation to all carried
// particle fields.
//
// Replaces the TPU kernel sph_project_tpu/ops/permute.py `_kernel` (launched
// by `permute_fields`), which turned the permutation into one-hot MXU matmuls
// over a DMA'd source span plus a budgeted sparse fix. Here a gather is just
// a gather: every field is moved as raw 32-bit words, so float and int
// fields are copied bit for bit and there is no budget and no overflow.
//
// Bound: device-memory bytes. Each output word is written once and each
// input word read once, plus the permutation once. The sort leaves the
// permutation near-identity, so reads are mostly coalesced. Design: one
// thread per output row, which reads perm[row] once and copies that row of
// every field (a loop over the field table, then over the row's words), so
// one launch covers all fields with no per-word index division. A first
// version with one thread per 32-bit word (an int64 divide and a perm load
// per word) trailed torch.index_select.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_FIELDS 24

struct PermuteArgs {
  const uint32_t* in[MAX_FIELDS];
  uint32_t* out[MAX_FIELDS];
  int words[MAX_FIELDS];  // 32-bit words per row of each field
  int nfields;
  int n;                  // rows
};

// The field tables stay in the constant parameter space (__grid_constant__).
__global__ void permute_kernel(const int64_t* __restrict__ perm,
                               const __grid_constant__ PermuteArgs a) {
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < a.n; row += (int64_t)gridDim.x * blockDim.x) {
    const int64_t src_row = perm[row];
    for (int f = 0; f < a.nfields; ++f) {
      const int w = a.words[f];
      const uint32_t* __restrict__ src = a.in[f] + src_row * w;
      uint32_t* __restrict__ dst = a.out[f] + row * w;
      for (int c = 0; c < w; ++c) dst[c] = src[c];
    }
  }
}

extern "C" int sph_permute(const int64_t* perm, void* const* in, void* const* out,
                           const int* words, int nfields, int n, void* stream) {
  if (nfields < 1 || nfields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  PermuteArgs a;
  for (int k = 0; k < nfields; ++k) {
    a.in[k] = (const uint32_t*)in[k];
    a.out[k] = (uint32_t*)out[k];
    a.words[k] = words[k];
  }
  a.nfields = nfields;
  a.n = n;
  const int threads = 256;
  int64_t blocks = ((int64_t)n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(perm, a);
  return (int)cudaGetLastError();
}
