// Which kernel serves a token of a ragged batch (ragged_attention.cu).
//
// A run is a maximal stretch of consecutive buffer tokens with the same
// row id and a length > 0. A token of a run of two or more tokens belongs
// to a query tile of the tensor-core kernel (ragged_hopper.cuh); a run of
// one token (a decode row, a one-token continuation) to the paged decode
// kernel's split-K walk (paged_attention.cu, ragged_singleton_kernel); a
// token of length
// <= 0 (padding) to neither: the tile kernel writes its zeros. The test
// reads a token and its two neighbours, so each kernel classifies on the
// card, with no scan and nothing read back by the host; the buffer's edges
// count as outside any run.
#pragma once

#include <cuda_runtime.h>

namespace ds_ragged_runs {

// Whether a token (row r, length len) shares its run with a neighbour
// (row rn, length ln), a neighbour outside the buffer having length 0.
__host__ __device__ inline bool joins(int r, int len, int rn, int ln) {
  return len > 0 && ln > 0 && rn == r;
}

// Whether buffer token t of n lies in a run of two or more tokens.
__device__ __forceinline__ bool in_multi_run(const int* row_ids,
                                             const int* lengths, int n,
                                             int t) {
  const int r = row_ids[t], len = lengths[t];
  return (t > 0 && joins(r, len, row_ids[t - 1], lengths[t - 1])) ||
         (t + 1 < n && joins(r, len, row_ids[t + 1], lengths[t + 1]));
}

}  // namespace ds_ragged_runs
