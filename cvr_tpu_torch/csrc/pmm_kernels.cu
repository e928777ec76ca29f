// Hopper (sm_90a) kernel of the PMM SpMM.
//
//   K14 pmm_spmm  <- _pmm_kernel (cvr_tpu/ops/spmm_pmm.py:396), via
//                    spmm_pmm (:502)
//
//   Y[128*t + rl[e], k] += val[e] * X[col[e], k]
//
// for every element slot e with col[e] >= 0 of the chunks
// [chunk_start[t], chunk_start[t+1]) of row tile t.  The TPU gathers a
// K-wide X window per (chunk, column window) pair with a one-hot matrix
// product on the MXU and reduces each chunk into its row tile with a
// second one, exact only through a 3-way bf16 split of X and of the
// products; its scalar memory caps a call at 32768 pairs, so long streams
// run as segments whose boundary row tiles are added on the host.  Here
// direct indexing replaces both products: the host derives each slot's
// column (win * 128 + lc), value and row once, and one block (one warp)
// per (row tile, 32 columns of K) walks the tile's chunks in order.  Lane
// k owns column k of a 128 x 32 tile in shared memory, so every sum is
// taken by one thread in slot order: deterministic, no atomics.  Each
// product is one float32 multiply-add, so no split is needed for
// exactness.  The block writes its tile once; an all-pad row tile writes
// zeros.  No segments.
//
// Data: 12 B per element slot, the X rows its columns name (hub columns
// repeat, which L2 serves) and Y once: bound by device memory bytes.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kKT = 32;    // K columns per block, one per lane
constexpr int kRows = 128; // rows per row tile
constexpr int kBatch = 8;  // element slots whose X loads are in flight

__global__ void __launch_bounds__(kKT)
pmm_spmm_kernel(const int32_t* __restrict__ col, const float* __restrict__ val,
                const int32_t* __restrict__ rl,
                const int64_t* __restrict__ chunk_start,
                const float* __restrict__ X, float* __restrict__ Y,
                long long nrows, int K) {
  __shared__ float tile[kRows * kKT];
  const int lane = threadIdx.x;
  const long long t = blockIdx.x;
  const int k = blockIdx.y * kKT + lane;
  for (int r = 0; r < kRows; ++r) tile[r * kKT + lane] = 0.f;
  if (k < K) {
    const long long e1 = chunk_start[t + 1] * 128;
    // 128 slots per chunk: the batches never run past a row tile's end
    for (long long e = chunk_start[t] * 128; e < e1; e += kBatch) {
      float xv[kBatch], vv[kBatch];
      int rr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int c = __ldg(col + e + u);
        vv[u] = __ldg(val + e + u);
        rr[u] = __ldg(rl + e + u);
        xv[u] = c >= 0 ? __ldg(X + static_cast<long long>(c) * K + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        float* y = tile + rr[u] * kKT + lane;
        *y = fmaf(vv[u], xv[u], *y);
      }
    }
  }
  if (k >= K) return;
  for (int r = 0; r < kRows; ++r) {
    long long row = t * kRows + r;
    if (row < nrows) Y[row * K + k] = tile[r * kKT + lane];
  }
}

}  // namespace

extern "C" {

int cvr_pmm_spmm(const void* col, const void* val, const void* rl,
                 const void* chunk_start, const void* X, void* Y,
                 long long nrt, long long nrows, int K, void* stream) {
  dim3 grid(static_cast<unsigned int>(nrt), (K + kKT - 1) / kKT);
  pmm_spmm_kernel<<<grid, kKT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col), static_cast<const float*>(val),
      static_cast<const int32_t*>(rl),
      static_cast<const int64_t*>(chunk_start), static_cast<const float*>(X),
      static_cast<float*>(Y), nrows, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
