// Hopper (sm_90a) kernels of the DIA SpMV and SpMM.
//
//   K8 dia_spmv  <- _dia_kernel (cvr_tpu/ops/pallas_dia.py:39), the
//                   fused roll kernel of spmv_dia_pallas (:93)
//   K11 dia_spmm <- _dia_spmm_kernel (cvr_tpu/ops/pallas_dia.py:137), the
//                   fused halo kernel of spmm_dia_pallas (:184)
//
// K8:
//
//   y[r] = sum_k bands[k, r] * x[r + off[k]],  x read as 0 outside
//   [0, ncols)
//
// The TPU keeps a padded x slab resident in VMEM and builds each shifted
// view with a lane roll and a select, because an unaligned slice of x
// costs it a relayout.  Here a thread owns one output row and reads
// x[r + off] directly: neighbouring threads read neighbouring addresses,
// so every load of a band row and of a shifted x is coalesced whatever
// the offset, and x (8 MB at 2M rows) stays in the 50 MB L2 across the nd
// diagonals.  The bounds check takes the place of the TPU's zero padding
// (and of its slice of x for wide rectangular matrices).  The pass reads
// each band element once (4 B per stored element) and is bound by device
// memory bytes.
//
// K11:
//
//   Y[r, k] = sum_d bands[d, r] * X[r + off[d], k],  X rows read as 0
//   outside [0, ncols)
//
// The TPU puts K in lanes and each diagonal shift on sublanes: a grid
// step reads its (1024, 128) X block and the next one as a halo, so X
// streams once, and the reference falls back to XLA beyond a reach of one
// block or 128 diagonals.  Here one thread owns one output element
// (r, k), k fastest: a warp reads a contiguous piece of one X row per
// diagonal and the band value once (a broadcast), and writes a contiguous
// piece of Y.  The X rows a block touches across the diagonals
// (its rows plus the reach) are re-read from L1/L2, so device memory
// sees bands, X and Y about once: the pass is bound by bytes.  No reach
// or diagonal-count limit, no padded X and no transposed band table.
// Diagonals are summed in pack order.
//
// The entry points launch on the stream they are given and return
// cudaGetLastError(); the Python wrappers raise if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// blocks per SM the grid-stride loop launches at most
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__global__ void dia_spmv_kernel(const float* __restrict__ bands,
                                const int64_t* __restrict__ offsets,
                                const float* __restrict__ x,
                                float* __restrict__ y, int nd,
                                long long nrows, long long ncols) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < nrows; r += stride) {
    float acc = 0.f;
    for (int k = 0; k < nd; ++k) {
      long long c = r + offsets[k];
      if (c >= 0 && c < ncols) acc += bands[k * nrows + r] * __ldg(x + c);
    }
    y[r] = acc;
  }
}

__global__ void dia_spmm_kernel(const float* __restrict__ bands,
                                const int64_t* __restrict__ offsets,
                                const float* __restrict__ X,
                                float* __restrict__ Y, int nd,
                                long long nrows, long long ncols, int K) {
  long long total = nrows * K;
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    long long r = i / K;
    long long k = i - r * K;
    float acc = 0.f;
    for (int d = 0; d < nd; ++d) {
      long long c = r + __ldg(offsets + d);
      if (c >= 0 && c < ncols)
        acc += __ldg(bands + d * nrows + r) * __ldg(X + c * K + k);
    }
    Y[i] = acc;
  }
}

}  // namespace

extern "C" {

int cvr_dia_spmv(const void* bands, const void* offsets, const void* x,
                 void* y, int nd, long long nrows, long long ncols,
                 void* stream) {
  long long want = (nrows + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(kSms) * kBlocksPerSm;
  unsigned int blocks = static_cast<unsigned int>(want < cap ? want : cap);
  dia_spmv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands), static_cast<const int64_t*>(offsets),
      static_cast<const float*>(x), static_cast<float*>(y), nd, nrows, ncols);
  return static_cast<int>(cudaGetLastError());
}

int cvr_dia_spmm(const void* bands, const void* offsets, const void* X,
                 void* Y, int nd, long long nrows, long long ncols, int K,
                 void* stream) {
  long long want = (nrows * K + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(kSms) * kBlocksPerSm;
  unsigned int blocks = static_cast<unsigned int>(want < cap ? want : cap);
  dia_spmm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands), static_cast<const int64_t*>(offsets),
      static_cast<const float*>(X), static_cast<float*>(Y), nd, nrows, ncols,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
