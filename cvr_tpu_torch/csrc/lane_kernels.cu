// Hopper (sm_90a) kernel of the lane SpMM.
//
//   K13 lane_reduce  <- _lane_reduce_kernel (cvr_tpu/ops/spmm_lane.py:181),
//                       via spmm_lane (:242)
//
//   ys[s*1024 + l, k] = sum_{r in [row0[s], row1[s])}
//                       vals[r, l] * X[cols[r*1024 + l], k]
//
// for every output slot s (a slice of the SELL planes, C = 1024; a slot
// that no slice fills has an empty range and gets zeros).  The TPU first
// materializes gx = X[cols] in plane order with an XLA row gather (at
// K = 128 on a web-scale matrix that is gigabytes), then streams (8, 1024,
// 128) blocks of it through a kernel that accumulates rows in VMEM and
// emits a slice's sum where the emission plane says so, one call per
// 128-column chunk of X.  Here the host derives each slot's plane-row
// range once from the emission plane, one thread owns one output element
// (slot, lane, k), k fastest, and reads X in place: a warp reads one
// plane element's column and value once (a broadcast) and a contiguous
// piece of the X row it names.  One launch serves every K.  The pass reads
// the planes (8 B per stored element) and one X row piece per stored
// element and K column, which L2 serves for repeated columns: bound by
// device memory bytes.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__global__ void lane_reduce_kernel(const int32_t* __restrict__ cols,
                                   const float* __restrict__ vals,
                                   const int32_t* __restrict__ row0,
                                   const int32_t* __restrict__ row1,
                                   const float* __restrict__ X,
                                   float* __restrict__ ys, long long nslots,
                                   int K) {
  long long total = nslots * 1024 * K;
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    long long t = i / K;
    long long k = i - t * K;
    long long s = t >> 10;
    long long lane = t & 1023;
    int r1 = __ldg(row1 + s);
    float acc = 0.f;
    for (long long r = __ldg(row0 + s); r < r1; ++r) {
      long long p = r * 1024 + lane;
      acc = fmaf(__ldg(vals + p),
                 __ldg(X + static_cast<long long>(__ldg(cols + p)) * K + k),
                 acc);
    }
    ys[i] = acc;
  }
}

}  // namespace

extern "C" {

int cvr_lane_reduce(const void* cols, const void* vals, const void* row0,
                    const void* row1, const void* X, void* ys,
                    long long nslots, int K, void* stream) {
  long long want = (nslots * 1024 * K + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(kSms) * kBlocksPerSm;
  unsigned int blocks = static_cast<unsigned int>(want < cap ? want : cap);
  lane_reduce_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const int32_t*>(row0), static_cast<const int32_t*>(row1),
      static_cast<const float*>(X), static_cast<float*>(ys), nslots, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
