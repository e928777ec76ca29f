// Hopper (sm_90a) kernel of the BELL SpMV.
//
//   K9 bell_gather_mac  <- _bell_kernel (cvr_tpu/ops/pallas_bell.py:72),
//                          via bell_gather_mac (:149)
//
//   y[q, l] = sum_p vals[p, q, l] * x[c],
//   c = (8*(q>>3) + d + (li>>7) - pre)*128 + (li & 127),  li = li[p, q, l]
//
// with x read as 0 outside [0, n_keep).  Row r of the matrix is element
// (q, l) = (r>>7, r&127), so y comes out in natural row order.  The TPU
// builds a zero-padded x table, loads one aligned 128-row slab of it per
// 8-tile group into VMEM and gathers each element by an ncand-way select
// over lane gathers of the slab's rows.  Here one thread owns one output
// element, loops over the k planes and reads x in place at the column the
// plane gives: li and vals are read coalesced (4 + 2 B per stored
// element), and the x reads of a warp fall in one tile's window of at most
// 16 x 128 columns, which L1/L2 serve.  The bounds check takes the place of
// the table's zero padding.  The pass is bound by device memory bytes.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void bell_gather_mac_kernel(const int16_t* __restrict__ li,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ x,
                                       float* __restrict__ y, int k,
                                       long long R_sub, int d, int pre,
                                       long long n_keep) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long n = R_sub * 128;
  if (e >= n) return;
  long long base = 8 * ((e >> 7) >> 3) + d - pre;  // window's first row
  float acc = 0.f;
  for (int p = 0; p < k; ++p) {
    long long pe = p * n + e;
    int idx = li[pe];
    long long c = (base + (idx >> 7)) * 128 + (idx & 127);
    if (c >= 0 && c < n_keep) acc += vals[pe] * __ldg(x + c);
  }
  y[e] = acc;
}

}  // namespace

extern "C" {

int cvr_bell_gather_mac(const void* li, const void* vals, const void* x,
                        void* y, int k, long long R_sub, int d, int pre,
                        long long n_keep, void* stream) {
  long long n = R_sub * 128;
  bell_gather_mac_kernel<<<static_cast<unsigned int>((n + kThreads - 1) /
                                                     kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(li), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), k, R_sub, d, pre,
      n_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
