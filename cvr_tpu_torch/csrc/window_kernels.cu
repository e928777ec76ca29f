// Hopper (sm_90a) kernel of the SELL-W SpMV.
//
//   K10 window_reduce  <- _win_kernel (cvr_tpu/ops/pallas_window.py:61),
//                         via window_reduce (:153), with the emission
//                         sweep it shares with the routed reduce
//                         (cvr_tpu/ops/pallas_route.py:86)
//
// For plane row R, lane p = i*128 + l and idx = li[i, R, l]:
//   hi = idx>>7, (g, rr) = divmod(w10[R]*8 + hi, 8*(segw+2)),
//   xrow = seg_blk[R / ch]*segw*8 + g*(8/G) + rr,
//   P[i, R, l] = hi < wrl ? vals[i, R, l] * x[xrow*128 + (idx&127)] : 0
// (x read as 0 past ncols), and slice `it` sums P over plane rows
// [row0[it], row1[it]) into ys[i, out[it], l].
//
// The TPU runs one sequential grid per reduce group: each block loads its
// x segment's table of G shifted window grids into VMEM, gathers every
// row through a WRL-way select over lane gathers of the row's window slab,
// and carries the slice sums across blocks in an emission sweep.  Here
// the host derives each slice's row range once (the routed reduce's
// reduce_table over emit and the reduce groups, no regions), all slices of
// all groups go in one launch, and one thread per (slice, sublane, lane)
// loops over its rows, as K3 does.  x is read in place at the table row's
// column; the bounds check takes the place of the table's zero tail.  Per
// stored element the pass reads 2 B of li and 4 B of vals, coalesced, and
// a window's x (at most 2048 columns) from L1/L2: bound by device memory
// bytes.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void window_reduce_kernel(
    const int16_t* __restrict__ li, const float* __restrict__ vals,
    const int32_t* __restrict__ w10, const int32_t* __restrict__ seg_blk,
    const float* __restrict__ x, const int32_t* __restrict__ row0,
    const int32_t* __restrict__ row1, const int32_t* __restrict__ out,
    float* __restrict__ ys, long long S, long long nys, long long ncols,
    int segw, int G, int wrl, int ch) {
  int it = blockIdx.x;
  long long i = blockIdx.y;
  int l = threadIdx.x;
  const int grid_rows = 8 * (segw + 2);
  const int shift = 8 / G;
  float acc = 0.f;
  for (long long R = row0[it]; R < row1[it]; ++R) {
    long long pe = (i * S + R) * 128 + l;
    int idx = li[pe];
    int hi = idx >> 7;
    if (hi < wrl) {
      int t = w10[R] * 8 + hi;
      int g = t / grid_rows;
      int rr = t - g * grid_rows;
      long long xrow =
          static_cast<long long>(seg_blk[R / ch]) * segw * 8 + g * shift + rr;
      long long c = xrow * 128 + (idx & 127);
      if (c < ncols) acc += vals[pe] * __ldg(x + c);
    }
  }
  ys[(i * nys + out[it]) * 128 + l] = acc;
}

}  // namespace

extern "C" {

int cvr_window_reduce(const void* li, const void* vals, const void* w10,
                      const void* seg_blk, const void* x, const void* row0,
                      const void* row1, const void* out, void* ys,
                      long long nitems, long long S, long long nys,
                      long long ncols, int segw, int G, int wrl, int ch,
                      void* stream) {
  dim3 grid(static_cast<unsigned int>(nitems), 8);
  window_reduce_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(li), static_cast<const float*>(vals),
      static_cast<const int32_t*>(w10), static_cast<const int32_t*>(seg_blk),
      static_cast<const float*>(x), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(row1), static_cast<const int32_t*>(out),
      static_cast<float*>(ys), S, nys, ncols, segw, G, wrl, ch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
