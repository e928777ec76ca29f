// Hopper (sm_90a) kernel of the SELL-W SpMV.
//
//   K10 window_reduce  <- _win_kernel (cvr_tpu/ops/pallas_window.py:61),
//                         via window_reduce (:153), with the emission
//                         sweep it shares with the routed reduce
//                         (cvr_tpu/ops/pallas_route.py:86)
//
// For plane row R, lane p = i*128 + l and idx = li[i, R, l] (in [0, W)):
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
// all groups go in one launch, and x is read in place at the table row's
// column; the bounds check takes the place of the table's zero tail.
//
// What bounds it: bytes.  Per stored element it reads 2 B of li and 4 B
// of vals, and a gather from x (the window of a plane row spans at most
// 2048 columns; x stays in the L2).  The first design (one thread per
// (slice, sublane, lane), one plane row at a time) moved ~6 B a thread per
// dependent step, far too little to cover the memory's latency, and did
// an integer division by 8*(segw+2) per element.  The design:
//   * a thread takes 4 lanes of one sublane: per plane row one 8 B load
//     of li and one 16 B load of vals (the planes are allocated by the
//     upload: 16 B aligned, which the wrapper checks), 4 plane rows at a
//     time, the next 4 rows' loads issued ahead of these rows' 16 x
//     gathers (a slice's last rows padded with rows that gather nothing),
//     at most 64 registers so that 8 blocks fit an SM (fem-like: 0.152 ms
//     against 0.161 at 68 registers; 2 or 8 rows at a time, or no loads
//     ahead, lost);
//   * the window arithmetic is per plane row: a warp's lanes each take one
//     of the next 32 rows, load its w10 and x segment and compute
//     (g0, rr0) = divmod(w10*8, 8*(segw+2)) once; a row's x row of hi is
//     then base + hi, less 8*(segw+2) - 8/G where rr0 + hi wraps into the
//     next grid (hi < wrl <= 8*(segw+2): one wrap at most, which the
//     wrapper checks), handed round by shuffles;
//   * each output is one fmaf chain from 0 in plane-row order (masked
//     elements and pad rows add 0 * 0), the order of the first design's
//     acc += v * x, which nvcc contracts to the same fmaf: the same bits.
// Slices are not cut into pieces: the SELL-W slices pack_auto makes are
// short (fem-like: 27 plane rows on average, 2,048 slices).
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 sublanes x 32 threads
constexpr int kRows = 4;       // plane rows in flight a thread

struct Window {
  int segw, shift, grid_rows, wrl;
  long long ncols;
};

// Rows [R, R + U) of the thread's 4 lanes at plane element pe (row R):
// li and vals of the rows before ``left``, the rest as rows that gather
// nothing (hi past every window, value 0).
template <int U>
__device__ __forceinline__ void load_rows(const int16_t* __restrict__ li,
                                          const float* __restrict__ vals,
                                          unsigned pe, int left, short4 q[U],
                                          float4 v[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < left) {
      q[u] = __ldg(reinterpret_cast<const short4*>(li + pe + u * 128));
      v[u] = __ldg(reinterpret_cast<const float4*>(vals + pe + u * 128));
    } else {
      q[u] = make_short4(0x7fff, 0x7fff, 0x7fff, 0x7fff);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The x gathers of U loaded rows (their window bases and wraps in lanes
// j .. j+U-1 of the warp), then their fmas into acc in row order.
template <int U>
__device__ __forceinline__ void gather_rows(const float* __restrict__ x,
                                            const short4 q[U],
                                            const float4 v[U], int base,
                                            int wrap, int j, const Window& w,
                                            float acc[4]) {
  float xv[U][4], vv[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int b = __shfl_sync(~0u, base, j + u);
    const int wr = __shfl_sync(~0u, wrap, j + u);
    const int idx[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
    const float val[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int hi = idx[t] >> 7;
      const int xrow = b + hi + (hi >= wr ? w.shift - w.grid_rows : 0);
      const long long c = static_cast<long long>(xrow) * 128 + (idx[t] & 127);
      const bool ok = hi < w.wrl && c < w.ncols;
      xv[u][t] = ok ? __ldg(x + c) : 0.f;
      vv[u][t] = ok ? val[t] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = fmaf(vv[u][t], xv[u][t], acc[t]);
}

__global__ void __launch_bounds__(kThreads, 8)
    window_reduce_kernel(const int16_t* __restrict__ li,
                         const float* __restrict__ vals,
                         const int32_t* __restrict__ w10,
                         const int32_t* __restrict__ seg_blk,
                         const float* __restrict__ x,
                         const int32_t* __restrict__ row0,
                         const int32_t* __restrict__ row1,
                         const int32_t* __restrict__ out,
                         float* __restrict__ ys, unsigned S, unsigned nys,
                         Window w, int ch_shift) {
  const unsigned it = blockIdx.x;
  const unsigned i = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  const unsigned lane = threadIdx.x & 31;
  const unsigned l = lane * 4;
  const int r0 = __ldg(row0 + it);
  const int r1 = __ldg(row1 + it);
  const unsigned pe0 = (i * S + static_cast<unsigned>(r0)) * 128 + l;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  short4 q[kRows];
  float4 v[kRows];
  load_rows<kRows>(li, vals, pe0, r1 - r0, q, v);
  int base = 0, wrap = 0;
  for (int R = r0; R < r1; R += kRows) {
    const int j = (R - r0) & 31;  // 32 % kRows == 0
    if (j == 0) {
      // lane j: row R + j's x row of hi = 0 and the hi where it wraps
      base = wrap = 0;
      if (R + static_cast<int>(lane) < r1) {
        const int Rl = R + lane;
        const int t = __ldg(w10 + Rl) * 8;
        const int g0 = t / w.grid_rows;
        const int rr0 = t - g0 * w.grid_rows;
        base = __ldg(seg_blk + (Rl >> ch_shift)) * w.segw * 8 +
               g0 * w.shift + rr0;
        wrap = w.grid_rows - rr0;
      }
    }
    // the next rows' li and vals ahead of these rows' gathers
    short4 qn[kRows];
    float4 vn[kRows];
    load_rows<kRows>(li, vals,
                     pe0 + static_cast<unsigned>(R + kRows - r0) * 128,
                     r1 - R - kRows, qn, vn);
    gather_rows<kRows>(x, q, v, base, wrap, j, w, acc);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      q[u] = qn[u];
      v[u] = vn[u];
    }
  }
  *reinterpret_cast<float4*>(
      ys + (i * nys + static_cast<unsigned>(__ldg(out + it))) * 128 + l) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

extern "C" {

int cvr_window_reduce(const void* li, const void* vals, const void* w10,
                      const void* seg_blk, const void* x, const void* row0,
                      const void* row1, const void* out, void* ys,
                      int nitems, int S, int nys, long long ncols, int segw,
                      int G, int wrl, int ch_shift, void* stream) {
  const Window w{segw, 8 / G, 8 * (segw + 2), wrl, ncols};
  dim3 grid(static_cast<unsigned int>(nitems), 8 / (kThreads / 32));
  window_reduce_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(li), static_cast<const float*>(vals),
      static_cast<const int32_t*>(w10), static_cast<const int32_t*>(seg_blk),
      static_cast<const float*>(x), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(row1), static_cast<const int32_t*>(out),
      static_cast<float*>(ys), static_cast<unsigned>(S),
      static_cast<unsigned>(nys), w, ch_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
