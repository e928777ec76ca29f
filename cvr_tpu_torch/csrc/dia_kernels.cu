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
// the offset.  x's nd reads of an element hit the 50 MB L2 because they
// come close together in time, not because x fits in it: the grid-stride
// sweep launches at most kSms * kBlocksPerSm blocks, half of which are
// resident at full occupancy (8 blocks of 256 threads an SM), so a chunk
// of about 270K consecutive rows is in flight at a time, and the rows
// r = c - off[k] that read x[c] all lie within the reach (max |off|) of
// c.  Where the reach is small beside 270K rows, x comes from device
// memory about once: at banded-2M (reach 13, x 8 MB) and at HPCG's
// 27-point stencil on 256^3 (reach 65,793 rows, x 67 MB, above the L2)
// alike.  There the x elements within the reach of a chunk's two edges
// are fetched again by the chunk on the other side, about (270K + 2 *
// 65,793) / 270K = 1.5 times x in all, 2% of the pass's bytes.
// Measured on an H100 (700 W): 0.7317 ms a pass at 256^3 against its
// 0.5809 ms bound (79.4%), the same share as at banded-2M (0.0923 against
// 0.0726 ms).  The bounds check takes the place of the TPU's zero padding
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
// block or 128 diagonals.  On the H100 the pass is bound by device-memory
// bytes (bands, X and Y once: 1.30 GB at banded-2M, K 64, 0.39 ms), but a
// kernel that reads X per output element from L1/L2 re-reads each X row
// once per diagonal (27x X through the caches at banded-2M) and is bound
// by the caches instead.  So one block owns kTm = 128 output rows by one
// K tile of kKt = 64 columns; the diagonals are cut on the host into
// windows (dia_windows in cvr_tpu_torch/ops/dia_kernels.py: consecutive
// diagonals in pack order whose X rows [r0 + omin, r0 + kTm + omax) by the
// K tile, and band values, fit the window budget, which leaves 2 or more
// blocks an SM), and per window the block
//
//   * copies the window's X rows into shared memory with cp.async, 16 B a
//     copy where K % 4 == 0 and X is 16 B aligned, else 4 B, rows outside
//     [0, ncols) and columns past K zero-filled by a source size of 0,
//     and the window's band values bands[d, r0 .. r0 + kTm) beside them;
//   * waits once, then each thread walks the window's diagonals in pack
//     order with an 8-row by 4-column tile of Y in registers, float4 reads
//     of X and of the bands from shared memory and no per-element
//     division.  Its 8 rows are consecutive, so where a diagonal's offset
//     is the previous one's plus 1 (a band), 7 of its 8 X rows are already
//     in registers: it shifts them and reads one.
//
// Device memory then sees the bands and Y once and X once plus a halo of
// (omax - omin) / kTm of it (20% at banded-2M).  Each output element sums
// its diagonals in pack order, as the plain version does.  Any reach and
// any diagonal count: a reach wider than one window's budget takes more
// windows, each diagonal in exactly one; the last row tile and K tile are
// masked.
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

constexpr int kTm = 128;          // K11: output rows per block
constexpr int kKt = 64;           // K11: K columns per block
constexpr int kSpmmThreads = 256; // 16 row groups of 8 x 16 column groups of 4

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

// thread (ty, tx) = (tid / 16, tid % 16) owns rows r0 + 8*ty .. + 7 and
// columns k0 + 4*tx .. + 3; windows[w] .. windows[w + 1] are window w's
// diagonals.  x16: X is 16 B aligned and K % 4 == 0; b16: bands is 16 B
// aligned and nrows % 4 == 0.
__global__ void __launch_bounds__(kSpmmThreads, 2)
dia_spmm_kernel(const float* __restrict__ bands,
                const int64_t* __restrict__ offsets,
                const int32_t* __restrict__ windows, int nwin,
                const float* __restrict__ X, float* __restrict__ Y,
                long long nrows, long long ncols, int K, bool x16,
                bool b16) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTm;
  const int k0 = blockIdx.y * kKt;
  const int kw = min(kKt, K - k0);  // columns of this K tile

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int w = 0; w < nwin; ++w) {
    const int d0 = __ldg(windows + w), d1 = __ldg(windows + w + 1);
    long long omin = __ldg(offsets + d0), omax = omin;
    for (int d = d0 + 1; d < d1; ++d) {
      const long long o = __ldg(offsets + d);
      omin = o < omin ? o : omin;
      omax = o > omax ? o : omax;
    }
    const int rows = kTm + static_cast<int>(omax - omin);
    float* bs = xs + rows * kKt;  // (d1 - d0) x kTm band values
    const long long g0 = r0 + omin;  // X row of the window's first row
    if (x16) {
      for (int i = tid; i < rows * (kKt / 4); i += kSpmmThreads) {
        const int j = i >> 4, q = i & 15;
        const long long g = g0 + j;
        const bool ok = g >= 0 && g < ncols && q * 4 < kw;
        cp_async16(xs + j * kKt + q * 4, ok ? X + g * K + k0 + q * 4 : X,
                   ok);
      }
    } else {
      for (int i = tid; i < rows * kKt; i += kSpmmThreads) {
        const int j = i >> 6, c = i & 63;
        const long long g = g0 + j;
        const bool ok = g >= 0 && g < ncols && c < kw;
        cp_async4(xs + i, ok ? X + g * K + k0 + c : X, ok);
      }
    }
    const int nb = d1 - d0;
    if (b16) {  // r0 and nrows are multiples of 4: a piece is all in or out
      for (int i = tid; i < nb * (kTm / 4); i += kSpmmThreads) {
        const int d = i >> 5, q = i & 31;
        const long long r = r0 + q * 4;
        const bool ok = r < nrows;
        cp_async16(bs + i * 4, ok ? bands + (d0 + d) * nrows + r : bands,
                   ok);
      }
    } else {
      for (int i = tid; i < nb * kTm; i += kSpmmThreads) {
        const int d = i >> 7, q = i & 127;
        const long long r = r0 + q;
        const bool ok = r < nrows;
        cp_async4(bs + i, ok ? bands + (d0 + d) * nrows + r : bands, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float4 xr[8];  // X rows of the thread's 8 rows on the current diagonal
    long long prev = 0;
    for (int d = d0; d < d1; ++d) {
      const long long off = __ldg(offsets + d);
      const float4* xrow =
          reinterpret_cast<const float4*>(xs + (ty * 8 + (off - omin)) * kKt) +
          tx;
      if (d > d0 && off == prev + 1) {  // a band: shift, read one row
#pragma unroll
        for (int i = 0; i < 7; ++i) xr[i] = xr[i + 1];
        xr[7] = xrow[7 * (kKt / 4)];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) xr[i] = xrow[i * (kKt / 4)];
      }
      prev = off;
      const float4* brow =
          reinterpret_cast<const float4*>(bs + (d - d0) * kTm + ty * 8);
      const float4 ba = brow[0], bb = brow[1];
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(b[i], xr[i].x, acc[i][0]);
        acc[i][1] = fmaf(b[i], xr[i].y, acc[i][1]);
        acc[i][2] = fmaf(b[i], xr[i].z, acc[i][2]);
        acc[i][3] = fmaf(b[i], xr[i].w, acc[i][3]);
      }
    }
    __syncthreads();  // the next window's copies overwrite these
  }

  const int col = k0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = r0 + ty * 8 + i;
    if (row >= nrows || col >= K) continue;
    float* y = Y + row * K + col;
    if ((K & 3) == 0) {  // Y is fresh from torch.empty: 16 B aligned
      *reinterpret_cast<float4*>(y) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < K) y[c] = acc[i][c];
    }
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

int cvr_dia_spmm(const void* bands, const void* offsets, const void* windows,
                 int nwin, int smem, const void* X, void* Y,
                 long long nrows, long long ncols, int K, void* stream) {
  static int smem_allowed = 0;  // the window plan's budget bounds smem
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        dia_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const bool x16 = (K & 3) == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool b16 =
      (nrows & 3) == 0 && reinterpret_cast<uintptr_t>(bands) % 16 == 0;
  dim3 grid(static_cast<unsigned int>((nrows + kTm - 1) / kTm),
            (K + kKt - 1) / kKt);
  dia_spmm_kernel<<<grid, kSpmmThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(windows), nwin,
      static_cast<const float*>(X), static_cast<float*>(Y), nrows, ncols, K,
      x16, b16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
