// Hopper (sm_90a) kernel of the BSR-128 SpMM.
//
//   K12 bsr_spmm  <- _bsr_kernel (cvr_tpu/ops/pallas_bsr.py:42), the fused
//                    brick kernel of bsr_spmm_pallas (:92)
//
//   Y[rb*128 + i, k] = sum over the bricks b of row block rb of
//                      sum_j vals[b, i, j] * X[brick_col[b]*128 + j, k]
//
// with X rows read as 0 at or past ncols.  The TPU walks the brick stream
// in one sequential grid, keeps the output block of the current row block
// resident in VMEM while its bricks pass (zeroing it at the first), and
// multiplies on the MXU at HIGHEST precision (a multi-pass bf16 split,
// f32-grade).  Here one block owns one (row block, 64-column K tile) and
// walks the row block's bricks [row_start[rb], row_start[rb+1]), which the
// host derives once from the sorted brick_row.  Per brick it stages the
// 128 x 128 brick and the 128 x 64 X block in shared memory and every
// thread accumulates an 8 x 4 piece of the output tile in registers with
// float32 FMAs (no tensor cores, no TF32: f32-grade like the reference).
// The block writes its tile once, so a row block without bricks gets
// zeros: no output element is left unwritten, whatever the pack appended.
// Any K: the last K tile and the last row block are masked.
//
// Work: 2 * 128 * 128 * K operations per brick; data: 64 KB of brick per
// brick and K tile.  At K = 64 on banded-2M that is 1.0e11 operations
// against 3.2 GB of bricks: bound by float32 operations (67 TFLOP/s).
// The brick rows are padded to 132 floats in shared memory, so the two
// rows a warp reads at once fall in different banks.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kB = 128;       // brick edge
constexpr int kKT = 64;       // K columns per block
constexpr int kThreads = 256;
constexpr int kAs = kB + 4;   // padded brick row in shared memory
constexpr int kSmem = (kB * kAs + kB * kKT) * sizeof(float);

// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i (i < 8) and
// columns tx*4 .. tx*4 + 3 of the block's 128 x 64 output tile
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ vals,
                const int32_t* __restrict__ brick_col,
                const int64_t* __restrict__ row_start,
                const float* __restrict__ X, float* __restrict__ Y,
                long long nrows, long long ncols, int K) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Xs = As + kB * kAs;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long rb = blockIdx.x;
  const int k0 = blockIdx.y * kKT;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const long long b1 = row_start[rb + 1];
  for (long long b = row_start[rb]; b < b1; ++b) {
    const float4* src = reinterpret_cast<const float4*>(vals + b * kB * kB);
    for (int i = tid; i < kB * kB / 4; i += kThreads) {
      int r = i >> 5, q = i & 31;  // 32 float4 per brick row
      reinterpret_cast<float4*>(As + r * kAs)[q] = __ldg(src + i);
    }
    const long long xrow0 = static_cast<long long>(brick_col[b]) * kB;
    for (int i = tid; i < kB * kKT; i += kThreads) {
      int j = i / kKT, c = i % kKT;
      long long row = xrow0 + j;
      int col = k0 + c;
      Xs[i] = (row < ncols && col < K) ? __ldg(X + row * K + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float4 xv = reinterpret_cast<const float4*>(Xs + j * kKT)[tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = As[(ty + 16 * i) * kAs + j];
        acc[i][0] = fmaf(a, xv.x, acc[i][0]);
        acc[i][1] = fmaf(a, xv.y, acc[i][1]);
        acc[i][2] = fmaf(a, xv.z, acc[i][2]);
        acc[i][3] = fmaf(a, xv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    long long row = rb * kB + ty + 16 * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int col = k0 + tx * 4 + c;
      if (col < K) Y[row * K + col] = acc[i][c];
    }
  }
}

}  // namespace

extern "C" {

int cvr_bsr_spmm(const void* vals, const void* brick_col,
                 const void* row_start, const void* X, void* Y,
                 long long nrb, long long nrows, long long ncols, int K,
                 void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid(static_cast<unsigned int>(nrb), (K + kKT - 1) / kKT);
  bsr_spmm_kernel<<<grid, kThreads, kSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(brick_col),
      static_cast<const int64_t*>(row_start), static_cast<const float*>(X),
      static_cast<float*>(Y), nrows, ncols, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
