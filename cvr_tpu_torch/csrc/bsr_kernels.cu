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
// f32-grade).
//
// What bounds it here: the dense bricks, read once (64 KB a brick and K
// tile: 3.2 GB at banded-2M, K 64), make the pass bound by device-memory
// bytes once the products run on the tensor cores; in float32 FMAs
// outside them (67 TFLOP/s) it would be bound by operations.  The
// f32-grade product on the tensor cores is 3xTF32, Hopper's counterpart
// of the reference's HIGHEST: each A and X value v is split into
// hi = cvt.rna.tf32.f32(v) and lo = cvt.rna.tf32.f32(v - hi), and
// mma.sync.m16n8k8 (TF32 in, float32 out) takes A_lo X_hi, then A_hi X_lo,
// then A_hi X_hi into a partial sum that starts at 0 for each k-step of 8
// brick columns; the partial is added to the accumulator by a float32
// add.  So the tensor core's own rounding (toward zero) touches only an
// 8-column partial, never the running sum.  A single TF32 pass keeps
// about three decimal digits and would miss the 1e-6 row-scale contract.
//
// The design: one block of 4 warps owns one (row block, 64-column K tile)
// and walks the row block's bricks [row_start[rb], row_start[rb+1]),
// which the host derives once from the sorted brick_row, as one stream of
// (brick, k-chunk) pairs, a k-chunk being 32 brick columns: A 128 x 32
// and X 32 x 64 floats.  The stream passes through a ring of kStages
// stages in shared memory filled by cp.async (16 B copies, and for X 4 B
// where K % 4 != 0 or X is not 16 B aligned; X rows at or past ncols and
// columns past K zero-filled by a source size of 0),
// so the copies of chunk c + 3 are in flight while chunk c is multiplied.
// Each warp owns a 64 x 32 piece of the 128 x 64 output tile (4 x 4 mma
// tiles, accumulators in registers): per k-step it loads and splits 24
// values for 16 mma tiles (8 warps of 32 x 32 took 16 for 8, 11% slower
// on the H100, PERF.md).  Layout: A rows padded to 36 floats and X rows
// to 72, so a warp's fragment loads (A at row g, column t; X at row t,
// column g, for lane = 4g + t) fall in 32 different banks.  Two blocks
// share an SM (108 KB of shared memory each).  The block writes its tile
// once, so a row block without bricks gets zeros: no output element is
// left unwritten, whatever the pack appended.  Any K: the last K tile and
// the last row block are masked.
//
// The entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kB = 128;        // brick edge
constexpr int kKT = 64;        // K columns per block
constexpr int kKC = 32;        // brick columns per chunk
constexpr int kChunks = kB / kKC;
constexpr int kStages = 4;     // the cp.async ring
constexpr int kThreads = 128;  // 4 warps: 2 along the rows x 2 along K
constexpr int kAs = kKC + 4;   // padded A chunk row in shared memory
constexpr int kXs = kKT + 8;   // padded X chunk row
constexpr int kStageFloats = kB * kAs + kKC * kXs;
constexpr int kSmem = kStages * kStageFloats * sizeof(float);

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

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 of v, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy chunk c of the block's stream (brick b0 + c / kChunks, brick
// columns (c % kChunks) * kKC ..) into one ring stage.
__device__ __forceinline__ void load_chunk(
    float* stage, const float* __restrict__ vals,
    const int32_t* __restrict__ brick_col, const float* __restrict__ X,
    long long b0, int c, long long ncols, int K, int k0, int kw, bool x16) {
  const int tid = threadIdx.x;
  const long long b = b0 + c / kChunks;
  const int j0 = (c % kChunks) * kKC;
  const float* A = vals + b * kB * kB + j0;
  float* As = stage;
  float* Xs = stage + kB * kAs;
#pragma unroll
  for (int it = 0; it < kB * kKC / 4 / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i >> 3, q = i & 7;
    cp_async16(As + r * kAs + q * 4, A + r * kB + q * 4, true);
  }
  const long long xrow0 =
      static_cast<long long>(__ldg(brick_col + b)) * kB + j0;
  if (x16) {
#pragma unroll
    for (int it = 0; it < kKC * kKT / 4 / kThreads; ++it) {
      const int i = tid + it * kThreads, j = i >> 4, q = i & 15;
      const long long g = xrow0 + j;
      const bool ok = g < ncols && q * 4 < kw;
      cp_async16(Xs + j * kXs + q * 4, ok ? X + g * K + k0 + q * 4 : X, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kKC * kKT / kThreads; ++it) {
      const int i = tid + it * kThreads, j = i >> 6, q = i & 63;
      const long long g = xrow0 + j;
      const bool ok = g < ncols && q < kw;
      cp_async4(Xs + j * kXs + q, ok ? X + g * K + k0 + q : X, ok);
    }
  }
}

// warp w owns rows 64*(w & 1) .. + 63 and columns 32*(w >> 1) .. + 31 of
// the block's 128 x 64 output tile: mma tiles (mt, nt), mt < 4, nt < 4
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_kernel(const float* __restrict__ vals,
                const int32_t* __restrict__ brick_col,
                const int64_t* __restrict__ row_start,
                const float* __restrict__ X, float* __restrict__ Y,
                long long nrows, long long ncols, int K, bool x16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const long long rb = blockIdx.x;
  const int k0 = blockIdx.y * kKT;
  const int kw = min(kKT, K - k0);
  const long long b0 = row_start[rb];
  const int nch = static_cast<int>(row_start[rb + 1] - b0) * kChunks;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch)
      load_chunk(smem + s * kStageFloats, vals, brick_col, X, b0, s, ncols,
                 K, k0, kw, x16);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int c = 0; c < nch; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    const int cn = c + kStages - 1;
    if (cn < nch)  // into chunk c - 1's stage
      load_chunk(smem + (cn % kStages) * kStageFloats, vals, brick_col, X,
                 b0, cn, ncols, K, k0, kw, x16);
    asm volatile("cp.async.commit_group;\n" ::);

    const float* As = smem + (c % kStages) * kStageFloats;
    const float* Xs = As + kB * kAs;
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 8) {
      uint32_t ahi[4][4], alo[4][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* a = As + (wm + mt * 16 + g) * kAs + ks + t;
        split(a[0], ahi[mt][0], alo[mt][0]);
        split(a[8 * kAs], ahi[mt][1], alo[mt][1]);
        split(a[4], ahi[mt][2], alo[mt][2]);
        split(a[8 * kAs + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* x = Xs + (ks + t) * kXs + wn + nt * 8 + g;
        split(x[0], bhi[nt][0], blo[nt][0]);
        split(x[4 * kXs], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, alo[mt], bhi[nt]);
          mma_tf32(d, ahi[mt], blo[nt]);
          mma_tf32(d, ahi[mt], bhi[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[i];
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // accumulator i of tile (mt, nt): row g (+8 for i >= 2), column 2t + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = rb * kB + wm + mt * 16 + g + 8 * h;
      if (row >= nrows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = k0 + wn + nt * 8 + 2 * t;
        if (col >= K) continue;
        float* y = Y + row * K + col;
        if ((K & 1) == 0) {  // Y is fresh from torch.empty: 8 B aligned
          *reinterpret_cast<float2*>(y) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          y[0] = acc[mt][nt][2 * h];
          if (col + 1 < K) y[1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
}

}  // namespace

extern "C" {

// the dynamic shared memory a block of bsr_spmm_kernel takes
int cvr_bsr_spmm_smem(void) { return kSmem; }

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
  const bool x16 = (K & 3) == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  dim3 grid(static_cast<unsigned int>(nrb), (K + kKT - 1) / kKT);
  bsr_spmm_kernel<<<grid, kThreads, kSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(brick_col),
      static_cast<const int64_t*>(row_start), static_cast<const float*>(X),
      static_cast<float*>(Y), nrows, ncols, K, x16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
