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
// range once from the emission plane and X is read in place.
//
// What bounds it: bytes.  Every stored element reads a whole X row piece
// (512 B at K = 128; the L2 serves the hub columns' rows again), beside
// 8 B of plane.  The first design (one thread per output element, each
// walking its slot's rows) had two faults: a slot's rows were a serial
// walk, so the 1,024-row slot of web-Google-like ran alone behind the
// rest, and every thread of a warp reloaded the same column and value.
// The design:
//   * the host cuts every slot's rows into pieces of at most P plane rows
//     (split_rows, made at upload); a block of 8 warps takes one piece, 64
//     lanes of it and one tile of 128 columns of K (32 with the scalar
//     path), so a long slot's pieces run side by side;
//   * a warp takes kLanes lanes of its piece: per plane row it loads their
//     columns and values once (each thread one of them, the next row's
//     ahead of this row's X reads), hands them round by shuffles, and
//     keeps the kLanes X row pieces of the row in flight, 16 B a thread
//     (W = 4: K % 4 == 0 and X 16 B aligned) or 4 B (W = 1: a ragged K or
//     X at a 4 B offset); each output has one accumulator, summed in row
//     order;
//   * a slot of one piece writes its ys rows directly; the pieces of a
//     longer slot write partial blocks, and a second pass
//     (lane_reduce_combine_kernel) adds them in piece order into ys.  No
//     float atomics: the output's bits repeat run to run.
// Index arithmetic is 32-bit: the wrapper refuses planes, X, ys or the
// partials past 2^31 - 1 elements.
//
// The entry points launch on the stream they are given and return
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kLanes = 8;          // plane lanes a warp
constexpr int kLaneBlocks = 1024 / (kLanes * kThreads / 32);  // 16 a piece

template <int W>
struct Vec;

template <>
struct Vec<4> {
  float4 v;
  __device__ __forceinline__ static Vec zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ static Vec load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  }
  __device__ __forceinline__ void fma(float a, const Vec& x) {
    v.x = fmaf(a, x.v.x, v.x);
    v.y = fmaf(a, x.v.y, v.y);
    v.z = fmaf(a, x.v.z, v.z);
    v.w = fmaf(a, x.v.w, v.w);
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec<1> {
  float v;
  __device__ __forceinline__ static Vec zero() { return {0.f}; }
  __device__ __forceinline__ static Vec load(const float* p) {
    return {__ldg(p)};
  }
  __device__ __forceinline__ void fma(float a, const Vec& x) {
    v = fmaf(a, x.v, v);
  }
  __device__ __forceinline__ void store(float* p) const { *p = v; }
};

// blockIdx.x: piece * kLaneBlocks + lane block; blockIdx.y: column tile
// of 32 * W columns.  pieces[3b .. 3b+2]: plane rows [r0, r1) and the
// destination: ys slot dst >= 0, or partial block -1 - dst.
template <int W>
__global__ void __launch_bounds__(kThreads)
    lane_reduce_kernel(const int32_t* __restrict__ cols,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ pieces,
                       const float* __restrict__ X, float* __restrict__ ys,
                       float* __restrict__ part, unsigned K) {
  const unsigned b = blockIdx.x / kLaneBlocks;
  const unsigned t = threadIdx.x & 31;
  const unsigned l0 =
      ((blockIdx.x % kLaneBlocks) * (kThreads / 32) + (threadIdx.x >> 5)) *
      kLanes;
  const unsigned k = (blockIdx.y * 32 + t) * W;
  const bool live = k < K;  // W == 4: K % 4 == 0, so k + 3 < K too
  const int r0 = __ldg(pieces + 3 * b);
  const int r1 = __ldg(pieces + 3 * b + 1);
  const int dst = __ldg(pieces + 3 * b + 2);
  Vec<W> acc[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) acc[j] = Vec<W>::zero();
  // thread t loads lane l0 + (t % kLanes) of each row
  const unsigned lt = l0 + (t % kLanes);
  int c = 0;
  float v = 0.f;
  if (r0 < r1) {
    c = __ldg(cols + static_cast<unsigned>(r0) * 1024 + lt);
    v = __ldg(vals + static_cast<unsigned>(r0) * 1024 + lt);
  }
  for (int r = r0; r < r1; ++r) {
    int cn = 0;
    float vn = 0.f;
    if (r + 1 < r1) {  // the next row's column and value, ahead
      cn = __ldg(cols + static_cast<unsigned>(r + 1) * 1024 + lt);
      vn = __ldg(vals + static_cast<unsigned>(r + 1) * 1024 + lt);
    }
    Vec<W> x[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const unsigned cj = static_cast<unsigned>(__shfl_sync(~0u, c, j));
      x[j] = live ? Vec<W>::load(X + cj * K + k) : Vec<W>::zero();
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      acc[j].fma(__shfl_sync(~0u, v, j), x[j]);
    c = cn;
    v = vn;
  }
  if (!live) return;
  float* o = dst >= 0
                 ? ys + (static_cast<unsigned>(dst) * 1024 + l0) * K
                 : part + (static_cast<unsigned>(-1 - dst) * 1024 + l0) * K;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) acc[j].store(o + j * K + k);
}

// K13's second pass: each split slot's partial blocks [c0, c1) (1024 * K
// contiguous elements each), added in piece order into its ys block out,
// 16 B a thread (1024 * K is a multiple of 4 whatever K is).
// blockIdx.x: the split slot; blockIdx.y strides over its block.
__global__ void __launch_bounds__(kThreads)
    lane_reduce_combine_kernel(const float4* __restrict__ part,
                               const int32_t* __restrict__ combine,
                               float4* __restrict__ ys, unsigned n4) {
  const int c0 = __ldg(combine + 3 * blockIdx.x);
  const int c1 = __ldg(combine + 3 * blockIdx.x + 1);
  const unsigned out =
      static_cast<unsigned>(__ldg(combine + 3 * blockIdx.x + 2));
  for (unsigned e = blockIdx.y * kThreads + threadIdx.x; e < n4;
       e += gridDim.y * kThreads) {
    float4 s = part[static_cast<unsigned>(c0) * n4 + e];
    for (int c = c0 + 1; c < c1; ++c) {
      const float4 p = part[static_cast<unsigned>(c) * n4 + e];
      s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
    }
    ys[out * n4 + e] = s;
  }
}

}  // namespace

extern "C" {

int cvr_lane_reduce(const void* cols, const void* vals, const void* pieces,
                    const void* X, void* ys, void* part, int npieces, int K,
                    int vec, void* stream) {
  const int W = vec ? 4 : 1;
  dim3 grid(static_cast<unsigned int>(npieces) * kLaneBlocks,
            static_cast<unsigned int>((K + 32 * W - 1) / (32 * W)));
  auto kernel = vec ? lane_reduce_kernel<4> : lane_reduce_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const int32_t*>(pieces), static_cast<const float*>(X),
      static_cast<float*>(ys), static_cast<float*>(part), K);
  return static_cast<int>(cudaGetLastError());
}

int cvr_lane_reduce_combine(const void* part, const void* combine, void* ys,
                            int ncombine, int K, void* stream) {
  const unsigned n4 = 256u * static_cast<unsigned>(K);  // 1024 * K / 4
  // 8 float4 a thread at most
  const unsigned by = (n4 + kThreads * 8 - 1) / (kThreads * 8);
  dim3 grid(static_cast<unsigned int>(ncombine), by);
  lane_reduce_combine_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(part), static_cast<const int32_t*>(combine),
      static_cast<float4*>(ys), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
