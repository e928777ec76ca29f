// Hopper (sm_90a) kernels of the PMM SpMM.
//
//   K14 pmm_spmm  <- _pmm_kernel (cvr_tpu/ops/spmm_pmm.py:396), via
//                    spmm_pmm (:502)
//
//   Y[r, k] = sum_{e in [rowptr[r], rowptr[r+1])} val[e] * X[col[e], k]
//
// The TPU gathers a K-wide X window per (chunk, column window) pair with
// a one-hot matrix product on the MXU and reduces each 128-slot chunk
// into its row tile with a second one, exact only through a 3-way bf16
// split of X and of the products; its scalar memory caps a call at 32768
// pairs, so long streams run as segments whose boundary row tiles are
// added on the host.  Here direct indexing replaces both products: at
// upload the host turns the plan's element slots into the entries of each
// row in column order (pads dropped: 8 B an entry) and plans the work.
//
// What bounds it: bytes.  Each entry reads 8 B and one X row piece (the
// L2 serves the hub columns' rows and the forward links' neighbouring
// rows again), and Y is written once.  The first design (one warp per
// 128-row tile and 32 columns, a 16 KB shared tile) was bound by latency:
// shared memory held an SM to 14 warps, each walked its tile's slots
// alone with 8 in flight, and every lane reloaded each slot's column,
// value and row.  The design:
//   * the host cuts the rows into segments of at most P entries (a longer
//     row into pieces, split_rows) and groups them into units of at most
//     32 segments (pmm_units), one unit a warp, 4 warps a block, no shared
//     memory: the accumulators live in registers;
//   * a warp is 4 groups of 8 lanes; group g takes the unit's segments g,
//     g + 4, ...; lane j of a group loads entry j of the segment's next
//     batch of kBatch entries (column and value, coalesced; the next
//     batch's ahead of this batch's X reads) and hands them round by
//     shuffles; the group then has the batch's X row pieces in flight,
//     16 B a lane (W = 4: K % 4 == 0 and X 16 B aligned; 8 lanes cover 32
//     columns) or 4 B (W = 1: a ragged K or X at a 4 B offset; 8 columns),
//     before their fmas; columns of K beyond one tile go to grid.y.  What
//     set the sizes (fsm-like, K 32): registers.  A batch of 4 (48
//     registers) beat 8 (64; 0.30 against 0.34 ms) and 2, 4 warps a block
//     beat 8, 16 lanes of 2 floats lost (0.44), and loading the entries
//     two batches ahead (72 registers) lost too;
//   * each output is one fmaf chain from 0 over its segment's entries in
//     column order: a row of one segment equals the first design's slot
//     walk bit for bit.  The pieces of a split row write partial rows,
//     and a second pass (pmm_spmm_combine_kernel) adds them in piece
//     order.  No float atomics: the output's bits repeat run to run.
// Index arithmetic is 32-bit: the wrapper refuses entries, X, Y or the
// partials past 2^31 - 1 elements.
//
// The entry points launch on the stream they are given and return
// cudaGetLastError(); the Python wrapper raises if that is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps, one unit each
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;      // lanes of a group
constexpr int kBatch = 4;      // entries a group has in flight

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

// blockIdx.x * kWarps + warp: the unit; blockIdx.y: the column tile of
// kGroup * W columns.  units[3u .. 3u+2]: segments [s0, s1) and the
// destination of s0 (row >= 0, or partial -1 - d0); segment s0 + j goes
// to the destination's j-th successor.
template <int W>
__global__ void __launch_bounds__(kThreads)
    pmm_spmm_kernel(const int32_t* __restrict__ col,
                    const float* __restrict__ val,
                    const int32_t* __restrict__ segptr,
                    const int32_t* __restrict__ units,
                    const float* __restrict__ X, float* __restrict__ Y,
                    float* __restrict__ part, unsigned nunits, unsigned K) {
  constexpr int L = kGroup;
  constexpr int nG = 32 / L;  // groups a warp
  const unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= nunits) return;  // uniform over the warp
  const unsigned lane = threadIdx.x & 31;
  const unsigned g = lane / L;
  const unsigned jl = lane % L;
  const unsigned gmask = ((1u << L) - 1) << (g * L);
  const unsigned k = (blockIdx.y * L + jl) * W;
  const bool live = k < K;  // W == 4: K % 4 == 0, so k + 3 < K too
  const int s0 = __ldg(units + 3 * u);
  const int s1 = __ldg(units + 3 * u + 1);
  const int d0 = __ldg(units + 3 * u + 2);
  // lane l reads segment s0 + l's entry range (at most 32 segments) ...
  int ra = 0, rb = 0;
  if (s0 + static_cast<int>(lane) < s1) {
    ra = __ldg(segptr + s0 + lane);
    rb = __ldg(segptr + s0 + lane + 1);
  }
  // ... and lane jl of group g takes over that of the group's segment jl
  // (the unit's segment g + nG * jl)
  const int ga = __shfl_sync(~0u, ra, g + nG * jl);
  const int gb = __shfl_sync(~0u, rb, g + nG * jl);
  const int nmine = (s1 - s0 - static_cast<int>(g) + nG - 1) / nG;
  if (nmine <= 0) return;  // uniform over the group
  float* out = d0 >= 0 ? Y + static_cast<unsigned>(d0) * K
                       : part + static_cast<unsigned>(-1 - d0) * K;
  int i = 0;  // the group's segment
  int e = __shfl_sync(gmask, ga, 0, L);
  int e1 = __shfl_sync(gmask, gb, 0, L);
  int c = 0;
  float w = 0.f;
  if (jl < kBatch && e + static_cast<int>(jl) < e1) {
    c = __ldg(col + e + jl);
    w = __ldg(val + e + jl);
  }
  Vec<W> acc = Vec<W>::zero();
  for (;;) {
    // the next batch: this segment's next kBatch entries, or the group's
    // next segment's first; its columns and values ahead
    const bool last = e + kBatch >= e1;
    const int ni = last ? i + 1 : i;
    const int sa = __shfl_sync(gmask, ga, (i + 1) & (L - 1), L);
    const int sb = __shfl_sync(gmask, gb, (i + 1) & (L - 1), L);
    const bool more = ni < nmine;
    const int na = last ? sa : e + kBatch;
    const int nb = last ? sb : e1;
    int cn = 0;
    float wn = 0.f;
    if (more && jl < kBatch && na + static_cast<int>(jl) < nb) {
      cn = __ldg(col + na + jl);
      wn = __ldg(val + na + jl);
    }
    const int n = min(kBatch, e1 - e);
    Vec<W> x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const unsigned cj = static_cast<unsigned>(__shfl_sync(gmask, c, j, L));
      x[j] = live && j < n ? Vec<W>::load(X + cj * K + k) : Vec<W>::zero();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float wj = __shfl_sync(gmask, w, j, L);
      if (j < n) acc.fma(wj, x[j]);
    }
    if (last) {
      if (live)
        acc.store(out + (g + nG * static_cast<unsigned>(i)) * K + k);
      acc = Vec<W>::zero();
    }
    if (!more) break;
    i = ni;
    e = na;
    e1 = nb;
    c = cn;
    w = wn;
  }
}

// K14's second pass: each split row's partial rows [c0, c1) (K elements
// each), added in piece order into its row of Y.  blockIdx.x: the split
// row.
__global__ void __launch_bounds__(128)
    pmm_spmm_combine_kernel(const float* __restrict__ part,
                            const int32_t* __restrict__ combine,
                            float* __restrict__ Y, unsigned K) {
  const int c0 = __ldg(combine + 3 * blockIdx.x);
  const int c1 = __ldg(combine + 3 * blockIdx.x + 1);
  const unsigned out =
      static_cast<unsigned>(__ldg(combine + 3 * blockIdx.x + 2));
  for (unsigned k = threadIdx.x; k < K; k += blockDim.x) {
    float s = part[static_cast<unsigned>(c0) * K + k];
    for (int c = c0 + 1; c < c1; ++c)
      s = s + part[static_cast<unsigned>(c) * K + k];
    Y[out * K + k] = s;
  }
}

}  // namespace

extern "C" {

int cvr_pmm_spmm(const void* col, const void* val, const void* segptr,
                 const void* units, const void* X, void* Y, void* part,
                 int nunits, int K, int vec, void* stream) {
  const int W = vec ? 4 : 1;
  dim3 grid(static_cast<unsigned int>((nunits + kWarps - 1) / kWarps),
            static_cast<unsigned int>((K + kGroup * W - 1) / (kGroup * W)));
  auto kernel = vec ? pmm_spmm_kernel<4> : pmm_spmm_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col), static_cast<const float*>(val),
      static_cast<const int32_t*>(segptr),
      static_cast<const int32_t*>(units), static_cast<const float*>(X),
      static_cast<float*>(Y), static_cast<float*>(part),
      static_cast<unsigned>(nunits), static_cast<unsigned>(K));
  return static_cast<int>(cudaGetLastError());
}

int cvr_pmm_spmm_combine(const void* part, const void* combine, void* Y,
                         int ncombine, int K, void* stream) {
  pmm_spmm_combine_kernel<<<static_cast<unsigned int>(ncombine), 128, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(combine),
      static_cast<float*>(Y), static_cast<unsigned>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
