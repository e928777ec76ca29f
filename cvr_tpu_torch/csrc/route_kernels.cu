// Hopper (sm_90a) kernels of the routed-gather SpMV.
//
// Seven passes replace the twelve Pallas TPU kernels that the JAX package
// runs on this path (cvr_tpu/ops/pallas_route.py):
//
//   K1 expand         <- _expand_kernel                (:343)
//   K15 expand_ring   <- _expand_kernel over a tile-block range, one ring
//                        step of the row-sharded path's overlapped expand
//                        (_expand_ring_call, :477): K1's kernel, launched
//                        over the step's blocks
//   K2 route_middle   <- _m1_fused_kernel + _chunksel_kernel (:1203, :1094)
//   K3 reduce_slices  <- _reduce_m3_kernel + _reduce_m3_regular_kernel
//                        with _emission_sweep          (:641, :752, :86)
//   K4 route_small    <- _sr1_kernel + _sr2_kernel     (:1278, :1298)
//   K5 tileperm       <- _tileperm_kernel              (:205)
//   K6 route_m3       <- _m3_fused_kernel              (:1210)
//   K7 reduce_hot     <- _reduce_hot_kernel + _reduce_hot_regular_kernel
//                        with _hot_gather_groups, _emission_sweep
//                                                      (:942, :1022, :899, :86)
//
// K5, K2, K6, K5 in that order are the y-route above 1024 tiles (outputs
// above 1,048,576 rows); K4 is the y-route up to 1024 tiles.  K7 runs only
// when the pack captured hub columns (the hub-column hybrid).
//
// Layouts (all row-major, C contiguous):
//   stream   (8, T, 128): element (tile a, pos p) at [p>>7, a, p&127]
//   mstream  (8, TM, 128), TM = Tk*1024: element (tile ca*1024+p,
//            color q) at [p>>7, ca*1024+q, p&127]
// Index planes are int16 in [0, 1024); scalar tables are int32.
//
// What bounds them: every pass is an index-driven gather.  Per output
// element a pass reads ~2 B of int16 index (K3 and K4 chase two or three
// of them) and 4 B of f32 data, and writes 4 B, so all seven are bound by
// device-memory bytes and by the latency of the dependent loads, not by
// arithmetic.  The design answer, for this first version: one thread per
// output element (K3: one thread per lane of a slice), so that the index
// planes and the outputs are read and written fully coalesced (neighbour
// threads, neighbour lanes) and only the data gathers are scattered; the
// int16 planes are read as they are, never widened in memory; the TPU's
// staging through VMEM (x segment tables, mstream blocks, relayouts) is
// dropped, because the L2 (50 MB) holds x and the gathered chunks.  Shared
// memory staging, wider loads and TMA are later work.
//
// Each entry point is a plain C function that launches on the stream it is
// given and returns cudaGetLastError(); the Python wrapper raises if that
// is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// K1 and K15: windowed x gather with route stage 1 fused (the expand
// plane li already carries the stage-1 permutation), over the n tiles
// [off_t, off_t + n) of the stream.  For local tile t (stream tile
// off_t + t):
//   g1[i, off_t+t, l] = hi < gcls[t>>3]
//       ? x[128*((k_lo + seg[t/TB])*segw8 + w8[t] + hi) + lo] : 0
// with idx = li[i, off_t+t, l], hi = idx>>7, lo = idx&127; w8, gcls and
// seg are indexed by local tile.  The TPU reads x through a per-segment
// VMEM table with an 8-row halo; here x is read in place, and the zero
// padding of that table becomes a bounds check against xlen.
//   K1 (one SpMV's expand): off_t 0, n T, k_lo 0, x the whole x, xlen
//     ncols.
//   K15 (one ring step of the row-sharded path's overlapped expand,
//     _expand_ring_call :477): the step's tile blocks [off, off + cnt)
//     with the step's slices of w8, gcls and seg_ring, x the shard's
//     gathered-x buffer xg (xg_rows x 128, holding only the ring pieces
//     that have arrived so far; xlen xg_rows*128) and k_lo the step's
//     table base.  The TPU copies the step's table (the nsegtab slices
//     xg[(k_lo+c)*segw8 : +segw8+8] concatenated) into VMEM and writes a
//     (8, cnt*TB, 128) block the caller concatenates; table row
//     c*(segw8+8)+r is xg row (k_lo+c)*segw8+r, so here xg is read in
//     place and the step writes straight into its columns of the shard's
//     g1.
__global__ void expand_kernel(const int16_t* __restrict__ li,
                              const int32_t* __restrict__ w8,
                              const int32_t* __restrict__ gcls,
                              const int32_t* __restrict__ seg,
                              const float* __restrict__ x,
                              float* __restrict__ g1, long long T,
                              long long off_t, long long n, long long k_lo,
                              long long segw8, long long xlen, int tb) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 8LL * n * 128) return;
  long long i = (e >> 7) / n;
  long long t = (e >> 7) - i * n;
  long long ge = (i * T + off_t + t) * 128 + (e & 127);
  int idx = li[ge];
  int hi = idx >> 7;
  float v = 0.f;
  if (hi < gcls[t >> 3]) {
    long long col =
        128LL * ((k_lo + seg[t / tb]) * segw8 + w8[t] + hi) + (idx & 127);
    if (col < xlen) v = __ldg(x + col);
  }
  g1[ge] = v;
}

// K2: the recursive route middle's first two stages in one pass: the
// stream->mstream relayout with the within-chunk permutation m1 (M1), then
// the chunk select csel (M2).
//   mid[i, cd*1024+Q, l] = g1[Q>>7, ca*1024 + m1[i, ca*1024+Q, l], Q&127]
// with ca = csel[i, cd*1024+Q, l].  The TPU block spans all Tk chunks in
// VMEM (capping Tk); here each thread reads its one source, so Tk is free.
__global__ void route_middle_kernel(const float* __restrict__ g1,
                                    const int16_t* __restrict__ m1,
                                    const int16_t* __restrict__ csel,
                                    float* __restrict__ out, long long T,
                                    int tk) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 8LL * T * 128) return;
  long long i = e / (T * 128);
  long long R = (e >> 7) % T;
  int l = static_cast<int>(e & 127);
  int Q = static_cast<int>(R & 1023);
  int ca = csel[e];
  float v = 0.f;
  if (ca >= 0 && ca < tk) {
    long long src = static_cast<long long>(ca) * 1024 + Q;
    int m = m1[(i * T + src) * 128 + l];
    v = g1[((Q >> 7) * T + static_cast<long long>(ca) * 1024 + m) * 128 +
           (Q & 127)];
  }
  out[e] = v;
}

// K3: route stage M3 + the mstream->stream relayout + stage 3 + the value
// multiply + per-slice lane sums, for one slice per block row.  For global
// plane row R: c = R>>7, fL = R&127, base = (c>>3)*1024, idx = p3[i,R,l],
// hi = fast ? i : idx>>7, q = (hi<<7) | (idx&127),
// i3 = m3[c&7, base+q, fL], and
//   P[i,R,l] = vals[i,R,l] * m[i3>>7, base+q, i3&127].
// Slice `it` sums P over plane rows [row0[it], row1[it]) into
// ys[i, out[it], l].  The TPU walks the rows in one sequential grid with
// an emission sweep; here the host derives each slice's row range once
// (from emit, the reduce groups and the regular regions), and one thread
// per (slice, sublane, lane) loops over its rows.
__global__ void reduce_slices_kernel(
    const float* __restrict__ m, const int16_t* __restrict__ m3,
    const float* __restrict__ vals, const int16_t* __restrict__ p3,
    const int32_t* __restrict__ row0, const int32_t* __restrict__ row1,
    const int32_t* __restrict__ out, const int32_t* __restrict__ fast,
    float* __restrict__ ys, long long TM, long long S, long long nys) {
  int it = blockIdx.x;
  long long i = blockIdx.y;
  int l = threadIdx.x;
  int fst = fast[it];
  float acc = 0.f;
  for (long long R = row0[it]; R < row1[it]; ++R) {
    long long c = R >> 7;
    long long fL = R & 127;
    long long base = (c >> 3) << 10;
    long long pe = (i * S + R) * 128 + l;
    int idx = p3[pe];
    long long hi = fst ? i : (idx >> 7);
    long long q = base + ((hi << 7) | (idx & 127));
    int i3 = m3[((c & 7) * TM + q) * 128 + fL];
    acc += vals[pe] * m[((i3 >> 7) * TM + q) * 128 + (i3 & 127)];
  }
  ys[(i * nys + out[it]) * 128 + l] = acc;
}

// K4: a whole 1024-tile route (the y-route when the output fits one),
// stage 1 + middle + stage 3 and the flatten, in one pass:
//   y[D*1024 + i*128 + l] = ysp[s1v>>7, a, s1v&127]
// with s3v = s3[i,D,l], a = mid[D>>7, s3v, D&127],
// s1v = s1[s3v>>7, a, s3v&127].
__global__ void route_small_kernel(const float* __restrict__ ysp,
                                   const int16_t* __restrict__ s1,
                                   const int16_t* __restrict__ mid,
                                   const int16_t* __restrict__ s3,
                                   float* __restrict__ y, long long n) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  long long D = e >> 10;
  long long i = (e >> 7) & 7;
  long long l = e & 127;
  long long s3v = s3[(i * 1024 + D) * 128 + l];
  long long a = mid[((D >> 7) * 1024 + s3v) * 128 + (D & 127)];
  long long s1v = s1[((s3v >> 7) * 1024 + a) * 128 + (s3v & 127)];
  y[e] = ysp[((s1v >> 7) * 1024 + a) * 128 + (s1v & 127)];
}

// K5: a within-tile permutation in stream layout (route stages 1 and 3
// of a y-route above 1024 tiles):
//   out[i,a,l] = data[v>>7, a, v&127],  v = idx[i,a,l]
// and 0 where v is not in [0, 1024) (the TPU's 8-way select matches no
// sublane there).  The TPU pads T to its block; here any T runs.
__global__ void tileperm_kernel(const float* __restrict__ data,
                                const int16_t* __restrict__ idx,
                                float* __restrict__ out, long long T) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 8LL * T * 128) return;
  long long a = (e >> 7) % T;
  int v = idx[e];
  out[e] = (v >= 0 && v < 1024)
               ? data[((v >> 7) * T + a) * 128 + (v & 127)]
               : 0.f;
}

// K6: the recursive route middle's M3 stage plus the mstream->stream
// relayout, as the composition mstream_to_stream(gather_slabs(m, m3)):
//   g[fH, r, fL]               = m[v>>7, r, v&127],  v = m3[fH, r, fL]
//   out[qh, cd*1024+f, ql]     = g[fH, cd*1024+q, fL]
// with q = qh*128+ql, f = fH*128+fL.  For fixed (cd, qh, fH) that is a
// 128x128 transpose of g over (ql, fL); a block moves one 32x32 tile of it
// through shared memory, so m3 is read and out written coalesced (the TPU
// does the same transpose in VMEM, per chunk quarter).
constexpr int kTile = 32;
constexpr int kRows = 8;

__global__ void route_m3_kernel(const float* __restrict__ m,
                                const int16_t* __restrict__ m3,
                                float* __restrict__ out, long long T) {
  __shared__ float tile[kTile][kTile + 1];
  // blockIdx.x: 16 tiles of the 128x128 slab; blockIdx.y: (cd, qh, fH)
  int tq = (blockIdx.x >> 2) * kTile;  // ql tile base
  int tf = (blockIdx.x & 3) * kTile;   // fL tile base
  long long slab = blockIdx.y;
  int fH = static_cast<int>(slab & 7);
  int qh = static_cast<int>((slab >> 3) & 7);
  long long cd = slab >> 6;
  long long rbase = cd * 1024 + qh * 128;  // mstream row of ql = 0
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    long long r = rbase + tq + j;
    int fL = tf + threadIdx.x;
    int v = m3[(fH * T + r) * 128 + fL];
    tile[j][threadIdx.x] =
        (v >= 0 && v < 1024) ? m[((v >> 7) * T + r) * 128 + (v & 127)] : 0.f;
  }
  __syncthreads();
  long long dbase = cd * 1024 + fH * 128;  // stream tile of fL = 0
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    int fL = tf + j;
    int ql = tq + threadIdx.x;
    out[(qh * T + dbase + fL) * 128 + ql] = tile[threadIdx.x][j];
  }
}

// K7: the hub-column hybrid's per-slice sums.  For plane row R of slice
// `it`: P[i,R,l] = xh[hidx[i,R,l]] * hvals[i,R,l] (0 past the table), summed
// over rows [row0[it], row1[it]) into ys[i, out[it], l].  The TPU gathers
// from an (8,128) VMEM hot table by 1/2/4/8 candidate windows per 8-row
// group (the gather classes) and walks rows with the emission sweep, or
// sums fixed width-w runs in regular regions; here the host derives each
// slice's row range once (reduce_table over the hot planes' emissions,
// reduce groups and regions), the table (at most 4 KB) is read in place
// from L1/L2 by direct index, and one thread per (slice, sublane, lane)
// loops over its rows, as K3 does.
__global__ void reduce_hot_kernel(
    const float* __restrict__ xh, const int16_t* __restrict__ hidx,
    const float* __restrict__ hvals, const int32_t* __restrict__ row0,
    const int32_t* __restrict__ row1, const int32_t* __restrict__ out,
    float* __restrict__ ys, long long nxh, long long S, long long nys) {
  int it = blockIdx.x;
  long long i = blockIdx.y;
  int l = threadIdx.x;
  float acc = 0.f;
  for (long long R = row0[it]; R < row1[it]; ++R) {
    long long pe = (i * S + R) * 128 + l;
    int v = hidx[pe];
    float xv = (v >= 0 && v < nxh) ? __ldg(xh + v) : 0.f;
    acc += xv * hvals[pe];
  }
  ys[(i * nys + out[it]) * 128 + l] = acc;
}

}  // namespace

extern "C" {

int cvr_expand(const void* li, const void* w8, const void* gcls,
               const void* seg, const void* x, void* g1, long long T,
               long long off_t, long long n, long long k_lo, long long segw8,
               long long xlen, int tb, void* stream) {
  expand_kernel<<<blocks_for(8LL * n * 128), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(li), static_cast<const int32_t*>(w8),
      static_cast<const int32_t*>(gcls), static_cast<const int32_t*>(seg),
      static_cast<const float*>(x), static_cast<float*>(g1), T, off_t, n,
      k_lo, segw8, xlen, tb);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_middle(const void* g1, const void* m1, const void* csel,
                     void* out, long long T, int tk, void* stream) {
  route_middle_kernel<<<blocks_for(8LL * T * 128), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g1), static_cast<const int16_t*>(m1),
      static_cast<const int16_t*>(csel), static_cast<float*>(out), T, tk);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_slices(const void* m, const void* m3, const void* vals,
                      const void* p3, const void* row0, const void* row1,
                      const void* out, const void* fast, void* ys,
                      long long nitems, long long TM, long long S,
                      long long nys, void* stream) {
  dim3 grid(static_cast<unsigned int>(nitems), 8);
  reduce_slices_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const int16_t*>(m3),
      static_cast<const float*>(vals), static_cast<const int16_t*>(p3),
      static_cast<const int32_t*>(row0), static_cast<const int32_t*>(row1),
      static_cast<const int32_t*>(out), static_cast<const int32_t*>(fast),
      static_cast<float*>(ys), TM, S, nys);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_small(const void* ysp, const void* s1, const void* mid,
                    const void* s3, void* y, long long n, void* stream) {
  route_small_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ysp), static_cast<const int16_t*>(s1),
      static_cast<const int16_t*>(mid), static_cast<const int16_t*>(s3),
      static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

int cvr_tileperm(const void* data, const void* idx, void* out, long long T,
                 void* stream) {
  tileperm_kernel<<<blocks_for(8LL * T * 128), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int16_t*>(idx),
      static_cast<float*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_m3(const void* m, const void* m3, void* out, long long T,
                 void* stream) {
  // (128/32)^2 tiles per slab; Tk chunks x 8 qh x 8 fH slabs
  dim3 grid(16, static_cast<unsigned int>((T / 1024) * 64));
  dim3 block(kTile, kRows);
  route_m3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const int16_t*>(m3),
      static_cast<float*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_hot(const void* xh, const void* hidx, const void* hvals,
                   const void* row0, const void* row1, const void* out,
                   void* ys, long long nitems, long long nxh, long long S,
                   long long nys, void* stream) {
  dim3 grid(static_cast<unsigned int>(nitems), 8);
  reduce_hot_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const int16_t*>(hidx),
      static_cast<const float*>(hvals), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(row1), static_cast<const int32_t*>(out),
      static_cast<float*>(ys), nxh, S, nys);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
