// Hopper (sm_90a) kernels of the routed-gather SpMV and of the route
// library's device API.
//
// Eleven passes, in eight kernels (K3's with a second pass), replace the
// fifteen Pallas TPU kernels that the JAX package runs on these paths
// (cvr_tpu/ops/pallas_route.py):
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
//   K16 route_flat    <- _flat_fused_kernel            (:1217): K6's kernel
//                        on the stream, route_m3_kernel<true>
//   K17 groupperm     <- _groupperm_kernel             (:267): K5's kernel
//                        on the middle layout, tileperm_kernel<true>
//   K18 reduce_stream <- _reduce_kernel with _emission_sweep (:537, :86)
//
// K5, K2, K6, K5 in that order are the y-route above 1024 tiles (outputs
// above 1,048,576 rows); K4 is the y-route up to 1024 tiles.  K7 runs only
// when the pack captured hub columns (the hub-column hybrid).  K16-K18 are
// the route library's own calls (middle_pass, apply_route, the unfused
// reduce_stream of ops/spmv_routed.py): K5, K16, K5 route a flat
// 1024-tile stream in three passes where K4 takes one; K5, K17, K5 route
// any T not a multiple of 1024 tiles (the brute middle).
//
// Layouts (all row-major, C contiguous):
//   stream   (8, T, 128): element (tile a, pos p) at [p>>7, a, p&127]
//   mstream  (8, TM, 128), TM = Tk*1024: element (tile ca*1024+p,
//            color q) at [p>>7, ca*1024+q, p&127]
// Index planes are int16 in [0, 1024); scalar tables are int32.
//
// What bounds them: every pass is an index-driven gather.  Per output
// element a pass reads ~2 B of int16 index and 4 B of f32 data, and
// writes 4 B, so all are bound by device-memory bytes and by the latency
// of the dependent loads, not by arithmetic.  The design answer of the
// first version, kept by K2 and K5-K7: one thread per output element
// (K7: one thread per lane of a slice), so that the index planes and the
// outputs are read and written fully coalesced (neighbour threads,
// neighbour lanes) and only the data gathers are scattered; the int16
// planes are read as they are, never widened in memory; the TPU's staging
// through VMEM (x segment tables, mstream blocks, relayouts) is dropped,
// because the L2 (50 MB) holds x and the gathered chunks.  K1, K3 and K4
// are redesigned for the H100 (see each): K1 stages each tile's x window
// in shared memory and moves 16 B per thread, K3 splits long slices into
// pieces summed side by side and gathers by one int32 index composed at
// upload, K4 gathers by one int32 index composed at upload.
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
//   g1[i, off_t+t, l] = idx < 128*gcls[t>>3]
//       ? x[128*((k_lo + seg[t/TB])*segw8 + w8[t]) + idx] : 0
// with idx = li[i, off_t+t, l] in [0, 1024), and x read as 0 at and past
// xlen; w8, gcls and seg are indexed by local tile.
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
// All 8 planes x 128 lanes of a tile read from one window of gcls <= 8
// rows of x (512 B each) at row (k_lo + seg)*segw8 + w8[t]: the TPU stages
// it in VMEM.  Here one block of 128 threads takes one tile: it reads the
// tile's w8, gcls and seg once, copies the window into shared memory with
// 4 B cp.async (x may be a view at any 4 B offset; a row at or past xlen,
// and the lanes of the last row past it, are zero-filled by the copy) and
// loads its li row while the copy is in flight; then each thread gathers
// 8 lanes of one plane row (one 16 B li load) from shared memory and
// stores 32 B of g1.  Up to 16 such blocks share an SM, so other tiles'
// windows are in flight while one is gathered.  On an H100, at
// web-Google-like's shapes (ab_routed, PERF.md): 0.0164 ms; 0.0190 with
// the li load issued before the copy (it delays the copy), 0.0214 for a
// block walking the 8 tiles of a gather group with the next tile's window
// in flight.  Index arithmetic is 32-bit (the wrapper refuses 8*T*128 or
// xlen above 2^31-1), and no element pays a division: the block index is
// the tile.
constexpr int kExpandThreads = 128;  // 8 planes x 16 threads of 8 lanes

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ float window_at(const float* win, int idx,
                                           unsigned lim) {
  return static_cast<unsigned>(idx) < lim ? win[idx] : 0.f;
}

__global__ void __launch_bounds__(kExpandThreads)
    expand_kernel(const int16_t* __restrict__ li,
                  const int32_t* __restrict__ w8,
                  const int32_t* __restrict__ gcls,
                  const int32_t* __restrict__ seg,
                  const float* __restrict__ x, float* __restrict__ g1,
                  unsigned T, unsigned off_t, unsigned k_lo, unsigned segw8,
                  unsigned xlen, unsigned tb) {
  __shared__ float win[8 * 128];
  const unsigned tid = threadIdx.x;
  const unsigned t = blockIdx.x;  // local tile
  // this thread's lanes: plane tid>>4, lanes 8*(tid&15) .. +7
  const unsigned e = ((tid >> 4) * T + off_t + t) * 128 + (tid & 15) * 8;
  // window rows; idx < 1024 reaches 8 rows at most
  const unsigned gc = static_cast<unsigned>(max(0, min(gcls[t >> 3], 8)));
  const unsigned row0 = (k_lo + seg[t / tb]) * segw8 + w8[t];
  const unsigned xrows = (xlen + 127) / 128;
  for (unsigned r = 0; r < gc; ++r) {  // thread tid copies lane tid
    unsigned row = row0 + r;
    bool ok = row < xrows && row * 128 + tid < xlen;
    cp_async4(win + r * 128 + tid, ok ? x + row * 128 + tid : x, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int4 idx = __ldcs(reinterpret_cast<const int4*>(li + e));
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const unsigned lim = gc * 128;
  // int16 lane j of the 16 B row piece: low half first (little-endian)
  float4 a, b;
  a.x = window_at(win, static_cast<int16_t>(idx.x & 0xffff), lim);
  a.y = window_at(win, idx.x >> 16, lim);
  a.z = window_at(win, static_cast<int16_t>(idx.y & 0xffff), lim);
  a.w = window_at(win, idx.y >> 16, lim);
  b.x = window_at(win, static_cast<int16_t>(idx.z & 0xffff), lim);
  b.y = window_at(win, idx.z >> 16, lim);
  b.z = window_at(win, static_cast<int16_t>(idx.w & 0xffff), lim);
  b.w = window_at(win, idx.w >> 16, lim);
  float4* out = reinterpret_cast<float4*>(g1 + e);
  out[0] = a;
  out[1] = b;
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
// multiply + per-slice lane sums (the TPU's _reduce_m3_kernel :641 and
// _reduce_m3_regular_kernel :752, with _emission_sweep :86).  For plane
// row R of a slice: c = R>>7, fL = R&127, base = (c>>3)*1024,
// idx = p3[i,R,l], hi = fast ? i : idx>>7, q = base + ((hi<<7) | (idx&127)),
// i3 = m3[c&7, q, fL], and
//   P[i,R,l] = vals[i,R,l] * m[i3>>7, q, i3&127].
// Slice k sums P over plane rows [row0[k], row1[k]) into ys[i, out[k], l].
//
// What bounds it: bytes (4 B of value, 4 B of index and one scattered 4 B
// read of m per plane element) and, in the first design (one thread per
// lane walking a whole slice), the latency of the chain p3 -> m3 -> m,
// one row after another: a slice's rows are a serial walk, so the longest slice
// set the kernel's time (128 plane rows on web-Google-like; 1024 on every
// shard of the forced 4-shard pack, ~half of a shard's rows).  The design:
//   * the chain is one streamed int32 index per plane element, composed at
//     upload from p3, the M3 plane and zone A's aligned stage 3 (fast)
//     (reduce_index): m[idx[i,R,l]] is the factor above, so a row costs a
//     16 B index load, a 16 B value load and four independent gathers;
//   * the host cuts every slice into pieces of at most P plane rows
//     (split_rows, made at upload): one block of 256 threads takes one
//     piece, warp i its sublane i, each thread 4 lanes; it keeps
//     kReduceUnroll rows' loads in flight with one accumulator per row of
//     the unroll, added in a fixed order at the end;
//   * a slice of one piece writes its ys row directly; the pieces of a
//     longer slice write partial rows, and a second pass
//     (reduce_slices_combine_kernel) adds them in piece order into ys.
//     No float atomics: the output's bits repeat run to run.
// Index arithmetic is 32-bit: the wrapper refuses planes, m, ys or the
// partials past 2^31 - 1 elements.
constexpr int kReduceThreads = 256;  // 8 sublanes x 32 threads of 4 lanes
constexpr int kReduceUnroll = 4;     // plane rows in flight a thread

__device__ __forceinline__ void fma4(float4& a, const float4& v,
                                     const float4& g) {
  a.x = fmaf(v.x, g.x, a.x);
  a.y = fmaf(v.y, g.y, a.y);
  a.z = fmaf(v.z, g.z, a.z);
  a.w = fmaf(v.w, g.w, a.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 gather4(const float* __restrict__ m,
                                          const int4& ix) {
  return make_float4(__ldg(m + ix.x), __ldg(m + ix.y), __ldg(m + ix.z),
                     __ldg(m + ix.w));
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_slices_kernel(const float* __restrict__ m,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ vals,
                         const int32_t* __restrict__ pieces,
                         float* __restrict__ ys, float* __restrict__ part,
                         unsigned S, unsigned nys, unsigned npart) {
  // piece: plane rows [r0, r1) and its destination: ys slice dst >= 0, or
  // partial row -1 - dst
  const int r0 = __ldg(pieces + 3 * blockIdx.x);
  const int r1 = __ldg(pieces + 3 * blockIdx.x + 1);
  const int dst = __ldg(pieces + 3 * blockIdx.x + 2);
  const unsigned i = threadIdx.x >> 5;
  const unsigned lq = (threadIdx.x & 31) * 4;
  const unsigned base = i * S * 128 + lq;
  float4 acc[kReduceUnroll];
#pragma unroll
  for (int u = 0; u < kReduceUnroll; ++u) acc[u] = make_float4(0, 0, 0, 0);
  int R = r0;
  for (; R + kReduceUnroll <= r1; R += kReduceUnroll) {
    int4 ix[kReduceUnroll];
    float4 v[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) {
      const unsigned e = base + static_cast<unsigned>(R + u) * 128;
      ix[u] = __ldcs(reinterpret_cast<const int4*>(idx + e));
      v[u] = __ldcs(reinterpret_cast<const float4*>(vals + e));
    }
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u)
      fma4(acc[u], v[u], gather4(m, ix[u]));
  }
  for (; R < r1; ++R) {  // the piece's last rows % kReduceUnroll
    const unsigned e = base + static_cast<unsigned>(R) * 128;
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx + e));
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vals + e));
    fma4(acc[0], v, gather4(m, ix));
  }
  const float4 s = add4(add4(acc[0], acc[1]), add4(acc[2], acc[3]));
  float* o = dst >= 0
                 ? ys + (i * nys + static_cast<unsigned>(dst)) * 128 + lq
                 : part + (i * npart + static_cast<unsigned>(-1 - dst)) * 128 +
                       lq;
  *reinterpret_cast<float4*>(o) = s;
}

// K3's second pass: each split slice's partial rows [c0, c1), added in
// piece order, into its ys row out; one block of 256 threads a slice.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_slices_combine_kernel(const float* __restrict__ part,
                                 const int32_t* __restrict__ combine,
                                 float* __restrict__ ys, unsigned nys,
                                 unsigned npart) {
  const int c0 = __ldg(combine + 3 * blockIdx.x);
  const int c1 = __ldg(combine + 3 * blockIdx.x + 1);
  const int out = __ldg(combine + 3 * blockIdx.x + 2);
  const unsigned i = threadIdx.x >> 5;
  const unsigned lq = (threadIdx.x & 31) * 4;
  const float* p = part + i * npart * 128 + lq;
  float4 s = *reinterpret_cast<const float4*>(
      p + static_cast<unsigned>(c0) * 128);
  for (int c = c0 + 1; c < c1; ++c)
    s = add4(s, *reinterpret_cast<const float4*>(
                    p + static_cast<unsigned>(c) * 128));
  *reinterpret_cast<float4*>(
      ys + (i * nys + static_cast<unsigned>(out)) * 128 + lq) = s;
}

// K4: a whole 1024-tile route (the y-route when the output fits one),
// stage 1 + middle + stage 3 and the flatten, in one gather:
//   y[e] = ysp_flat[src[e]]
// where src (int32, one per output) is the composition of the three stage
// planes, made once at upload (route_planes.compose_small_route).  The TPU
// gathers only inside (8, 128) VMEM tiles, so it runs the route as lane
// gathers, selects and transposes (_sr1_kernel, _sr2_kernel); the H100
// gathers from anywhere through its L2, which still holds ysp (4 MB, just
// written).  So each output costs one 4 B index and one 4 B store,
// streamed, and one scattered 4 B read: each thread loads kSmallQuads
// 16 B pieces of src, keeps their 4*kSmallQuads gathers in flight and
// stores 16 B pieces of y; the thread past the last whole piece does the
// n % 4 tail.  Index arithmetic is 32-bit (n <= 2^20).
constexpr int kSmallQuads = 2;

__global__ void route_small_kernel(const float* __restrict__ ysp,
                                   const int32_t* __restrict__ src,
                                   float* __restrict__ y, unsigned n) {
  const unsigned nq = n >> 2;
  const unsigned q0 = blockIdx.x * (kThreads * kSmallQuads) + threadIdx.x;
  int4 s[kSmallQuads];
#pragma unroll
  for (int u = 0; u < kSmallQuads; ++u) {
    unsigned q = q0 + u * kThreads;
    if (q < nq) s[u] = __ldcs(reinterpret_cast<const int4*>(src) + q);
  }
  float4 v[kSmallQuads];
#pragma unroll
  for (int u = 0; u < kSmallQuads; ++u) {
    if (q0 + u * kThreads < nq)
      v[u] = make_float4(__ldg(ysp + s[u].x), __ldg(ysp + s[u].y),
                         __ldg(ysp + s[u].z), __ldg(ysp + s[u].w));
  }
#pragma unroll
  for (int u = 0; u < kSmallQuads; ++u) {
    unsigned q = q0 + u * kThreads;
    if (q < nq) {
      reinterpret_cast<float4*>(y)[q] = v[u];
    } else if (q == nq) {
      for (unsigned e = nq * 4; e < n; ++e) y[e] = __ldg(ysp + src[e]);
    }
  }
}

// K5 and K17: a within-tile permutation over P planes of T rows,
//   out[i,a,l] = data[v>>7, a, v&127],  v = idx[i,a,l]
// and 0 where v is not in [0, P*128) (the TPU's select matches no sublane
// there).  K5 (kMiddle false): route stages 1 and 3 of a y-route above
// 1024 tiles, in stream layout (P 8, any T; the TPU pads T to its block).
// K17 (kMiddle true): the brute route middle over T' = K*128 tiles, in the
// middle layout (P K <= 256, since idx is int16; T 1024, a compile-time
// row count).  The TPU selects among K static slabs after K lane-gathers
// per output row (K*K gather-and-select pairs, because dynamic slab reads
// were ~9x slower there); here one thread per output element reads its one
// source directly, so the cost is one scattered 4 B read per element
// whatever K is.  idx is read and out written coalesced.
template <bool kMiddle>
__global__ void tileperm_kernel(const float* __restrict__ data,
                                const int16_t* __restrict__ idx,
                                float* __restrict__ out, long long T,
                                long long P) {
  const long long rows = kMiddle ? 1024 : T;
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P * rows * 128) return;
  long long a = (e >> 7) % rows;
  int v = idx[e];
  out[e] = (v >= 0 && v < P * 128)
               ? data[((v >> 7) * rows + a) * 128 + (v & 127)]
               : 0.f;
}

// K6 and K16: the route middle's last within-slab gather plus the
// mstream->stream relayout.  K6 (kFlat false), the recursive middle's M3
// stage, is the composition mstream_to_stream(gather_slabs(m, m3)):
//   g[fH, r, fL]               = m[v>>7, r, v&127],  v = m3[fH, r, fL]
//   out[qh, cd*1024+f, ql]     = g[fH, cd*1024+q, fL]
// with q = qh*128+ql, f = fH*128+fL.  K16 (kFlat true), the flat middle
// (T == 1024), takes the stream g1 in place of the mstream m:
// mstream_to_stream(tileperm(stream_to_mstream(g1, 1), mid)), whose load
// m[v>>7, q, v&127] is g1[qh, v, ql] through the stream->mstream index map,
// so no mstream is materialised and no relayout copy is made.  For fixed
// (cd, qh, fH) that is a 128x128 transpose of g over (ql, fL); a block
// moves one 32x32 tile of it through shared memory, so m3 is read and out
// written coalesced (the TPU does the same transpose in VMEM, per chunk
// quarter, and for the flat middle transposes a stream quarter, gathers
// within slabs and transposes back).
constexpr int kTile = 32;
constexpr int kRows = 8;

template <bool kFlat>
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
    long long src = kFlat ? (qh * 1024LL + v) * 128 + tq + j
                          : ((v >> 7) * T + r) * 128 + (v & 127);
    tile[j][threadIdx.x] = (v >= 0 && v < 1024) ? m[src] : 0.f;
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
// loops over its rows.
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

// K18: the unfused reduce (the JAX package's reduce_slices) over one reduce
// group's plane rows, from the stream-layout middle output gx: for plane
// row R of the slice that emission row r closes (rows [start[r], r]),
//   P[i,R,l] = gx[v>>7, R, v&127] * vals[i,R,l],  v = p3[i,R,l]
// (0 where v is not in [0, 1024)), summed into ys[i, emit[r], l].  The
// planes are the group's rows of larger planes, read in place: sv, sg and
// sp are the row counts between two planes of vals, gx and p3.  The TPU
// walks the rows in one sequential grid with the emission sweep; here the
// wrapper derives every row's slice start on the device (a running max of
// the emission rows, no host sync), one block per (plane row, sublane)
// returns at once unless its row is an emission with an id below nys, and
// its threads (one per lane) loop over the slice's rows, reading gx in
// place where K3 reads the mstream through M3.
__global__ void reduce_stream_kernel(
    const float* __restrict__ vals, const float* __restrict__ gx,
    const int16_t* __restrict__ p3, const int32_t* __restrict__ emit,
    const int32_t* __restrict__ start, float* __restrict__ ys, long long sv,
    long long sg, long long sp, long long nys) {
  long long r = blockIdx.x;
  int slice = emit[r];
  if (slice < 0 || slice >= nys) return;
  long long i = blockIdx.y;
  int l = threadIdx.x;
  float acc = 0.f;
  for (long long R = start[r]; R <= r; ++R) {
    int v = p3[(i * sp + R) * 128 + l];
    if (v >= 0 && v < 1024)
      acc += gx[((v >> 7) * sg + R) * 128 + (v & 127)] *
             vals[(i * sv + R) * 128 + l];
  }
  ys[(i * nys + slice) * 128 + l] = acc;
}

}  // namespace

extern "C" {

int cvr_expand(const void* li, const void* w8, const void* gcls,
               const void* seg, const void* x, void* g1, int T, int off_t,
               int n, int k_lo, int segw8, int xlen, int tb, void* stream) {
  // one block per tile of the n tiles
  expand_kernel<<<static_cast<unsigned int>(n), kExpandThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(li), static_cast<const int32_t*>(w8),
      static_cast<const int32_t*>(gcls), static_cast<const int32_t*>(seg),
      static_cast<const float*>(x), static_cast<float*>(g1), T, off_t, k_lo,
      segw8, xlen, tb);
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

int cvr_reduce_slices(const void* m, const void* idx, const void* vals,
                      const void* pieces, void* ys, void* part, int npieces,
                      int S, int nys, int npart, void* stream) {
  // one block per piece
  reduce_slices_kernel<<<static_cast<unsigned int>(npieces), kReduceThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), static_cast<const int32_t*>(pieces),
      static_cast<float*>(ys), static_cast<float*>(part), S, nys, npart);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_slices_combine(const void* part, const void* combine, void* ys,
                              int ncombine, int nys, int npart,
                              void* stream) {
  // one block per split slice
  reduce_slices_combine_kernel<<<static_cast<unsigned int>(ncombine),
                                 kReduceThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(combine),
      static_cast<float*>(ys), nys, npart);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_small(const void* ysp, const void* src, void* y, int n,
                    void* stream) {
  // every whole 16 B piece of y, and piece n/4 (the tail) too
  unsigned int blocks = (n / 4 + kThreads * kSmallQuads) /
                        (kThreads * kSmallQuads);
  route_small_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ysp), static_cast<const int32_t*>(src),
      static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

int cvr_tileperm(const void* data, const void* idx, void* out, long long T,
                 long long planes, int middle, void* stream) {
  auto kernel = middle ? tileperm_kernel<true> : tileperm_kernel<false>;
  kernel<<<blocks_for(planes * T * 128), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int16_t*>(idx),
      static_cast<float*>(out), T, planes);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_m3(const void* m, const void* m3, void* out, long long T,
                 int flat, void* stream) {
  // (128/32)^2 tiles per slab; Tk chunks x 8 qh x 8 fH slabs
  dim3 grid(16, static_cast<unsigned int>((T / 1024) * 64));
  dim3 block(kTile, kRows);
  auto kernel = flat ? route_m3_kernel<true> : route_m3_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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

int cvr_reduce_stream(const void* vals, const void* gx, const void* p3,
                      const void* emit, const void* start, void* ys,
                      long long S, long long sv, long long sg, long long sp,
                      long long nys, void* stream) {
  dim3 grid(static_cast<unsigned int>(S), 8);
  reduce_stream_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(gx),
      static_cast<const int16_t*>(p3), static_cast<const int32_t*>(emit),
      static_cast<const int32_t*>(start), static_cast<float*>(ys), sv, sg,
      sp, nys);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
