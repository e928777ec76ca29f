// Hopper (sm_90a) kernels of the routed-gather SpMV and of the route
// library's device API.
//
// Eleven passes (K1-K7, K15-K18), in fourteen kernels (K2's split body
// and K3's and K18's second passes), replace the fifteen Pallas TPU kernels
// that the JAX package runs on these paths (cvr_tpu/ops/pallas_route.py):
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
//   K16 route_flat    <- _flat_fused_kernel            (:1217)
//   K17 groupperm     <- _groupperm_kernel             (:267): K5's kernel
//                        on the middle layout, tileperm_kernel<true>
//   K18 reduce_stream <- _reduce_kernel with _emission_sweep (:537, :86)
//
// Two more passes, in three kernels, replace no TPU kernel: K3w
// (reduce_slices_cols, and its second pass) and K4w (route_small_cols), K3
// and K4 over a tile of up to 8 columns, which the routed SpMM runs where
// the JAX package vmaps the SpMV over the columns.
//
// A routed SpMV runs K3, K7 (only where the pack captured hub columns:
// the hub-column hybrid) and K4; a routed SpMM K3w, K7 a column and K4w a
// tile.  The TPU stages its route because it
// gathers only inside VMEM windows; every stage is a static map, so the
// upload composes them (ops/spmv_routed.py): K3 gathers x by an index
// composed through K1's window map, the x side's route middle (K2's map,
// or the flat kind's relayout), M3 and stage 3, and K4 gathers the y
// stream by an index composed through the whole y-route, of any length.
// K1 writes the expanded stream g1 for the route library and the tools;
// the row-sharded ring's K15 writes it step by step, and its K3 gathers g1
// by the index composed without K1's map.  K2, K5 and
// K6 are the staged route, which the route library runs (middle_pass,
// apply_route of a compiled permutation: K5, K2, K6, K5 over a multiple
// of 1024 tiles), with K16-K18 (the unfused reduce_stream): K5, K16, K5
// route a flat 1024-tile stream in three passes where K4 takes one; K5,
// K17, K5 route any T not a multiple of 1024 tiles (the brute middle).
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
// first version, kept by K6 and K7: one thread per output element (K7:
// one thread per lane of a slice), so that the index planes and the
// outputs are read and written fully coalesced (neighbour threads,
// neighbour lanes) and only the data gathers are scattered; the int16
// planes are read as they are, never widened in memory; the TPU's staging
// through VMEM (x segment tables, mstream blocks, relayouts) is dropped,
// because the L2 (50 MB) holds x and the gathered chunks.  K1-K5, K16 and
// K18 are redesigned for the H100 (see each): K1, K2, K5, K16 and K18 stage
// what a block gathers from (a tile's x window, a strip of g1, a row's P
// plane rows, a piece's rows of gx) in shared memory, so that device
// memory is read once in whole sectors, K3 and K18 split long slices into
// pieces summed side by side (K3 gathering g1 by one int32 index composed
// at upload through the route middle), K4 gathers by one int32 index
// composed at upload through the whole y-route.
//
// Each entry point is a plain C function that launches on the stream it is
// given and returns cudaGetLastError(); the Python wrapper raises if that
// is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// K1 and K15: windowed x gather with route stage 1 fused (the expand
// plane li already carries the stage-1 permutation), over the n tiles
// [off_t, off_t + n) of the stream.  For local tile t (stream tile
// off_t + t):
//   g1[i, off_t+t, l] = idx < 128*gcls[t>>3]
//       ? x[128*((k_lo + seg[t/TB])*segw8 + w8[t]) + idx] : 0
// with idx = li[i, off_t+t, l] in [0, 1024), and x read as 0 at and past
// xlen; w8, gcls and seg are indexed by local tile.
//   K1 (the whole stream's expand, which K3's x plan composes in): off_t
//     0, n T, k_lo 0, x the whole x, xlen ncols.
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

// K2: the recursive route middle's first two stages: the stream->mstream
// relayout with the within-chunk permutation m1 (M1), then the chunk select
// csel (M2).  The route library runs it; the routed SpMV reads its map
// composed into K3's index instead.
//   mid[i, cd*1024+Q, l] = g1[Q>>7, ca*1024 + m1[i, ca*1024+Q, l], Q&127]
// with ca = csel[i, cd*1024+Q, l] (0 where ca is not in [0, Tk)); m1 holds
// a permutation of each chunk's 1,024 rows, read as m & 1023.  The TPU
// block spans all Tk chunks in VMEM (capping Tk).
//
// What bounds it: bytes (4 B of g1, 2 B each of m1 and csel, 4 B of output
// per element), and in the first design (one thread per output, a 64-bit
// divide and modulo each, the chain csel -> m1 -> g1 of two dependent
// scattered loads) the sectors: the g1 read walks one lane down rows 512 B
// apart, 4 B of each 32 B sector, so it only tied torch.take by the
// composed index.  But for fixed (Q>>7, Q&127) every source lies in one
// column g1[qh, :, ql] of T values.  Two bodies, chosen by the geometry
// (route_kernels.route_middle_geometry):
//   * staged (route_middle_kernel), where a strip fits a block's shared
//     memory (T <= 7168: Tk <= 7): one block of 1,024 threads per (qh,
//     strip of kMidStrip lanes), 128 blocks.  It copies the strip's T rows
//     of g1 (32 B each, whole sectors) into shared memory by 4 B cp.async,
//     column j of the strip at gs[j*(T+4) + r] (the pad of 4 puts the 32
//     copies of a warp, 4 rows x 8 lanes, in 32 banks), 8*(T+4)*4 B
//     (dynamic, opted in above 48 KB; 224 KB at Tk 7).  Then thread t
//     takes lane l = t&127 of strip lane j = t>>7 for every (i, cd): its
//     csel and m1 reads (2 B) and its store are coalesced along l (a
//     warp's m1 reads fall in at most Tk rows of m1), the g1 read is a
//     shared-memory gather (random rows: random banks), and kMidBatch
//     outputs are in flight a thread, the first batch's loads issued
//     before the strip's copy is waited for.  g1 is read once, in whole
//     sectors.  On an H100 (ab_routed, PERF.md): 0.035 ms at Tk 6 and
//     0.044-0.047 at Tk 7 with 8 outputs in flight; 0.038 / 0.049 with 4,
//     0.037 / 0.050 with 16 (registers), 0.042 / 0.054 with two batches of
//     4 in turns, 0.039 / 0.055 with strips of 4 lanes (two blocks an SM).
//   * split (route_middle_m1_kernel, route_middle_select_kernel), any Tk,
//     the JAX package's two passes: M1 per chunk, K16's shape of work (one
//     block per (chunk, qh, strip of 8 lanes): the strip's 1,024 rows of
//     the chunk staged as above, 32 KB, 256 threads, kM1Batch outputs in
//     flight a thread), storing m1out (the mstream before the select)
//     coalesced along l; then the chunk select,
//     4 lanes a thread: one 8 B csel read, four 4 B reads of m1out (a
//     warp's fall in at most Tk rows; m1out, just written, is in L2), one
//     16 B store.  It reads and writes 8 B more per element.
// Index arithmetic is 32-bit, and no element pays a division: the wrapper
// refuses 8*T*128 past 2^31 - 1.
constexpr int kMidStrip = 8;       // lanes of a block's strip of g1
constexpr int kMidThreads = 1024;  // kMidStrip x 128 output lanes
constexpr int kMidBatch = 8;       // outputs in flight a thread
constexpr int kMidPad = 4;         // column stride of the staged strip: rows + 4
constexpr int kM1Threads = 256;
constexpr int kM1Batch = 16;       // the split body's M1: outputs in flight

__global__ void __launch_bounds__(kMidThreads)
    route_middle_kernel(const float* __restrict__ g1,
                        const int16_t* __restrict__ m1,
                        const int16_t* __restrict__ csel,
                        float* __restrict__ out, unsigned T, unsigned tk) {
  extern __shared__ float4 mid_smem4[];
  float* gs = reinterpret_cast<float*>(mid_smem4);
  const unsigned ql0 = blockIdx.x * kMidStrip, qh = blockIdx.y;
  const unsigned t = threadIdx.x, ld = T + kMidPad;
  // copy e = r*8 + j: g1[qh, r, ql0 + j] to column j, row r
  for (unsigned e = t; e < T * kMidStrip; e += kMidThreads) {
    const unsigned r = e >> 3, j = e & 7;
    cp_async4(gs + j * ld + r, g1 + (qh * T + r) * 128 + ql0 + j, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const unsigned j = t >> 7, l = t & 127;
  const unsigned Q = qh * 128 + ql0 + j;
  const float* col = gs + j * ld;
  const unsigned n = 8 * tk;  // (i, cd) pairs: k = i*tk + cd
  unsigned e[kMidBatch];
  int ca[kMidBatch], m[kMidBatch];
  // csel, then m1 at the chunk it picks: global loads only
  auto load = [&](unsigned k0) {
#pragma unroll
    for (int u = 0; u < kMidBatch; ++u) {
      const unsigned k = k0 + u;
      const unsigned i = k / tk, cd = k - i * tk;
      e[u] = (i * T + cd * 1024 + Q) * 128 + l;
      ca[u] = k < n ? static_cast<int>(__ldcs(csel + e[u])) : -1;
    }
#pragma unroll
    for (int u = 0; u < kMidBatch; ++u) {
      const unsigned i = (k0 + u) / tk;
      m[u] = static_cast<unsigned>(ca[u]) < tk
                 ? __ldg(m1 + ((i * T + Q) + ca[u] * 1024) * 128 + l)
                 : 0;
    }
  };
  load(0);  // the first batch's loads overlap the strip's copy
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (unsigned k0 = 0; k0 < n; k0 += kMidBatch) {
    if (k0) load(k0);
#pragma unroll
    for (int u = 0; u < kMidBatch; ++u)
      if (k0 + u < n)
        __stcs(out + e[u], static_cast<unsigned>(ca[u]) < tk
                               ? col[ca[u] * 1024 + (m[u] & 1023)]
                               : 0.f);
  }
}

// K2's split body, pass 1 (M1 of one chunk): m1out[i, ca*1024+Q, l] =
// g1[Q>>7, ca*1024 + m1[i, ca*1024+Q, l], Q&127] over the block's chunk
// ca = blockIdx.z, qh and strip.
__global__ void __launch_bounds__(kM1Threads)
    route_middle_m1_kernel(const float* __restrict__ g1,
                           const int16_t* __restrict__ m1,
                           float* __restrict__ m1out, unsigned T) {
  constexpr unsigned ld = 1024 + kMidPad;
  __shared__ float gs[kMidStrip * ld];
  const unsigned ql0 = blockIdx.x * kMidStrip, qh = blockIdx.y;
  const unsigned c0 = blockIdx.z * 1024, t = threadIdx.x;
  for (unsigned e = t; e < 1024 * kMidStrip; e += kM1Threads) {
    const unsigned r = e >> 3, j = e & 7;
    cp_async4(gs + j * ld + r, g1 + (qh * T + c0 + r) * 128 + ql0 + j, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  // 64 output rows (i, j) of 128 lanes: row 2*k + (t>>7), lane t&127
  const unsigned l = t & 127, h = t >> 7;
  for (unsigned k0 = 0; k0 < 32; k0 += kM1Batch) {
    unsigned e[kM1Batch], j[kM1Batch];
    int m[kM1Batch];
#pragma unroll
    for (int u = 0; u < kM1Batch; ++u) {
      const unsigned rr = (k0 + u) * 2 + h, i = rr >> 3;
      j[u] = rr & 7;
      e[u] = (i * T + c0 + qh * 128 + ql0 + j[u]) * 128 + l;
      m[u] = __ldcs(m1 + e[u]);
    }
#pragma unroll
    for (int u = 0; u < kM1Batch; ++u)
      m1out[e[u]] = gs[j[u] * ld + (m[u] & 1023)];
  }
}

// K2's split body, pass 2 (the chunk select): out[i, cd*1024+Q, l] =
// m1out[i, ca*1024+Q, l], ca = csel[i, cd*1024+Q, l], 0 where ca is not a
// chunk; 4 lanes a thread, blockIdx.y the plane i.
__global__ void route_middle_select_kernel(const float* __restrict__ m1out,
                                           const int16_t* __restrict__ csel,
                                           float* __restrict__ out,
                                           unsigned T, unsigned tk) {
  const unsigned i = blockIdx.y;
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;  // 16 B piece
  const unsigned R = q >> 5, l = (q & 31) * 4, Q = R & 1023;
  const unsigned e = (i * T + R) * 128 + l;
  const int2 c = __ldcs(reinterpret_cast<const int2*>(csel + e));
  const int ca[4] = {static_cast<int16_t>(c.x & 0xffff), c.x >> 16,
                     static_cast<int16_t>(c.y & 0xffff), c.y >> 16};
  const unsigned row = (i * T + Q) * 128 + l;  // + ca*1024*128
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = static_cast<unsigned>(ca[k]) < tk
               ? __ldg(m1out + row + ca[k] * (1024 * 128) + k)
               : 0.f;
  __stcs(reinterpret_cast<float4*>(out + e), make_float4(v[0], v[1], v[2], v[3]));
}

// K3: K1's window gather + the x side's route middle + stage M3 + the
// mstream->stream relayout + stage 3 + the value multiply + per-slice lane
// sums (the TPU's _expand_kernel :343, then _reduce_m3_kernel :641 and
// _reduce_m3_regular_kernel :752, with _emission_sweep :86, after
// _m1_fused_kernel :1203 and _chunksel_kernel :1094 have written the
// mstream m).  For plane row R of a slice: c = R>>7, fL = R&127,
// base = (c>>3)*1024, idx = p3[i,R,l], hi = fast ? i : idx>>7,
// q = base + ((hi<<7) | (idx&127)), i3 = m3[c&7, q, fL], and
//   P[i,R,l] = vals[i,R,l] * m[i3>>7, q, i3&127],
// where m[e] = g1[f(e)] is the route middle's map of the stream g1, or 0
// where its chunk select is out of range, and g1[e] = x[col(e)] is K1's
// window map, or 0 where K1's gather class or the end of x gives 0.
// Slice k sums P over plane rows [row0[k], row1[k]) into ys[i, out[k], l].
//
// What bounds it: bytes (4 B of value, 4 B of index and one scattered 4 B
// read of the source per plane element) and, in the first design (one
// thread per lane walking a whole slice), the latency of the chain
// p3 -> m3 -> m, one row after another: a slice's rows are a serial walk,
// so the longest slice set the kernel's time (128 plane rows on
// web-Google-like; 1024 on every shard of the forced 4-shard pack, ~half
// of a shard's rows).  The design:
//   * the chain is one streamed int32 index per plane element, composed at
//     upload from p3, the M3 plane, zone A's aligned stage 3 (fast), the
//     route middle's map f (reduce_plan) and K1's window map col
//     (reduce_plan_x): src[idx[i,R,l]] is the factor above, or 0 where idx
//     is not in [0, srclen), so a row costs a 16 B index load, a 16 B
//     value load and four independent gathers, and neither K1, K2, g1 nor
//     the mstream is needed.  The source is x itself (srclen its length,
//     so an x shorter or longer than the pack's columns reads what K1
//     would have read), or, on the row-sharded ring, whose x arrives in
//     pieces while K15 expands, g1 (srclen 8*T*128; the index composed
//     without col).  Gathering g1 was the first form here: g1 holds one
//     copy of x's element per stored entry (0.26 GB at Graph500 scale
//     21), 5x the 50 MB L2, and a permuted graph's rows read it in random
//     order, so nearly every gather was a 32 B DRAM sector for 4 useful
//     bytes; x (8.4 MB there) stays in L2.  The index and the values are
//     streamed with __ldcs, so that they do not evict x;
//   * the host cuts every slice into pieces of at most P plane rows
//     (split_rows, made at upload): one block of 256 threads takes one
//     piece, warp i its sublane i, each thread 4 lanes; it keeps
//     kReduceUnroll rows' loads in flight (a multiple of 4; 16 = P, a
//     whole piece) and sums into 4 accumulators, row j of the piece into
//     accumulator j % 4 up to the last whole 4 rows and the rest into the
//     first, added as (a0 + a1) + (a2 + a3): the order of the first design
//     (4 rows in flight), whatever kReduceUnroll.  On an H100 at Graph500
//     scale 21's planes (PERF.md, PR 23): by x 0.4704 / 0.4635 / 0.4574
//     ms at 4 / 8 / 16 rows in flight (by g1 1.5133 / 1.4523 / 1.3518);
//     an L2 evict_last hint on the source gathers moved neither by more
//     than 0.001 ms, so there is none;
//   * a slice of one piece writes its ys row directly; the pieces of a
//     longer slice write partial rows, and a second pass
//     (reduce_slices_combine_kernel) adds them in piece order into ys.
//     No float atomics: the output's bits repeat run to run.
// Index arithmetic is 32-bit: the wrapper refuses planes, the source, ys
// or the partials past 2^31 - 1 elements.
constexpr int kReduceThreads = 256;  // 8 sublanes x 32 threads of 4 lanes
constexpr int kReduceUnroll = 16;    // plane rows in flight a thread
static_assert(kReduceUnroll % 4 == 0, "rows in flight: a multiple of 4");

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

// data[i], or 0 for i = -1 (the composed indices' zero source): a
// predicated load, no branch
__device__ __forceinline__ float gather1(const float* __restrict__ data,
                                         int i) {
  return i >= 0 ? __ldg(data + i) : 0.f;
}

__device__ __forceinline__ float4 gather4(const float* __restrict__ data,
                                          const int4& ix) {
  return make_float4(gather1(data, ix.x), gather1(data, ix.y),
                     gather1(data, ix.z), gather1(data, ix.w));
}

// data[i] for i in [0, n), else 0 (-1, or a column at or past x's end)
__device__ __forceinline__ float gather_below(const float* __restrict__ data,
                                              int i, unsigned n) {
  return static_cast<unsigned>(i) < n ? __ldg(data + i) : 0.f;
}

__device__ __forceinline__ float4 gather4_below(
    const float* __restrict__ data, const int4& ix, unsigned n) {
  return make_float4(gather_below(data, ix.x, n), gather_below(data, ix.y, n),
                     gather_below(data, ix.z, n), gather_below(data, ix.w, n));
}

// kRows plane rows from R: their index and value loads all issued before
// the gathers; row R + u into accumulator u % 4
template <int kRows>
__device__ __forceinline__ void reduce_rows(
    float4 (&acc)[4], const float* __restrict__ src, unsigned srclen,
    const int32_t* __restrict__ idx, const float* __restrict__ vals,
    unsigned base, int R) {
  int4 ix[kRows];
  float4 v[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const unsigned e = base + static_cast<unsigned>(R + u) * 128;
    ix[u] = __ldcs(reinterpret_cast<const int4*>(idx + e));
    v[u] = __ldcs(reinterpret_cast<const float4*>(vals + e));
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    fma4(acc[u % 4], v[u], gather4_below(src, ix[u], srclen));
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_slices_kernel(const float* __restrict__ src, unsigned srclen,
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
  float4 acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = make_float4(0, 0, 0, 0);
  int R = r0;
  for (; R + kReduceUnroll <= r1; R += kReduceUnroll)
    reduce_rows<kReduceUnroll>(acc, src, srclen, idx, vals, base, R);
  if constexpr (kReduceUnroll > 4) {
    for (; R + 4 <= r1; R += 4)
      reduce_rows<4>(acc, src, srclen, idx, vals, base, R);
  }
  for (; R < r1; ++R) {  // the piece's last rows % 4
    const unsigned e = base + static_cast<unsigned>(R) * 128;
    const int4 ix = __ldcs(reinterpret_cast<const int4*>(idx + e));
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vals + e));
    fma4(acc[0], v, gather4_below(src, ix, srclen));
  }
  const float4 s = add4(add4(acc[0], acc[1]), add4(acc[2], acc[3]));
  float* o = dst >= 0
                 ? ys + (i * nys + static_cast<unsigned>(dst)) * 128 + lq
                 : part + (i * npart + static_cast<unsigned>(-1 - dst)) * 128 +
                       lq;
  *reinterpret_cast<float4*>(o) = s;
}

// K3's and K18's second pass: each split slice's partial rows [c0, c1),
// added in piece order, into its ys row out; one block of 256 threads a
// slice.  Each kernel has its own entry, so that a trace tells them apart.
__device__ __forceinline__ void combine_partials(
    const float* __restrict__ part, const int32_t* __restrict__ combine,
    float* __restrict__ ys, unsigned nys, unsigned npart) {
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

__global__ void __launch_bounds__(kReduceThreads)
    reduce_slices_combine_kernel(const float* __restrict__ part,
                                 const int32_t* __restrict__ combine,
                                 float* __restrict__ ys, unsigned nys,
                                 unsigned npart) {
  combine_partials(part, combine, ys, nys, npart);
}

// K4: a whole route (the y-route), stage 1 + middle + stage 3 and the
// flatten, in one gather:
//   y[e] = src[e] >= 0 ? ysp_flat[src[e]] : 0
// where src (int32, one per output) is the composition of the stages,
// made once at upload (spmv_routed.compose_route; -1 where a stage gives
// 0).  The TPU gathers only inside (8, 128) VMEM tiles, so it runs a
// 1024-tile route as lane gathers, selects and transposes (_sr1_kernel,
// _sr2_kernel) and a longer one as K5, K2, K6, K5 (_tileperm_kernel :205,
// _m1_fused_kernel :1203 + _chunksel_kernel :1094, _m3_fused_kernel
// :1210, _tileperm_kernel); the H100 gathers from anywhere through its
// L2, which still holds ysp (4 MB a 1024 tiles, just written).  So each
// output costs one 4 B index and one 4 B store, streamed, and one
// scattered 4 B read, at any Tp: each thread loads kSmallQuads 16 B pieces
// of src, keeps their 4*kSmallQuads gathers in flight and stores 16 B
// pieces of y; the thread past the last whole piece does the n % 4 tail.
// Index arithmetic is 32-bit (the wrapper refuses 8*Tp*128 past 2^31 - 1).
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
      v[u] = gather4(ysp, s[u]);
  }
#pragma unroll
  for (int u = 0; u < kSmallQuads; ++u) {
    unsigned q = q0 + u * kThreads;
    if (q < nq) {
      reinterpret_cast<float4*>(y)[q] = v[u];
    } else if (q == nq) {
      for (unsigned e = nq * 4; e < n; ++e) y[e] = gather1(ysp, src[e]);
    }
  }
}

// K3w and K4w: the routed SpMM's K3 and K4 over a tile of kt <= 8 columns
// of X (ncols, K), so that one pass over the planes serves the tile:
//   ys[i, out[k], l, c] = sum over the rows R of slice k of
//                         vals[i,R,l] * X[idx[i,R,l], c0 + c]
//   Y[e, c0 + c]        = src[e] >= 0 ? ysp[src[e], c] : 0
// by the same plan as K3 (the index into x composed at upload, its pieces
// and combine table) and the same index as K4 (the y-route composed), with
// ys and ysp in the (8, rows, 128, kt) layout: a lane's kt columns side by
// side.  No TPU kernel: the JAX package runs the routed SpMM as the SpMV
// vmapped over the columns (cvr_tpu/ops/spmv.py:314 ->
// spmv_routed._jitted_spmm_routed), which on the card was one K3, K4
// chain a column, each streaming the same index and values (0.5 GB at
// Graph500 scale 21) and gathering one 4 B element of x per plane
// element, then a stack of the columns.
//
// What bounds K3w: per plane element a 4 B index and a 4 B value,
// streamed, and one gather of kt floats of a row of X; with X (ncols, 8)
// float32, row-major, a row is 32 B, one L2 sector, the sector that K3's
// 4 B gather of x costs already.  So the tile's bytes are one SpMV's
// stream plus its sectors, where the column loop paid them kt times.  The
// design:
//   * one block a piece and sublane (grid npieces x 8), 128 lanes x tpl
//     threads, tpl = ceil(kt / 4): a thread takes a quad of 4 columns of
//     one lane, and the threads of one lane are neighbours, so that their
//     16 B loads of one row of X fall in one 32 B sector of one warp
//     request.  The index and the value are streamed with __ldcs (the
//     threads of a lane load the same 4 B), so they do not evict X;
//   * kColsRows = 4 plane rows' loads in flight, the rows of the piece
//     summed into 4 accumulators a column, row j into accumulator j % 4 up
//     to the last whole 4 rows and the rest into the first, added as
//     (a0 + a1) + (a2 + a3), with the same fmaf(value, X, acc): K3's
//     order, so column c of ys equals K3's ys of that column bit for bit.
//     Registers: 16 accumulators a thread.  The settings were timed alone
//     on an H100 at graph500_s21's planes, kt 8: 0.742 / 0.802 / 0.794 ms
//     at 4 / 8 / 16 rows in flight with one quad a thread (40 / 58 / 62
//     registers), 0.767 / 0.767 / 0.844 with a lane's two quads in one
//     thread (32 accumulators), against 3.648 ms for K3 launched once a
//     column; the kernel keeps the fastest, one quad and 4 rows;
//   * X read in place with its row stride ldx (a tile of a wider X is a
//     view), by 16 B loads where kt, ldx and the tile's address allow,
//     else by 4 B loads; a column past kt, an index of -1 and a row at or
//     past nx read 0 (predicated loads);
//   * ys stored 16 B a quad (4 B a column where kt is not a multiple of 4);
//     the pieces of a split slice write partial rows, which
//     reduce_slices_cols_combine_kernel adds in piece order: no float
//     atomics, the bits repeat run to run.
// K4w: each output row's kt floats of ysp (one 32 B sector at kt 8) are
// gathered and stored into its row of Y, in place with the row stride ldy,
// by kt / 4 neighbour threads with 16 B each where kt, ldy and the
// addresses of ysp and Y allow (else one thread a row, 4 B at a time), so
// that a warp's loads of a row merge into one sector request and its
// stores cover 512 B of Y side by side.  A first design gave each thread
// 4 outputs (one 16 B load of src, then 4 rows): a warp's stores then
// fell 128 B apart, half a sector each, and on an H100 at graph500_s21's
// y-route, kt 8, it took 0.151 ms against 0.087 ms for K4 once a column.
// Index arithmetic is 32-bit: the wrappers refuse X, ys, the partials,
// ysp or Y past 2^31 - 1 elements.
constexpr int kColsThreads = 256;  // the largest block: 128 lanes x 2
constexpr int kColsRows = 4;  // plane rows in flight: one an accumulator

__device__ __forceinline__ void fma1x4(float4& a, float v, const float4& g) {
  a.x = fmaf(v, g.x, a.x);
  a.y = fmaf(v, g.y, a.y);
  a.z = fmaf(v, g.z, a.z);
  a.w = fmaf(v, g.w, a.w);
}

// X[c, col .. col + 3], 0 where c is not in [0, nx) and past column kt
template <bool kVec>
__device__ __forceinline__ float4 gather_quad(const float* __restrict__ X,
                                              int c, unsigned nx,
                                              unsigned ldx, unsigned col,
                                              unsigned kt) {
  const bool ok = static_cast<unsigned>(c) < nx;
  const float* p = X + (static_cast<unsigned>(c) * ldx + col);
  if constexpr (kVec) {
    return ok && col < kt ? __ldg(reinterpret_cast<const float4*>(p))
                          : make_float4(0, 0, 0, 0);
  } else {
    return make_float4(ok && col < kt ? __ldg(p) : 0.f,
                       ok && col + 1 < kt ? __ldg(p + 1) : 0.f,
                       ok && col + 2 < kt ? __ldg(p + 2) : 0.f,
                       ok && col + 3 < kt ? __ldg(p + 3) : 0.f);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kColsThreads)
    reduce_slices_cols_kernel(const float* __restrict__ X, unsigned nx,
                              unsigned ldx, unsigned kt,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ vals,
                              const int32_t* __restrict__ pieces,
                              float* __restrict__ ys, float* __restrict__ part,
                              unsigned S, unsigned nys, unsigned npart) {
  // piece: plane rows [r0, r1) and its destination, as K3's
  const int r0 = __ldg(pieces + 3 * blockIdx.x);
  const int r1 = __ldg(pieces + 3 * blockIdx.x + 1);
  const int dst = __ldg(pieces + 3 * blockIdx.x + 2);
  const unsigned i = blockIdx.y;
  const unsigned tpl = blockDim.x / 128;  // threads a lane
  const unsigned l = threadIdx.x / tpl;
  const unsigned col = threadIdx.x % tpl * 4;
  const unsigned base = i * S * 128 + l;
  float4 acc[kColsRows];
#pragma unroll
  for (int u = 0; u < kColsRows; ++u) acc[u] = make_float4(0, 0, 0, 0);
  int R = r0;
  for (; R + kColsRows <= r1; R += kColsRows) {
    // the rows' index and value loads all issued before the gathers; row
    // R + u into accumulator u
    int ix[kColsRows];
    float v[kColsRows];
#pragma unroll
    for (int u = 0; u < kColsRows; ++u) {
      const unsigned e = base + static_cast<unsigned>(R + u) * 128;
      ix[u] = __ldcs(idx + e);
      v[u] = __ldcs(vals + e);
    }
#pragma unroll
    for (int u = 0; u < kColsRows; ++u)
      fma1x4(acc[u], v[u], gather_quad<kVec>(X, ix[u], nx, ldx, col, kt));
  }
  for (; R < r1; ++R) {  // the piece's last rows % 4
    const unsigned e = base + static_cast<unsigned>(R) * 128;
    const int c = __ldcs(idx + e);
    const float v = __ldcs(vals + e);
    fma1x4(acc[0], v, gather_quad<kVec>(X, c, nx, ldx, col, kt));
  }
  const unsigned row = dst >= 0 ? i * nys + static_cast<unsigned>(dst)
                                : i * npart + static_cast<unsigned>(-1 - dst);
  float* o = (dst >= 0 ? ys : part) + (row * 128 + l) * kt;
  const float4 s = add4(add4(acc[0], acc[1]), add4(acc[2], acc[3]));
  if constexpr (kVec) {
    if (col < kt) *reinterpret_cast<float4*>(o + col) = s;
  } else {
    if (col < kt) o[col] = s.x;
    if (col + 1 < kt) o[col + 1] = s.y;
    if (col + 2 < kt) o[col + 2] = s.z;
    if (col + 3 < kt) o[col + 3] = s.w;
  }
}

// K3w's second pass: combine_partials over the (8, rows, 128, kt) layout,
// each split slice's partial rows [c0, c1) added in piece order into its
// ys row out; one block of 256 threads a slice, 16 B a thread and step
// where kt is a multiple of 4.
template <bool kVec>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_slices_cols_combine_kernel(const float* __restrict__ part,
                                      const int32_t* __restrict__ combine,
                                      float* __restrict__ ys, unsigned nys,
                                      unsigned npart, unsigned kt) {
  const int c0 = __ldg(combine + 3 * blockIdx.x);
  const int c1 = __ldg(combine + 3 * blockIdx.x + 1);
  const unsigned out = __ldg(combine + 3 * blockIdx.x + 2);
  const unsigned w = 128 * kt;  // floats of one sublane's row
  constexpr unsigned kStep = kVec ? 4 : 1;
  for (unsigned f = threadIdx.x * kStep; f < 8 * w;
       f += kReduceThreads * kStep) {
    const unsigned i = f / w, r = f - i * w;
    const float* p = part + i * npart * w + r;
    float* o = ys + (i * nys + out) * w + r;
    if constexpr (kVec) {
      float4 s = *reinterpret_cast<const float4*>(
          p + static_cast<unsigned>(c0) * w);
      for (int c = c0 + 1; c < c1; ++c)
        s = add4(s, *reinterpret_cast<const float4*>(
                        p + static_cast<unsigned>(c) * w));
      *reinterpret_cast<float4*>(o) = s;
    } else {
      float s = p[static_cast<unsigned>(c0) * w];
      for (int c = c0 + 1; c < c1; ++c) s = s + p[static_cast<unsigned>(c) * w];
      *o = s;
    }
  }
}

// K4w: kQ threads an output row, each 16 B of it (kt = 4 * kQ), or, for
// kQ 0, one thread a row moving it 4 B at a time; kColsRowsK4 rows a
// thread, a block's step apart, their loads all issued before the stores
constexpr int kColsRowsK4 = 4;

template <int kQ>
__global__ void __launch_bounds__(kThreads)
    route_small_cols_kernel(const float* __restrict__ ysp,
                            const int32_t* __restrict__ src,
                            float* __restrict__ y, unsigned n, unsigned kt,
                            unsigned ldy) {
  constexpr unsigned kTpr = kQ > 0 ? kQ : 1;  // threads a row
  constexpr unsigned kStep = kThreads / kTpr;  // rows a block's step
  const unsigned q = threadIdx.x % kTpr;
  const unsigned e0 = blockIdx.x * (kStep * kColsRowsK4) + threadIdx.x / kTpr;
  int s[kColsRowsK4];
#pragma unroll
  for (int j = 0; j < kColsRowsK4; ++j) {
    const unsigned e = e0 + j * kStep;
    s[j] = e < n ? __ldcs(src + e) : -1;
  }
  if constexpr (kQ > 0) {
    float4 v[kColsRowsK4];
#pragma unroll
    for (int j = 0; j < kColsRowsK4; ++j)
      v[j] = s[j] >= 0 ? __ldg(reinterpret_cast<const float4*>(
                             ysp + static_cast<unsigned>(s[j]) * kt) + q)
                       : make_float4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kColsRowsK4; ++j) {
      const unsigned e = e0 + j * kStep;
      if (e < n) reinterpret_cast<float4*>(y + e * ldy)[q] = v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kColsRowsK4; ++j) {
      const unsigned e = e0 + j * kStep;
      if (e >= n) continue;
      for (unsigned c = 0; c < kt; ++c)
        y[e * ldy + c] =
            s[j] >= 0 ? __ldg(ysp + static_cast<unsigned>(s[j]) * kt + c) : 0.f;
    }
  }
}

// K5 and K17: a within-tile permutation over P planes of R rows,
//   out[i,a,l] = data[v>>7, a, v&127],  v = idx[i,a,l]
// and 0 where v is not in [0, P*128) (the TPU's select matches no sublane
// there).  K5 (kMiddle false): route stages 1 and 3 of a y-route above
// 1024 tiles, in stream layout (P 8, a compile-time count; R = T, any T;
// the TPU pads T to its block).  K17 (kMiddle true): the brute route
// middle over T' = K*128 tiles, in the middle layout (P K <= 256, since idx
// is int16; R 1024).  The TPU selects among K static slabs after K
// lane-gathers per output row (K*K gather-and-select pairs, because
// dynamic slab reads were ~9x slower there).
//
// What bounds it: bytes (4 B of data, 2 B of index and 4 B of output per
// element), and in the first design (one thread per output element, one
// scattered 4 B gather each) the sectors: every 4 B gather fetched a 32 B
// sector, with a 64-bit (e >> 7) % rows per element and one 2 B index load
// in flight a thread; torch.gather beat it by 1.4x at T 1024.  But row a's
// sources are only the P rows data[0..P-1, a, :] of 512 B (4 KB for K5, 24
// KB for K17 at K 48).  So one block takes one row a: it copies those rows
// and the row's index (P rows of 256 B) into shared memory by 16 B
// cp.async, all in flight at once, then each thread takes 8 lanes of a
// plane row (one 16 B index read from shared memory), gathers them from
// the staged rows and stores 32 B.  Device memory is read once, in whole
// sectors, and written once; no gather leaves the SM.  Shared memory is
// P*768 B a block (dynamic; above 48 KB, K > 64, opted in by the launcher),
// 192 KB at K 256.  Index arithmetic is 32-bit: the wrapper refuses
// P*R*128 past 2^31 - 1 (tileperm_geometry); no element pays a division,
// the block index is the row.
constexpr int kPermThreads = 128;   // K5: 8 planes x 16 threads of 8 lanes
constexpr int kGroupThreads = 256;  // K17: K*16 pieces of 8 lanes, in turns

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <bool kMiddle>
__global__ void __launch_bounds__(kMiddle ? kGroupThreads : kPermThreads)
    tileperm_kernel(const float* __restrict__ data,
                    const int16_t* __restrict__ idx,
                    float* __restrict__ out, unsigned R, unsigned P) {
  constexpr unsigned kN = kMiddle ? kGroupThreads : kPermThreads;
  extern __shared__ float4 smem4[];
  const unsigned planes = kMiddle ? P : 8;
  float* win = reinterpret_cast<float*>(smem4);  // data[p, a, l] at p*128+l
  int16_t* six = reinterpret_cast<int16_t*>(win + planes * 128);
  const unsigned a = blockIdx.x;
  // 16 B pieces: 32 a plane row of data, 16 of idx
  for (unsigned j = threadIdx.x; j < planes * 32; j += kN)
    cp_async16(win + j * 4, data + ((j >> 5) * R + a) * 128 + (j & 31) * 4);
  for (unsigned j = threadIdx.x; j < planes * 16; j += kN)
    cp_async16(six + j * 8, idx + ((j >> 4) * R + a) * 128 + (j & 15) * 8);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const unsigned lim = planes * 128;
  for (unsigned j = threadIdx.x; j < planes * 16; j += kN) {
    // int16 lane k of the 16 B piece: low half first (little-endian)
    const int4 v = *reinterpret_cast<const int4*>(six + j * 8);
    float4 lo, hi;
    lo.x = window_at(win, static_cast<int16_t>(v.x & 0xffff), lim);
    lo.y = window_at(win, v.x >> 16, lim);
    lo.z = window_at(win, static_cast<int16_t>(v.y & 0xffff), lim);
    lo.w = window_at(win, v.y >> 16, lim);
    hi.x = window_at(win, static_cast<int16_t>(v.z & 0xffff), lim);
    hi.y = window_at(win, v.z >> 16, lim);
    hi.z = window_at(win, static_cast<int16_t>(v.w & 0xffff), lim);
    hi.w = window_at(win, v.w >> 16, lim);
    float4* o = reinterpret_cast<float4*>(
        out + ((j >> 4) * R + a) * 128 + (j & 15) * 8);
    o[0] = lo;
    o[1] = hi;
  }
}

// K16: the flat route middle (T == 1024) on the stream g1,
//   out[qh, f, ql] = g1[qh, v, ql],  v = mid[f>>7, qh*128+ql, f&127]
// and 0 where v is not in [0, 1024): mstream_to_stream(tileperm(
// stream_to_mstream(g1, 1), mid)) with no mstream made (the TPU transposes
// a stream quarter in VMEM, gathers within slabs and transposes back).
// For fixed (qh, ql) it permutes the column g1[qh, :, ql] (1,024 values
// 512 B apart), reading its index along the rows of mid.  What bounds it:
// bytes (4 MB in, 2 MB of index, 4 MB out), and in the first design (K6's
// 32x33 shared-memory transpose reading g1 in place) the sectors: every
// 4 B gather came from another 512 B row of g1, one 32 B sector for 4 B
// used, four in flight a thread between barriers; torch.take by the
// composed index beat it by 1.3x.  Here one block of 1024 threads takes a
// strip of kFlatStrip lanes of one qh: it copies the strip's 1,024 rows of
// g1 (32 B each, a whole sector) and the 64 rows of mid that index it
// (fH, ql: 256 B each) into shared memory by 16 B cp.async, 48 KB in all,
// every copy in flight at once; then thread t gives the outputs
// e = t + k*1024 (k < 8) of the strip, f = e>>3, ql = ql0 + (e&7): a warp
// writes 4 whole 32 B sectors of 4 rows f per store.  The index rows are
// stored with their 16 B pieces swizzled by ql (piece c at c ^ (ql&7)), so
// the 8 lanes of one f read 8 distinct banks; the gather reads the strip
// row v at lane ql.  Device memory is read and written once, in whole
// sectors.  128 blocks (16 strips x 8 qh), one an SM.  32-bit indices: the
// shape is fixed.
constexpr int kFlatStrip = 8;      // lanes of a block's strip: 32 B a row
constexpr int kFlatThreads = 1024;
static_assert(kFlatStrip == 8 && kFlatThreads == 8 * kFlatStrip * 16,
              "two 16 B pieces a g1 row, one mid piece a thread");

__global__ void __launch_bounds__(kFlatThreads)
    route_flat_kernel(const float* __restrict__ g1,
                      const int16_t* __restrict__ mid,
                      float* __restrict__ out) {
  __shared__ float4 gs4[1024 * kFlatStrip / 4];  // g1[qh, v, ql0+l] at v*8+l
  __shared__ int4 ms4[8 * kFlatStrip * 16];      // mid row (fH, l): 16 pieces
  const float* gs = reinterpret_cast<const float*>(gs4);
  const int16_t* ms = reinterpret_cast<const int16_t*>(ms4);
  const unsigned ql0 = blockIdx.x * kFlatStrip, qh = blockIdx.y;
  const unsigned t = threadIdx.x;
  for (unsigned j = t; j < 1024 * kFlatStrip / 4; j += kFlatThreads)
    cp_async16(gs4 + j, g1 + (qh * 1024 + (j >> 1)) * 128 + ql0 + (j & 1) * 4);
  {  // one piece a thread: row r = (fH, l), piece c
    const unsigned r = t >> 4, c = t & 15, l = r & 7;
    cp_async16(ms4 + r * 16 + (c ^ l),
               mid + ((r >> 3) * 1024 + qh * 128 + ql0 + l) * 128 + c * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
#pragma unroll
  for (unsigned k = 0; k < 8; ++k) {
    const unsigned e = t + k * kFlatThreads;
    const unsigned f = e >> 3, l = e & 7, fL = f & 127;
    const int v = ms[((f >> 7) * 8 + l) * 128 + (((fL >> 3) ^ l) << 3) +
                     (fL & 7)];
    out[(qh * 1024 + f) * 128 + ql0 + l] =
        static_cast<unsigned>(v) < 1024 ? gs[v * kFlatStrip + l] : 0.f;
  }
}

// K6: the recursive middle's M3 stage and the mstream->stream relayout,
// the composition mstream_to_stream(gather_slabs(m, m3)):
//   g[fH, r, fL]               = m[v>>7, r, v&127],  v = m3[fH, r, fL]
//   out[qh, cd*1024+f, ql]     = g[fH, cd*1024+q, fL]
// with q = qh*128+ql, f = fH*128+fL.  For fixed (cd, qh, fH) that is a
// 128x128 transpose of g over (ql, fL); a block moves one 32x32 tile of it
// through shared memory, so m3 is read and out written coalesced (the TPU
// does the same transpose in VMEM, per chunk quarter).  Its gathers read
// within one mstream row r (8 planes x 512 B), which the L2 serves; it
// beats torch.take by its composed index (PERF.md), so it keeps this body.
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
// group's plane rows, from the stream-layout middle output gx: slice s sums
// over its plane rows R (the emission sweep: the rows after the previous
// emission up to the row that emits s)
//   P[i,R,l] = gx[v>>7, R, v&127] * vals[i,R,l],  v = p3[i,R,l]
// (0 where v is not in [0, 1024)) into ys[i, s, l].  The planes are the
// group's rows of larger planes, read in place: sv, sg and sp are the row
// counts between two planes of vals, gx and p3.  The TPU walks the rows in
// one sequential grid with the emission sweep.
//
// What bounds it: bytes (4 B of value, 2 B of index and one 4 B gx element
// per plane element), and in the first design (one block per plane row and
// sublane, all but the ~1,100 whose row ends a slice returning at once;
// 128 threads walking a slice's rows in series, one dependent chain of 2 B
// p3 load, scattered 4 B gx gather and 4 B vals load a row; the slice
// starts rebuilt by torch ops on every call) the serial walk of the
// longest slice: 17% of its bound, 1.5x behind cuSPARSE's SpMV of the
// same entries.  But every gather of row R reads only gx's row R over the
// 8 planes: 4 KB.  The design, K3's split with the row staged:
//   * the host cuts the slice table into pieces of at most kStreamRows
//     plane rows, once (reduce_stream_plan, made at upload): one block of
//     256 threads takes one piece, warp i its plane i, each thread 4 lanes;
//   * the block copies the piece's rows of gx into shared memory by 16 B
//     cp.async, one piece a thread a row (4 KB a row, all rows in flight
//     at once, kStreamRows*4 KB a block), and loads its p3 (8 B) and vals
//     (16 B) of every row meanwhile; then each thread gathers its 4 lanes
//     of each row from the staged row and sums the products in row order;
//   * a slice of one piece writes its ys row directly; the pieces of a
//     longer slice write partial rows, and a second pass
//     (reduce_stream_combine_kernel, K3's combine_partials) adds them in
//     piece order.  No float atomics: the output's bits repeat run to run.
// Index arithmetic is 32-bit: the wrapper refuses planes, ys or the
// partials past 2^31 - 1 elements.
constexpr int kStreamRows = 8;  // plane rows a piece holds at most

__global__ void __launch_bounds__(kReduceThreads)
    reduce_stream_kernel(const float* __restrict__ vals,
                         const float* __restrict__ gx,
                         const int16_t* __restrict__ p3,
                         const int32_t* __restrict__ pieces,
                         float* __restrict__ ys, float* __restrict__ part,
                         unsigned sv, unsigned sg, unsigned sp, unsigned nys,
                         unsigned npart) {
  // row u of the piece: gx[p, r0+u, l] at rows[u*1024 + p*128 + l]
  __shared__ float4 rows4[kStreamRows * kReduceThreads];
  const float* rows = reinterpret_cast<const float*>(rows4);
  const int r0 = __ldg(pieces + 3 * blockIdx.x);
  const int n = __ldg(pieces + 3 * blockIdx.x + 1) - r0;
  const int dst = __ldg(pieces + 3 * blockIdx.x + 2);
  const unsigned t = threadIdx.x;
  const unsigned i = t >> 5;
  const unsigned lq = (t & 31) * 4;
  // thread t copies plane i, lanes lq..lq+3 of each row: 16 B
  const float* g = gx + (i * sg + static_cast<unsigned>(r0)) * 128 + lq;
  for (int u = 0; u < n; ++u)
    cp_async16(rows4 + u * kReduceThreads + t, g + u * 128);
  asm volatile("cp.async.commit_group;\n" ::);
  const int16_t* px = p3 + (i * sp + static_cast<unsigned>(r0)) * 128 + lq;
  const float* pv = vals + (i * sv + static_cast<unsigned>(r0)) * 128 + lq;
  int2 ix[kStreamRows];
  float4 v[kStreamRows];
#pragma unroll
  for (int u = 0; u < kStreamRows; ++u) {
    if (u < n) {
      ix[u] = __ldcs(reinterpret_cast<const int2*>(px + u * 128));
      v[u] = __ldcs(reinterpret_cast<const float4*>(pv + u * 128));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float4 acc = make_float4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < kStreamRows; ++u) {
    if (u < n) {
      const float* row = rows + u * 1024;
      // int16 lane k of the 8 B piece: low half first (little-endian)
      const float4 gv = make_float4(
          window_at(row, static_cast<int16_t>(ix[u].x & 0xffff), 1024),
          window_at(row, ix[u].x >> 16, 1024),
          window_at(row, static_cast<int16_t>(ix[u].y & 0xffff), 1024),
          window_at(row, ix[u].y >> 16, 1024));
      fma4(acc, v[u], gv);
    }
  }
  float* o = dst >= 0
                 ? ys + (i * nys + static_cast<unsigned>(dst)) * 128 + lq
                 : part + (i * npart + static_cast<unsigned>(-1 - dst)) * 128 +
                       lq;
  *reinterpret_cast<float4*>(o) = acc;
}

// K18's second pass: K3's (combine_partials) on K18's partials.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_stream_combine_kernel(const float* __restrict__ part,
                                 const int32_t* __restrict__ combine,
                                 float* __restrict__ ys, unsigned nys,
                                 unsigned npart) {
  combine_partials(part, combine, ys, nys, npart);
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
                     void* out, int T, int tk, void* stream) {
  // K2 staged: 16 strips of 8 lanes x 8 qh, the strip's T rows staged
  const int smem = kMidStrip * (T + kMidPad) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_middle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  route_middle_kernel<<<dim3(128 / kMidStrip, 8), kMidThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g1), static_cast<const int16_t*>(m1),
      static_cast<const int16_t*>(csel), static_cast<float*>(out), T, tk);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_middle_m1(const void* g1, const void* m1, void* m1out, int T,
                        void* stream) {
  // K2 split, pass 1: 16 strips x 8 qh x Tk chunks
  route_middle_m1_kernel<<<dim3(128 / kMidStrip, 8, T / 1024), kM1Threads,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g1), static_cast<const int16_t*>(m1),
      static_cast<float*>(m1out), T);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_middle_select(const void* m1out, const void* csel, void* out,
                            int T, int tk, void* stream) {
  // K2 split, pass 2: a 16 B piece a thread, T*32 pieces a plane
  route_middle_select_kernel<<<dim3(T * 32 / kThreads, 8), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m1out), static_cast<const int16_t*>(csel),
      static_cast<float*>(out), T, tk);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_slices(const void* src, int srclen, const void* idx,
                      const void* vals, const void* pieces, void* ys,
                      void* part, int npieces, int S, int nys, int npart,
                      void* stream) {
  // one block per piece
  reduce_slices_kernel<<<static_cast<unsigned int>(npieces), kReduceThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<unsigned>(srclen),
      static_cast<const int32_t*>(idx),
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

int cvr_reduce_slices_cols(const void* X, int nx, int ldx, int kt,
                           const void* idx, const void* vals,
                           const void* pieces, void* ys, void* part,
                           int npieces, int S, int nys, int npart,
                           void* stream) {
  // one block per piece and sublane: 128 lanes x a thread a quad of 4
  // columns; 16 B loads of X where kt, ldx and X's address allow
  if (kt < 1 || kt > 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = kt % 4 == 0 && ldx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(npieces), 8);
  const unsigned threads = 128 * ((kt + 3) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(X);
  auto ix = static_cast<const int32_t*>(idx);
  auto v = static_cast<const float*>(vals);
  auto pc = static_cast<const int32_t*>(pieces);
  auto y = static_cast<float*>(ys);
  auto p = static_cast<float*>(part);
  if (vec)
    reduce_slices_cols_kernel<true><<<grid, threads, 0, s>>>(
        x, nx, ldx, kt, ix, v, pc, y, p, S, nys, npart);
  else
    reduce_slices_cols_kernel<false><<<grid, threads, 0, s>>>(
        x, nx, ldx, kt, ix, v, pc, y, p, S, nys, npart);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_slices_cols_combine(const void* part, const void* combine,
                                   void* ys, int ncombine, int nys, int npart,
                                   int kt, void* stream) {
  // one block per split slice
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(part);
  auto c = static_cast<const int32_t*>(combine);
  auto y = static_cast<float*>(ys);
  const unsigned blocks = static_cast<unsigned int>(ncombine);
  if (kt % 4 == 0)
    reduce_slices_cols_combine_kernel<true><<<blocks, kReduceThreads, 0, s>>>(
        p, c, y, nys, npart, kt);
  else
    reduce_slices_cols_combine_kernel<false><<<blocks, kReduceThreads, 0, s>>>(
        p, c, y, nys, npart, kt);
  return static_cast<int>(cudaGetLastError());
}

int cvr_route_small_cols(const void* ysp, const void* src, void* y, int n,
                         int kt, int ldy, void* stream) {
  // rows of kt floats moved 16 B at a time where kt, ldy and the addresses
  // of ysp and y allow; kColsRowsK4 rows a thread
  if (kt < 1 || kt > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(ysp);
  auto ix = static_cast<const int32_t*>(src);
  auto o = static_cast<float*>(y);
  const bool vec = kt % 4 == 0 && ldy % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ysp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int tpr = vec ? kt / 4 : 1;
  const unsigned rows = kThreads / tpr * kColsRowsK4;  // a block's rows
  const unsigned blocks = (static_cast<unsigned>(n) + rows - 1) / rows;
  if (vec && kt == 8)
    route_small_cols_kernel<2><<<blocks, kThreads, 0, s>>>(g, ix, o, n, kt,
                                                          ldy);
  else if (vec)
    route_small_cols_kernel<1><<<blocks, kThreads, 0, s>>>(g, ix, o, n, kt,
                                                          ldy);
  else
    route_small_cols_kernel<0><<<blocks, kThreads, 0, s>>>(g, ix, o, n, kt,
                                                          ldy);
  return static_cast<int>(cudaGetLastError());
}

int cvr_tileperm(const void* data, const void* idx, void* out, int R,
                 int planes, int middle, void* stream) {
  // one block per row; the row's data and index staged: P*(512 + 256) B
  const int smem = planes * 768;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const float*>(data);
  auto ix = static_cast<const int16_t*>(idx);
  auto o = static_cast<float*>(out);
  if (middle) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          tileperm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    tileperm_kernel<true><<<R, kGroupThreads, smem, s>>>(d, ix, o, R, planes);
  } else {
    tileperm_kernel<false><<<R, kPermThreads, smem, s>>>(d, ix, o, R, 8);
  }
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

int cvr_route_flat(const void* g1, const void* mid, void* out, void* stream) {
  // 16 strips of 8 lanes x 8 qh
  route_flat_kernel<<<dim3(128 / kFlatStrip, 8), kFlatThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g1), static_cast<const int16_t*>(mid),
      static_cast<float*>(out));
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
                      const void* pieces, void* ys, void* part, int npieces,
                      int sv, int sg, int sp, int nys, int npart,
                      void* stream) {
  // one block per piece
  reduce_stream_kernel<<<static_cast<unsigned int>(npieces), kReduceThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(gx),
      static_cast<const int16_t*>(p3), static_cast<const int32_t*>(pieces),
      static_cast<float*>(ys), static_cast<float*>(part), sv, sg, sp, nys,
      npart);
  return static_cast<int>(cudaGetLastError());
}

int cvr_reduce_stream_combine(const void* part, const void* combine,
                              void* ys, int ncombine, int nys, int npart,
                              void* stream) {
  // one block per split slice
  reduce_stream_combine_kernel<<<static_cast<unsigned int>(ncombine),
                                 kReduceThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(combine),
      static_cast<float*>(ys), nys, npart);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
