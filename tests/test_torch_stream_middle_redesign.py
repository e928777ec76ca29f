"""The redesigned K18 (reduce_stream) and K2 (route_middle) of the port,
emulated in torch, against the plain versions and the JAX package.

A CUDA kernel cannot run here, so each new body is written out below as
the kernel computes it, one block at a time (vectorized over the blocks):
what each thread copies into shared memory, from which flat offsets
(32-bit: every offset is held below 2^31) and into which slots, what it
gathers from there and where it stores.

K18 cuts each reduce group's slices into pieces of at most
STREAM_PIECE_ROWS plane rows once (reduce_stream_plan, at upload), stages
a piece's rows of gx (4 KB a row) and sums each piece's rows in order with
one fused multiply-add a row; a split slice's partials are added in piece
order by a second pass.  Its order of summation (the fused multiply-add
emulated in float64, rounded to float32) must stay within 1e-6 of the row
scale of the plain version and of the JAX package's reduce_slices (Pallas
in interpret mode) on several reduce groups and on slices longer than one
piece.

K2 has two bodies: "staged" (a strip of 8 lanes of g1 over all T rows in
shared memory) and "split" (M1 per chunk, then the chunk select), chosen
by route_middle_geometry.  Both only move values, so each emulation must
give route_middle_plain's output bit for bit, and the JAX package's M1 +
chunk select, at Tk 1, 2 and 3, with chunk selects outside [0, Tk) giving
0.  The launch geometries' refusals are pure functions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_route as jpr
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.sell_routed import from_reference
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import spmv_routed as tsp
from torch_cases import CASES, rmat

INT32_LIMIT = 2**31
BANKS = 32  # shared-memory banks of 4 B
STREAM_THREADS = 256  # kReduceThreads of csrc/route_kernels.cu
MID_THREADS = 1024  # kMidThreads
M1_THREADS = 256  # kM1Threads
PAD = 4  # kMidPad


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


def _threads(n_items, n_threads):
    """The items a block's threads take in `for (e = t; e < n; e += N)`:
    each item once, in the order (k, t) of the loop's turns."""
    t = torch.arange(n_threads).view(1, -1)
    k = torch.arange(-(-n_items // n_threads)).view(-1, 1)
    e = (t + k * n_threads).reshape(-1)
    e = e[e < n_items]
    assert torch.equal(torch.sort(e).values, torch.arange(n_items))
    return e


def _flat(offsets):
    """offsets held to the kernels' 32-bit arithmetic."""
    assert int(offsets.min()) >= 0 and int(offsets.max()) < INT32_LIMIT
    return offsets


# ---------------------------------------------------------------------------
# K18: the packs, each group's plan, the emulated kernel
# ---------------------------------------------------------------------------

# name -> (JAX pack's matrix, its split_len, YB): several reduce groups
# (YB 4), a regular region of 16-row slices (each split in two), a slice
# of hundreds of plane rows (split in many pieces)
STREAM_CASES = {
    "rmat_yb4": (lambda: rmat(12, 16, 4)[0], None, 4),
    "uniform_w16": (lambda: CASES["uniform_w16"][0]()[0],
                    CASES["uniform_w16"][1], None),
    "powerlaw": (lambda: CASES["powerlaw"][0]()[0], CASES["powerlaw"][1],
                 None),
}


@pytest.fixture(scope="module")
def streams():
    """name -> (JAX pack, the port's artifact on the CPU, the middle's
    stream gx, YB): one pack per case, made (and its plans) with
    route_planes.YB and the JAX package's set to the case's YB."""
    out = {}
    for name, (make, split_len, yb) in STREAM_CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            if yb:
                mp.setattr(jpr, "YB", yb)
                mp.setattr(tpr, "YB", yb)
            jcoo = make()
            sr = j_pack_routed(jcoo.to_csr(), split_len=split_len,
                               hot="off")
            sd = tsp.to_device_routed(from_reference(sr), "cpu")
            x = np.random.default_rng(5).standard_normal(jcoo.shape[1])
            g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li,
                           _t(x.astype(np.float32)), sd.segw, sd.n_segs)
            out[name] = (sr, sd, tsp.middle_pass(g1, sd.mid), tpr.YB)
    return out


def _groups(sr, YB):
    """(group, rows slice, its slice count) of each reduce group."""
    for j, (r0, nr) in enumerate(np.asarray(sr.ycall_rows).tolist()):
        yield j, slice(r0, r0 + nr), min(YB, sr.nslices - j * YB)


def reduce_stream_emulated(vals, gx, p3, g0, plan):
    """reduce_stream_kernel, then reduce_stream_combine_kernel, on the
    group of plan.S plane rows that starts at row g0 of the whole planes
    vals, p3 (8, S_pad, 128) and gx (8, >= S_pad, 128), read in place,
    block by block: block b takes piece b (rows [r0, r1) of the group, at
    most STREAM_PIECE_ROWS), thread t its plane i = t>>5 and lanes lq =
    (t&31)*4.  Per row u it copies gx's 16 B at (i*rows + g0+r0+u)*128 +
    lq (rows: gx's row count) to rows[u*1024 + t*4], loads its 4 int16 of
    p3 and 4 floats of vals at the same place of their planes, gathers
    rows[u*1024 + v] (0 for v outside [0, 1024)) and adds the product
    into one accumulator, row after row (a fused multiply-add: product and
    sum in float64, rounded once); it stores the 16 B to ys or to its
    partial row; a split slice's partials are added in piece order."""
    split, nys = plan.split, plan.nslices
    P = rk.STREAM_PIECE_ROWS
    r0, r1, dst = split.pieces.long().unbind(1)
    n = r1 - r0
    assert not n.numel() or int(n.max()) <= P
    t = torch.arange(STREAM_THREADS)
    i, lq = t >> 5, (t & 31) * 4
    u = torch.arange(P)
    live = (u.view(1, -1) < n.view(-1, 1)).view(-1, P, 1)
    row = (g0 + r0).view(-1, 1, 1) + torch.where(live, u.view(1, -1, 1), 0)
    k = torch.arange(4)

    def quads(plane):  # (B, u, t, 4): each thread's 4 lanes of each row
        off = _flat((i * plane.shape[1] + row) * 128 + lq)
        return plane.reshape(-1)[off.unsqueeze(-1) + k]

    staged = quads(gx).reshape(-1, P, 1024)
    # the slot of each copy: rows[u*1024 + t*4 + k] = plane i, lane lq + k
    assert torch.equal((t * 4).view(-1, 1) + k, (i * 128 + lq).view(-1, 1) + k)
    v, w = quads(p3).long(), quads(vals)
    g = torch.gather(staged, 2, v.clamp(0, 1023).reshape(-1, P, 1024))
    g = torch.where((v >= 0) & (v < 1024), g.view(v.shape), 0.0)
    acc = torch.zeros((n.shape[0], STREAM_THREADS, 4), dtype=torch.float32)
    for j in range(P):
        fma = (acc.double() + w[:, j].double() * g[:, j].double()).float()
        acc = torch.where(live[:, j].unsqueeze(-1), fma, acc)
    ys = torch.zeros((8, nys, 128), dtype=torch.float32)
    part = torch.zeros((8, split.npart, 128), dtype=torch.float32)
    acc = acc.view(-1, 8, 128)  # (B, i, lq + k)
    one = dst >= 0
    ys[:, dst[one]] = acc[one].permute(1, 0, 2)
    part[:, -1 - dst[~one]] = acc[~one].permute(1, 0, 2)
    for c0, c1, o in split.combine.tolist():
        s = part[:, c0]
        for c in range(c0 + 1, c1):
            s = s + part[:, c]
        ys[:, o] = s
    return ys


def _within(got, want, scale):
    err = (got.double() - torch.as_tensor(np.array(want)).double()).abs()
    assert (err <= 1e-6 * torch.as_tensor(scale).double() + 1e-30).all(), (
        float(err.max()))


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_plans_cover_every_slice_once(streams, case):
    """Each group's plan (made at upload from the pack's emissions) cuts
    every slice of reduce_stream_table into pieces of at most
    STREAM_PIECE_ROWS rows covering its rows once, in row order; a split
    slice's partials are consecutive, numbered in piece order; and the
    plan made from the group's emit tensor (the wrapper's, when it is
    handed none) is the same."""
    sr, sd, _, YB = streams[case]
    assert len(sd.stream_plans) == len(sr.ycall_rows)
    for j, rows, nsl in _groups(sr, YB):
        plan = sd.stream_plans[j]
        emit = _t(sr.emit[rows])
        assert (plan.S, plan.nslices) == (emit.shape[0], nsl)
        again = rk.reduce_stream_plan(emit, nsl)
        assert torch.equal(again.split.pieces, plan.split.pieces)
        assert torch.equal(again.split.combine, plan.split.combine)
        row0, row1, out = rk.reduce_stream_table(emit, nsl)
        pieces = plan.split.pieces.tolist()
        combine = {o: (c0, c1) for c0, c1, o in plan.split.combine.tolist()}
        p = 0
        for a, b, o in zip(row0.tolist(), row1.tolist(), out.tolist()):
            npc = max(1, -(-(b - a) // rk.STREAM_PIECE_ROWS))
            mine = pieces[p : p + npc]
            p += npc
            assert [r for s, e, _ in mine for r in range(s, e)] == list(
                range(a, b))
            assert all(e - s <= rk.STREAM_PIECE_ROWS for s, e, _ in mine)
            if npc == 1:
                assert mine[0][2] == o and o not in combine
            else:
                c0, c1 = combine[o]
                assert [d for _, _, d in mine] == [-1 - c for c in
                                                   range(c0, c1)]
        assert p == len(pieces)
        dst = plan.split.pieces[:, 2]
        np.testing.assert_array_equal(-1 - dst[dst < 0].numpy(),
                                      np.arange(plan.split.npart))


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_k18_order_matches_plain_and_pallas(streams, case):
    """K18's order, emulated, on every reduce group of the case against
    reduce_stream_plain and, on its first two groups, the JAX package's
    reduce_slices (interpret mode), within 1e-6 of the row scale; the
    cases reach three or more reduce groups and slices longer than one
    piece."""
    sr, sd, gx, YB = streams[case]
    gxn = gx.numpy()
    emit_all = _t(sr.emit)
    gemit_all = _t(tpr.group_emit_encode(sr.emit))
    split_any = False
    for j, rows, nsl in _groups(sr, YB):
        plan = sd.stream_plans[j]
        split_any |= plan.split.combine.shape[0] > 0
        args = (emit_all[rows], gemit_all[rows.start // 8 : rows.stop // 8],
                sd.vals_ss[:, rows], gx[:, rows], sd.p3[:, rows], nsl)
        got = reduce_stream_emulated(sd.vals_ss, gx, sd.p3, rows.start, plan)
        want = rk.reduce_stream_plain(*args)
        scale = rk.reduce_stream_plain(args[0], args[1], args[2].abs(),
                                       args[3].abs(), args[4], nsl)
        _within(got, want, scale)
        assert torch.equal(rk.reduce_stream(*args, plan), want)
        if j < 2:
            jax = np.asarray(jpr.reduce_slices(
                jnp.asarray(sr.emit[rows]),
                jnp.asarray(tpr.group_emit_encode(sr.emit[rows])),
                jnp.asarray(sr.vals_ss[:, rows]), jnp.asarray(gxn[:, rows]),
                jnp.asarray(sr.p3[:, rows]), nsl))
            _within(got, jax, scale)
    assert split_any or case == "rmat_yb4"
    if case == "rmat_yb4":
        assert len(sr.ycall_rows) >= 3


def test_k18_without_a_plan_equals_with_it(streams):
    """reduce_unfused with the plans made at upload, and with none (each
    reduce_stream then plans its group itself), bit for bit; and the
    emulated kernel on the plan made from the group's emit tensor gives
    the upload plan's sums bit for bit."""
    sr, sd, gx, YB = streams["powerlaw"]
    emit = _t(sr.emit)
    gemit = _t(tpr.group_emit_encode(sr.emit))
    ys = tsp.reduce_unfused(sd, gx, emit, gemit, sr.ycall_rows)
    bare = dataclasses.replace(sd, stream_plans=())
    assert torch.equal(tsp.reduce_unfused(bare, gx, emit, gemit,
                                          sr.ycall_rows), ys)
    for j, rows, nsl in _groups(sr, YB):
        mine = rk.reduce_stream_plan(emit[rows], nsl)
        assert torch.equal(
            reduce_stream_emulated(sd.vals_ss, gx, sd.p3, rows.start, mine),
            reduce_stream_emulated(sd.vals_ss, gx, sd.p3, rows.start,
                                   sd.stream_plans[j]))


@pytest.mark.parametrize("rows, nys, npart", [
    ((7168, 7168, 7168), 512, 200),  # web-Google-like's planes
    ((2**21 - 1,) * 3, 2**21 - 1, 2**21 - 1),  # 8*rows*128 < 2^31
])
def test_reduce_stream_geometry_takes(rows, nys, npart):
    rk.reduce_stream_geometry(rows, nys, npart)


@pytest.mark.parametrize("rows, nys, npart, what", [
    ((2**21, 8, 8), 4, 0, "planes"),
    ((8, 8, 2**21), 4, 0, "planes"),
    ((8, 8, 8), 2**21, 0, "ys"),
    ((8, 8, 8), 4, 2**21, "partials"),
])
def test_reduce_stream_geometry_refuses(rows, nys, npart, what):
    with pytest.raises(ValueError, match=what):
        rk.reduce_stream_geometry(rows, nys, npart)


# ---------------------------------------------------------------------------
# K2: the planes, the two emulated bodies
# ---------------------------------------------------------------------------


def _middle_planes(Tk, seed):
    """(g1, m1, csel) numpy planes (8, Tk*1024, 128): Tk 2 the recursive
    middle of a random route over 2048 tiles (test_torch_route_kernels'
    construction), else m1 in [0, 1024) and csel in [0, Tk) from a seed;
    csel then takes -1, Tk, -32768 and 32767 on plane 0's first rows."""
    rng = np.random.default_rng(seed)
    T = Tk * 1024
    g1 = rng.standard_normal((8, T, 128), dtype=np.float32)
    if Tk == 2:
        perm = np.random.default_rng(4).permutation(2048 * 1024)
        mp = jpr.route_arrays_from_perm(perm)["mid_planes"]
        assert mp["kind"] == "rec" and mp["Tk"] == 2
        m1, csel = mp["m1"].copy(), mp["csel"].copy()
    else:
        m1 = rng.integers(0, 1024, (8, T, 128), dtype=np.int32)
        csel = rng.integers(0, Tk, (8, T, 128), dtype=np.int32)
        m1, csel = m1.astype(np.int16), csel.astype(np.int16)
    csel[0, :4, :] = np.array([-1, Tk, -32768, 32767])[:, None]
    return g1, m1, csel


def route_middle_staged_emulated(g1, m1, csel):
    """route_middle_kernel, block by block (blockIdx.x the strip of 8
    lanes ql0 = 8*x, blockIdx.y qh), on planes (8, T, 128): copy
    e = r*8 + j (a 4 B cp.async; thread t takes e = t + k*1024) puts
    g1[qh, r, ql0 + j] at gs[j*(T+4) + r]; thread t (j = t>>7, l = t&127)
    then gives, for each (i, cd), the output at (i*T + cd*1024 + Q)*128 +
    l, Q = qh*128 + ql0 + j: with ca its csel, gs[j*(T+4) + ca*1024 +
    (m & 1023)] for m = m1's element at (i*T + ca*1024 + Q)*128 + l, or 0
    where ca is not in [0, Tk).  Also returns the banks of the staging
    copies, one row of 32 per warp and turn."""
    T = g1.shape[1]
    Tk, ld = T // 1024, T + PAD
    assert rk.route_middle_geometry(T, "staged") == "staged"
    assert 8 * ld * 4 <= rk.SMEM_MAX
    gf, mf, cf = g1.reshape(-1), m1.reshape(-1), csel.reshape(-1)
    x = torch.arange(16).view(16, 1, 1)
    qh = torch.arange(8).view(1, 8, 1)
    ql0 = 8 * x
    e = _threads(T * 8, MID_THREADS)
    r, j = e >> 3, e & 7
    slot = j * ld + r
    gs = torch.empty((16, 8, 8 * ld), dtype=g1.dtype)
    gs[:, :, slot] = gf[_flat((qh * T + r) * 128 + ql0 + j)]
    banks = (slot % BANKS).view(-1, 32)
    t = torch.arange(MID_THREADS)
    jt, lt = t >> 7, t & 127
    k = torch.arange(8 * Tk).view(-1, 1)
    i, cd = k // Tk, k % Tk
    Q = (qh * 128 + ql0).unsqueeze(-1) + jt  # (16, 8, 1, t)
    dst = _flat(((i * T + cd * 1024) + Q) * 128 + lt)  # (16, 8, k, t)
    ca = cf[dst].long()
    ok = (ca >= 0) & (ca < Tk)
    src = _flat(((i * T + ca.clamp(0, Tk - 1) * 1024) + Q) * 128 + lt)
    m = mf[src].long() & 1023
    pos = jt * ld + ca.clamp(0, Tk - 1) * 1024 + m
    got = torch.where(ok, torch.gather(gs, 2, pos.view(16, 8, -1))
                      .view(pos.shape), 0.0)
    out = torch.full((g1.numel(),), float("nan"), dtype=g1.dtype)
    out[dst.reshape(-1)] = got.reshape(-1)
    assert torch.unique(dst).numel() == out.numel()  # every output once
    return out.view(g1.shape), banks


def route_middle_split_emulated(g1, m1, csel):
    """route_middle_m1_kernel, then route_middle_select_kernel.  Pass 1,
    block (x, qh, ca): copy e = r*8 + j puts g1[qh, ca*1024 + r, ql0 + j]
    at gs[j*1028 + r]; thread t (l = t&127) gives output rows rr =
    2*k + (t>>7) (i = rr>>3, j = rr&7): m1out at (i*T + ca*1024 + Q)*128
    + l, Q = qh*128 + ql0 + j, is gs[j*1028 + (m & 1023)] for m1's m
    there.  Pass 2, one 16 B piece q a thread per plane i: R = q>>5,
    l = (q&31)*4, e = (i*T + R)*128 + l; lane k is m1out at
    (i*T + (R&1023))*128 + l + ca*1024*128 + k for its csel ca, or 0."""
    T = g1.shape[1]
    Tk, ld = T // 1024, 1024 + PAD
    assert 8 * ld * 4 <= 48 * 1024  # static shared memory
    gf, mf, cf = g1.reshape(-1), m1.reshape(-1), csel.reshape(-1)
    x = torch.arange(16).view(16, 1, 1, 1)
    qh = torch.arange(8).view(1, 8, 1, 1)
    c0 = 1024 * torch.arange(Tk).view(1, 1, Tk, 1)
    ql0 = 8 * x
    e = _threads(1024 * 8, M1_THREADS)
    r, j = e >> 3, e & 7
    gs = torch.empty((16, 8, Tk, 8 * ld), dtype=g1.dtype)
    gs[..., j * ld + r] = gf[_flat((qh * T + c0 + r) * 128 + ql0 + j)]
    banks = ((j * ld + r) % BANKS).view(-1, 32)
    assert torch.equal(banks.sort(1).values,
                       torch.arange(BANKS).expand_as(banks))
    t = torch.arange(M1_THREADS)
    rr = 2 * torch.arange(32).view(-1, 1) + (t >> 7)  # (k, t)
    i, jr, lt = rr >> 3, rr & 7, t & 127
    dst = _flat(((i * T + c0.unsqueeze(-1)) + qh.unsqueeze(-1) * 128
                 + ql0.unsqueeze(-1) + jr) * 128 + lt)  # (16, 8, Tk, k, t)
    m = mf[dst].long() & 1023
    pos = (jr * ld + m).view(16, 8, Tk, -1)
    m1out = torch.full((g1.numel(),), float("nan"), dtype=g1.dtype)
    m1out[dst.reshape(-1)] = torch.gather(gs, 3, pos).reshape(-1)
    assert torch.unique(dst).numel() == m1out.numel()
    q = torch.arange(T * 32)
    R, lq = q >> 5, (q & 31) * 4
    ip = torch.arange(8).view(8, 1)
    base = _flat((ip * T + R) * 128 + lq)  # (i, q)
    out = torch.empty_like(gf)
    for kk in range(4):
        ca = cf[base + kk].long()
        ok = (ca >= 0) & (ca < Tk)
        src = _flat((ip * T + (R & 1023)) * 128 + lq
                    + ca.clamp(0, Tk - 1) * 1024 * 128 + kk)
        out[base + kk] = torch.where(ok, m1out[src], 0.0)
    return out.view(g1.shape)


def _jax_middle(g1, m1, csel, Tk):
    m = jpr._mid_fused_call(Tk, "m1", True)(jnp.asarray(g1), m1)
    return np.asarray(jpr.chunksel(m, csel, Tk))


@pytest.mark.parametrize("Tk", [1, 2, 3])
def test_k2_bodies_match_plain_and_pallas(Tk):
    """Both bodies, emulated, bit for bit against route_middle_plain and
    the JAX package's M1 + chunk select (interpret mode), also where the
    chunk select is outside [0, Tk) (0 there); the staged body's copies
    land in 32 distinct banks a warp."""
    g1, m1, csel = _middle_planes(Tk, seed=10 + Tk)
    tg, tm, tc = _t(g1), _t(m1), _t(csel)
    want = rk.route_middle_plain(tg, tm, tc)
    assert float(want[0, :4].abs().max()) == 0.0  # the chunk selects put in
    staged, banks = route_middle_staged_emulated(tg, tm, tc)
    assert torch.equal(staged, want)
    assert torch.equal(banks.sort(1).values,
                       torch.arange(BANKS).expand_as(banks))
    assert torch.equal(route_middle_split_emulated(tg, tm, tc), want)
    np.testing.assert_array_equal(want.numpy(), _jax_middle(g1, m1, csel, Tk))
    assert torch.equal(rk.route_middle(tg, tm, tc), want)


@pytest.mark.parametrize("T, body", [(1024, "staged"), (7168, "staged"),
                                     (8192, "split"), (2**21 - 1024, "split")])
def test_route_middle_geometry_switches_at_the_shared_memory(T, body):
    """Staged while 8*(T+4)*4 B fit a block (up to Tk 7), then split;
    each body takes its launches."""
    assert rk.route_middle_geometry(T) == body
    assert rk.ROUTE_MIDDLE_LAUNCHES[body] == {"staged": 1, "split": 2}[body]
    assert rk.route_middle_geometry(T, "split") == "split"


@pytest.mark.parametrize("T, body, what", [
    (2**21, None, "32-bit"),
    (2**21, "split", "32-bit"),
    (8192, "staged", "shared memory"),
    (1024, "fused", "no body"),
])
def test_route_middle_geometry_refuses(T, body, what):
    with pytest.raises(ValueError, match=what):
        rk.route_middle_geometry(T, body)
