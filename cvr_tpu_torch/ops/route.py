"""Static routing engine: an arbitrary permutation as a 3-stage Clos route.

SpMV's indices are static, so the gather ``v[perm]`` is compiled ahead of
time into three passes that each move data only within 1024-element
tiles:

  1. view the stream as a (T, 1024) grid of tiles;
  2. permute within each source tile        (stage 1, ``s1``)
  3. transpose the grid
  4. permute within each row of length T     (the middle stage, ``mid``)
  5. transpose back
  6. permute within each dest tile           (stage 3, ``s3``)

The routing assignment (which intermediate color q in [0,1024) each
element takes) must give distinct colors within every source tile and
within every dest tile: a proper 1024-edge-coloring of the bipartite
multigraph (source tiles) x (dest tiles).  The graph is 1024-regular, so
recursive Euler splitting colors it in 10 levels.  The routed pack calls
the native compiler (``route_compile_native``); this module holds the
colorings (native where the library loads, else pure Python), the
recursive middle's decomposition and the numpy executor the route is
specified by.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TILE = 1024  # elements per routing tile


def euler_color_py(
    src: np.ndarray, dst: np.ndarray, n_tiles: int, k: int = TILE
) -> np.ndarray:
    """k-edge-coloring of a k-regular bipartite multigraph, pure Python.

    ``src[i]``/``dst[i]`` are the endpoint tile ids of edge i; every source
    tile and every dest tile must have exactly ``k`` incident edges, k a
    power of two.  Returns ``color[i] in [0, k)`` such that no two edges
    sharing a source tile or a dest tile have the same color.

    Recursive Euler splitting: all degrees are even, so the multigraph
    decomposes into closed walks; assigning alternate edges of each walk
    to two halves splits every degree exactly in half.  log2(k) levels end
    in perfect matchings, the color classes.
    """
    E = src.shape[0]
    if E != n_tiles * k:
        raise ValueError(f"edges {E} != n_tiles*k {n_tiles * k}")
    if k & (k - 1):
        raise ValueError("k must be a power of two")
    color = np.zeros(E, dtype=np.int32)

    def split(edge_ids: np.ndarray, kk: int, base: int) -> None:
        if kk == 1:
            color[edge_ids] = base
            return
        # incidence lists over the combined vertex set: u in [0, n),
        # v in [n, 2n)
        m = edge_ids.shape[0]
        u = src[edge_ids]
        v = dst[edge_ids] + n_tiles
        deg = np.zeros(2 * n_tiles, dtype=np.int64)
        np.add.at(deg, u, 1)
        np.add.at(deg, v, 1)
        off = np.zeros(2 * n_tiles + 1, dtype=np.int64)
        np.cumsum(deg, out=off[1:])
        adj = np.empty(2 * m, dtype=np.int64)
        cur = off[:-1].copy()
        for i in range(m):
            adj[cur[u[i]]] = i
            cur[u[i]] += 1
            adj[cur[v[i]]] = i
            cur[v[i]] += 1
        ptr = off[:-1].copy()
        used = np.zeros(m, dtype=bool)
        side = np.zeros(m, dtype=bool)  # False -> half A, True -> half B
        for start in range(m):
            if used[start]:
                continue
            # walk a closed trail from the u end of `start`; the side is
            # the traversal direction (u->v = A, v->u = B)
            e = start
            vert = u[start]
            while True:
                used[e] = True
                frm_u = vert < n_tiles
                side[e] = not frm_u
                vert = v[e] if frm_u else u[e]
                p = ptr[vert]
                nxt = -1
                while p < off[vert + 1]:
                    cand = adj[p]
                    if not used[cand]:
                        nxt = cand
                        break
                    p += 1
                ptr[vert] = p
                if nxt < 0:
                    break  # trail closed (degrees even => back at start)
                e = nxt
        split(edge_ids[~side], kk // 2, base)
        split(edge_ids[side], kk // 2, base + kk // 2)

    split(np.arange(E, dtype=np.int64), k, 0)
    return color


def euler_color(
    src: np.ndarray, dst: np.ndarray, n_tiles: int, k: int = TILE
) -> np.ndarray:
    """The native coloring when the library loads, euler_color_py
    otherwise (the two may color differently; each is proper).  The
    public counterpart of the reference's cvr_tpu/ops/route.py:145;
    plan_route colors with the native per-permutation pass when the
    library loads and with euler_color_py when it does not."""
    from cvr_tpu_torch import _native

    if _native.available():
        return _native.euler_color_native(src, dst, int(n_tiles), int(k))
    return euler_color_py(src, dst, n_tiles, k)


@dataclass
class RoutePlan:
    """Compiled static permutation ``out[i] = v[perm[i]]`` (bijection).

    Gather-form index planes over a logical (T, 1024) grid:

      s1    [T, 1024] int16: g1[a, q]       = v_grid[a, s1[a, q]]
      mid   [1024, T] int32: g2[q, d]       = g1t[q, mid[q, d]]
      s3    [T, 1024] int16: out_grid[d, o] = g2t[d, s3[d, o]]

    ``n`` is the real (unpadded) length; positions >= n are don't-care.
    """

    s1: np.ndarray
    mid: np.ndarray
    s3: np.ndarray
    n: int

    @property
    def n_tiles(self) -> int:
        return self.s1.shape[0]


def plan_route(
    perm: np.ndarray, n: int | None = None, tile_multiple: int = 1
) -> RoutePlan:
    """Compile a bijection into a 3-stage Clos route: the native coloring
    and plane pass when the library loads, else numpy around
    euler_color_py.

    ``perm``: out[i] = v[perm[i]], a permutation of [0, len(perm)).  The
    stream is padded to ``tile_multiple`` tiles of 1024 with identity
    tail positions (a multiple of 1024 tiles gives the recursive middle,
    plan_mid_recursive).
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = int(perm.shape[0]) if n is None else n
    N = perm.shape[0]
    T = max(1, -(-N // TILE))
    T = -(-T // tile_multiple) * tile_multiple
    Np = T * TILE
    full = np.arange(Np, dtype=np.int64)
    full[:N] = perm
    perm32 = full.astype(np.int32)

    from cvr_tpu_torch import _native

    if _native.available():
        # dst(i) = i >> 10 is implicit: no edge arrays
        colors = _native.euler_color_perm_native(perm32, T)
        s1, mid, s3 = _native.route_planes_native(perm32, colors, T)
        return RoutePlan(s1=s1, mid=mid, s3=s3, n=n)

    src_tile = perm32 >> 10  # source tile of the element destined to i
    d_of_edge = np.repeat(np.arange(T, dtype=np.int32), TILE)
    colors = euler_color_py(src_tile, d_of_edge, T, TILE)

    # stage 1: within source tile a, the color-q element sits at offset
    # perm[i] % TILE
    s1 = np.empty((T, TILE), dtype=np.int16)
    s1[src_tile, colors] = (perm32 & 1023).astype(np.int16)
    # middle: mid[q, d] = the source tile of the color-q element of dest d
    mid = np.empty((TILE, T), dtype=np.int32)
    mid[colors, d_of_edge] = src_tile.astype(np.int32)
    # stage 3: out position (tile d, offset o) takes color s3[d, o]
    s3 = np.empty((T, TILE), dtype=np.int16)
    s3[d_of_edge, np.arange(Np) & 1023] = colors.astype(np.int16)
    return RoutePlan(s1=s1, mid=mid, s3=s3, n=n)


def apply_route_numpy(plan: RoutePlan, v: np.ndarray) -> np.ndarray:
    """Reference executor: the specification the device passes meet."""
    T = plan.n_tiles
    g = np.zeros(T * TILE, dtype=v.dtype)
    g[: v.shape[0]] = v
    grid = g.reshape(T, TILE)
    g1 = np.take_along_axis(grid, plan.s1.astype(np.int64), axis=1)
    g2 = np.take_along_axis(g1.T.copy(), plan.mid.astype(np.int64), axis=1)
    out = np.take_along_axis(g2.T.copy(), plan.s3.astype(np.int64), axis=1)
    return out.reshape(-1)[: plan.n]


# ---------------------------------------------------------------------------
# The recursive (two-level Benes) middle stage
# ---------------------------------------------------------------------------
#
# The middle permutes within rows of length T.  Viewing a row as a
# (Tk, 1024) grid of chunks (Tk = T/1024), it decomposes into
#
#   M1: permute within each source chunk  -> position = chunk color m
#   M2: move across chunks at fixed m     -> a Tk-way select
#   M3: permute within each dest chunk    -> the final in-row position
#
# where the chunk color m is a second-level Euler coloring, one
# independent 1024-regular bipartite multigraph (Tk nodes a side) per row.


def plan_mid_recursive(plan: RoutePlan):
    """plan.mid decomposed into (m1, csel, m3) planes (see
    mid_recursive_planes)."""
    return mid_recursive_planes(plan.mid, plan.n_tiles)


def mid_recursive_planes(mid_arr, T: int):
    """Decompose a (1024, T) mid array into (m1, csel, m3) planes; T must
    be a multiple of 1024 (None for T == 1024: the flat middle).

    Returns logical planes, each (Tk*1024, 1024):
      m1[ca*1024 + q, m]   = the within-chunk source offset (a & 1023)
      csel[cd*1024 + q, m] = the source chunk ca
      m3[cd*1024 + q, f]   = the chunk color m of the element ending at f
    The native capacitated per-row colorings when the library loads, else
    euler_color_py row by row.
    """
    mid = np.ascontiguousarray(mid_arr, dtype=np.int32)  # [1024, T]
    if T % TILE:
        raise ValueError("recursive middle requires T % 1024 == 0")
    Tk = T // TILE
    if Tk == 1:
        return None

    from cvr_tpu_torch import _native

    if _native.available():
        colors = _native.color_rows_cap_native(mid, T, Tk)
        m1, csel, m3 = _native.mid_planes_native(mid, T, colors)
        return {"m1": m1, "csel": csel, "m3": m3, "Tk": Tk}

    a = mid.astype(np.int64)  # [1024, T]: source tile per (q, d)
    d = np.broadcast_to(np.arange(T, dtype=np.int64), (TILE, T))
    ca = (a >> 10).astype(np.int32)
    cd = (d >> 10).astype(np.int32)
    colors = np.empty((TILE, T), dtype=np.int32)
    for q in range(TILE):
        colors[q] = euler_color_py(ca[q], cd[q], Tk, TILE)

    q_grid = np.broadcast_to(
        np.arange(TILE, dtype=np.int64)[:, None], (TILE, T)
    )
    m = colors.astype(np.int64)
    m1 = np.empty((Tk * TILE, TILE), dtype=np.int16)
    m1[ca.astype(np.int64) * TILE + q_grid, m] = (a & 1023).astype(np.int16)
    csel = np.empty((Tk * TILE, TILE), dtype=np.int16)
    csel[cd.astype(np.int64) * TILE + q_grid, m] = ca.astype(np.int16)
    m3 = np.empty((Tk * TILE, TILE), dtype=np.int16)
    m3[cd.astype(np.int64) * TILE + q_grid, (d & 1023)] = m.astype(np.int16)
    return {"m1": m1, "csel": csel, "m3": m3, "Tk": Tk}
