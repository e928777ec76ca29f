"""The row-sharded paths that tests/test_torch_multiprocess.py runs on a
world of gloo CPU ranks and on one process's CPU mesh.

A module of its own, without JAX: torch.multiprocessing's spawned ranks
import it to find ``rank_body``.  Each path: (its matrix, the columns of
X or None for an SpMV, the x modes it runs); ``run_paths`` packs and
runs every path on either kind of mesh, by one code path.
"""

import numpy as np
import torch

from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import dist2d as t2d
from cvr_tpu_torch.parallel import dist_bell as tbell
from cvr_tpu_torch.parallel import dist_bsr as tbsr
from cvr_tpu_torch.parallel import dist_dia as tdia
from cvr_tpu_torch.parallel import dist_lane as tlane
from cvr_tpu_torch.parallel import dist_pmm as tpmm
from cvr_tpu_torch.parallel import dist_routed as tdr
from cvr_tpu_torch.parallel import dist_window as twin

XMODES = ("replicated", "x_sharded")
RING_MODES = ("replicated", "x_sharded", "overlap")
K = 4  # the SpMMs' columns

# path -> (matrix, K or None, modes)
PATHS = {
    "routed": ("ring", None, RING_MODES),
    "sell": ("powerlaw", None, XMODES),
    "window": ("fem", None, XMODES),
    "dia": ("dia", None, XMODES),
    "bell": ("road", None, XMODES),
    "lane": ("powerlaw", K, XMODES),
    "bsr": ("bsr", K, XMODES),
    "pmm": ("fsm", K, XMODES),
    "routed2d": ("ring", None, ("x whole",)),
}
MESH2D = (2, 2)

_PACKS = {
    "routed": lambda csr, mesh: tdr.dist_routed_pack(csr, mesh, overlap=True),
    "sell": tdist.dist_sell_pack,
    "window": twin.dist_window_pack,
    "dia": tdia.dist_dia_pack,
    "bell": tbell.dist_bell_pack,
    "lane": tlane.dist_lane_pack,
    "bsr": tbsr.dist_bsr_pack,
    "pmm": tpmm.dist_pmm_pack,
    "routed2d": t2d.dist_routed_pack_2d,
}
_PRODUCTS = {
    "routed": tdr.dist_spmv_routed,
    "sell": tdist.dist_spmv,
    "window": twin.dist_spmv_window,
    "dia": tdia.dist_spmv_dia,
    "bell": tbell.dist_spmv_bell,
    "lane": tlane.dist_spmm_lane,
    "bsr": tbsr.dist_spmm_bsr,
    "pmm": tpmm.dist_spmm_pmm,
}


def paths(D: int) -> list[str]:
    """The paths a mesh of D shards runs (the 2-D mesh at 2 x 2 only)."""
    return [p for p in PATHS
            if p != "routed2d" or D == MESH2D[0] * MESH2D[1]]


def x_of(path: str, ncols: int) -> np.ndarray:
    """The path's x (or X), from a seed."""
    K = PATHS[path][1]
    return np.random.default_rng(3).standard_normal(
        ncols if K is None else (ncols, K)).astype(np.float32)


def mesh_of(path: str, D: int, cpu: bool):
    """The path's mesh: over the world's ranks, or (``cpu``) D shards of
    one process on the CPU."""
    devices = ["cpu"] * D if cpu else None
    if path == "routed2d":
        return t2d.make_mesh2d(*MESH2D, devices=devices)
    return tdist.make_mesh(devices=devices)


def product(path: str, dm, x: np.ndarray, mode: str) -> np.ndarray:
    xt = torch.from_numpy(x)
    if path == "routed2d":
        return t2d.dist_spmv_routed_2d(dm, xt).numpy()
    kw = {"x_sharded": mode != "replicated"}
    if mode == "overlap":
        kw["overlap"] = True
    return _PRODUCTS[path](dm, xt, **kw).numpy()


def run_paths(mats: dict, D: int, cpu: bool) -> dict:
    """Every path of ``paths(D)`` packed and run in each of its modes:
    {(path, mode): y}.  ``mats``: matrix name -> (rows, cols, vals,
    shape) as tensors."""
    out = {}
    for path in paths(D):
        rows, cols, vals, shape = mats[PATHS[path][0]]
        csr = COOMatrix(rows=rows.numpy(), cols=cols.numpy(),
                        vals=vals.numpy(), shape=tuple(shape)).to_csr()
        dm = _PACKS[path](csr, mesh_of(path, D, cpu))
        x = x_of(path, csr.shape[1])
        for mode in PATHS[path][2]:
            out[path, mode] = product(path, dm, x, mode)
    return out


def rank_body(rank: int, mats: dict) -> dict:
    """One rank of the world: what it holds, whether a mesh of another
    size than the world's is refused, and every path's y."""
    mesh = tdist.make_mesh()
    try:
        tdist.make_mesh(mesh.size + 1)
        refused = False
    except ValueError:
        refused = True
    return {"local": mesh.local, "home": str(mesh.home),
            "n_devices_refused": refused,
            "ys": run_paths(mats, mesh.size, cpu=False)}
