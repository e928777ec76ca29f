"""Entry points: the flagship SpMV and the multi-device dry run.

    python -m cvr_tpu_torch.entry entry      # one flagship SpMV on the card
    python -m cvr_tpu_torch.entry [dryrun] [N]   # dryrun_multichip(N), N 8

entry()             -> (fn, example_args): the routed SpMV (K3
                       reduce_slices from x, K4 route_small; K7 reduce_hot where
                       the hub-column gate fires) on a power-law matrix,
                       the flagship workload, and its arguments on the card.
dryrun_multichip(n) -> every row-sharded path once on tiny shapes, on a
                       mesh of n shards (by default n shards of the first
                       card), each held against the float64 golden
                       (parallel/dryrun.py).

The port of the JAX package's ``__graft_entry__``: the same matrix, pack
and x.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cvr_tpu_torch.bench.synthetic import rmat_matrix
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
from cvr_tpu_torch.ops.spmv_routed import spmv_routed, to_device_routed
from cvr_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]


def entry(device="cuda"):
    """(spmv_routed, (sd, x)): the routed SpMV and its arguments on
    ``device`` (the card unless the caller asks for the CPU)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU run")
    coo = rmat_matrix(scale=12, edge_factor=8, seed=0)
    sd = to_device_routed(sell_pack_routed(coo.to_csr()), device)
    x = torch.from_numpy(
        np.random.default_rng(0)
        .standard_normal(coo.shape[1])
        .astype(np.float32)
    ).to(device)
    return spmv_routed, (sd, x)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "dryrun"
    if mode == "entry":
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry(): OK", tuple(out.shape))
    else:
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
