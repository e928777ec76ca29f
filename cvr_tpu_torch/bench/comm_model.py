"""The comm-volume / weak-scaling table from a results JSONL.

Per matrix (the latest row of each name that carries shape info): the
device-memory bytes a shard streams per iteration, the bytes it gathers
at D = 8, the modeled comm time, the projected weak-scaling efficiency at
D = 8 / 64 / 256 for the blocking all-gather path and the ring's overlap,
the largest D that keeps E >= 70%, and the best 2-D mesh at D = 8 and 64
(cvr_tpu_torch/parallel/comm_model.py has the model).  The JAX package's
``scripts/comm_model.py``, with two differences: the link rate and the
link count are required (the JAX script's defaults are one TPU's links),
and the default input is the port's own results file, never the JAX
package's TPU runs.

Usage:
  python -m cvr_tpu_torch.bench.comm_model [results_h100.jsonl] \\
      --link-bw 25e9 --links 18 [--fexp 0.35]
"""

from __future__ import annotations

import argparse
import json
import sys

from cvr_tpu_torch.parallel.comm_model import (
    best_mesh_2d,
    comm_table,
    knee_devices,
    weak_scaling,
)
from cvr_tpu_torch.utils.report import DEFAULT_JSONL


def latest_rows(lines) -> dict[str, dict]:
    """The last row of each name among JSON ``lines`` that has ncols."""
    latest: dict[str, dict] = {}
    for line in lines:
        r = json.loads(line)
        if r.get("ncols"):
            latest[r["name"]] = r
    return latest


def table(latest: dict[str, dict], *, link_bw: float, links: int,
          f_exp: float = 0.35) -> str:
    """The table of ``latest`` rows (latest_rows), in the JAX script's
    layout."""
    kw = dict(link_bw=link_bw, links=links, f_exp=f_exp)
    hdr = (
        f"{'domain':<18} {'HBM MB/it':>10} {'ICI MB/it@8':>12} "
        f"{'t_comp ms':>10} {'t_comm ms@8':>12} "
        f"{'E8 blk/ovl':>12} {'E64':>10} {'E256':>10} {'D@70% blk/ovl':>14} "
        f"{'2D E8 (RxC)':>12} {'2D E64':>8}"
    )
    out = [hdr, "-" * len(hdr)]
    for cr in comm_table(list(latest.values()), D=8, **kw):
        r = latest[cr.name]
        ncols = int(r["ncols"])
        e64 = weak_scaling(cr.t_comp_s, ncols, 64, **kw)
        e256 = weak_scaling(cr.t_comp_s, ncols, 256, **kw)
        kb, ko = knee_devices(cr.t_comp_s, ncols, **kw)
        nrows = int(r.get("nrows") or r["ncols"])
        R8, C8, e2b8, _ = best_mesh_2d(cr.t_comp_s, ncols, nrows, 8, **kw)
        _, _, e2b64, _ = best_mesh_2d(cr.t_comp_s, ncols, nrows, 64, **kw)
        out.append(
            f"{cr.name:<18} {cr.stream_bytes / 1e6:>10.1f} "
            f"{cr.gather_bytes / 1e6:>12.2f} {cr.t_comp_s * 1e3:>10.3f} "
            f"{cr.t_comm_s * 1e3:>12.4f} "
            f"{cr.eff_blocking:>5.2f}/{cr.eff_overlap:<5.2f}"
            f" {e64[1]:>4.2f}/{e64[2]:<4.2f} {e256[1]:>4.2f}/{e256[2]:<4.2f}"
            f" {kb:>6d}/{ko:<6d}"
            f" {e2b8:>5.2f} ({R8}x{C8}) {e2b64:>7.2f}"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jsonl", nargs="?", default=DEFAULT_JSONL)
    ap.add_argument("--link-bw", type=float, required=True,
                    help="bytes/s per link and direction")
    ap.add_argument("--links", type=int, required=True,
                    help="links a device moves x over")
    ap.add_argument("--fexp", type=float, default=0.35)
    args = ap.parse_args(argv)

    with open(args.jsonl) as f:
        latest = latest_rows(f)
    if not latest:
        print(f"no rows with shape info in {args.jsonl}", file=sys.stderr)
        return 1
    print(table(latest, link_bw=args.link_bw, links=args.links,
                f_exp=args.fexp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
