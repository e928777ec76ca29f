"""The measured-vs-reference table from a results JSONL.

Per CGO'18 paper domain (DOMAINS: each with two or more structurally
distinct stand-ins; the domain's score is the least of its matrices'
medians): the median GFLOPS (2*nnz) of each matrix's verified runs in
the file (the csr and sell-xla baselines left out), min / median pack
time, the ratio to CVR's domain average on the 68-core KNL (the paper's
Table 3: the baseline, not a TPU or an H100 number), the domains won and
the geomean ratio; then the comm-model table of the same rows
(cvr_tpu_torch/parallel/comm_model.py).  The JAX package's
``scripts/make_parity.py``, with three differences: the default input is
the port's own results file, the link rate and link count of the comm
model are required, and ``--write`` splices the markdown between the
BEGIN / END markers of the file ``--parity`` names (default a file of
the port's own, PARITY_H100.md, made where missing), never the JAX
package's docs/PARITY.md.

Usage:
  python -m cvr_tpu_torch.bench.parity [results_h100.jsonl] \\
      --link-bw 25e9 --links 18 [--write] [--parity PARITY_H100.md]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from cvr_tpu_torch.utils.report import DEFAULT_JSONL

# paper Table 3 (2*nnz GFLOPS on the 68-core KNL), per domain its stand-in
# matrices; the domain score is the least of its matrices' medians
DOMAINS = [
    ("webGraph", ["web-Google-like", "web-rmat-b"], 7.28),
    ("social", ["soc-LJ-like", "soc-rmat-b"], 6.59),
    ("wiki", ["wiki-Talk-like", "wiki-hub-b"], 5.77),
    ("citation", ["citation-like", "citation-b"], 6.26),
    ("road", ["road-usa-like", "road-b"], 9.57),
    ("routing", ["rgg-like", "rgg-b"], 17.11),
    ("FSM", ["fsm-like", "fsm-b"], 8.09),
    ("EngSci", ["fem-like", "fem-b"], 21.11),
]
# shown for context, never counted in the domain score
EXTRAS = [
    ("EngSci (strict band)", ["banded-2M"], 21.11),
    ("social (full scale)", ["soc-LJ-full"], 6.59),
]
DEFAULT_PARITY = "PARITY_H100.md"


def _median(v):
    s = sorted(v)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def build(rows) -> str:
    """The per-domain markdown table of the verified rows."""
    by_name: dict[str, list[dict]] = {}
    for r in rows:
        # csr / sell-xla rows are baselines, not the dispatched path
        if r.get("verified") is True and r["impl"] not in ("csr",
                                                           "sell-xla"):
            by_name.setdefault(r["name"], []).append(r)

    lines = [
        "| domain | matrix (stand-in) | impl | GFLOPS (median) | pack s"
        " (min/med) | runs | CVR on KNL | matrix ratio | domain (min) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    wins, ratios = 0, []

    def fmt_rows(domain, names, ref, counted):
        nonlocal wins
        out = []
        med_ratios = []
        for i, name in enumerate(names):
            rs = by_name.get(name)
            label = domain if i == 0 else ""
            if not rs:
                out.append(
                    f"| {label} | {name} | — | — | — | 0 | {ref} | — | |"
                )
                continue
            g = _median([r["gflops_2nnz"] for r in rs])
            packs = [r["preproc_s"] for r in rs]
            impls = {r["impl"] for r in rs}
            ratio = g / ref
            med_ratios.append(ratio)
            star = "**" if ratio >= 1.0 else ""
            out.append(
                f"| {label} | {name} ({rs[0]['nnz'] / 1e6:.1f}M nnz) | "
                f"{'/'.join(sorted(impls))} | {star}{g:.2f}{star} | "
                f"{min(packs):.2f}/{_median(packs):.2f} | {len(rs)} | "
                f"{ref} | {ratio:.2f}x | |"
            )
        if med_ratios:
            dom_ratio = min(med_ratios)
            if counted:
                ratios.append(dom_ratio)
                wins += dom_ratio >= 1.0
            star = "**" if dom_ratio >= 1.0 else ""
            # the domain's minimum in the first row's last column
            out[0] = out[0][:-2] + f" {star}{dom_ratio:.2f}x{star} |"
        return out

    for d, ns, ref in DOMAINS:
        lines.extend(fmt_rows(d, ns, ref, True))
    for d, ns, ref in EXTRAS:
        lines.extend(fmt_rows(d, ns, ref, False))
    geo = (
        math.exp(sum(math.log(r) for r in ratios) / len(ratios))
        if ratios
        else float("nan")
    )
    lines.append("")
    lines.append(
        f"**Score: {wins} of {len(DOMAINS)} paper domains won at the "
        f"per-domain MIN over >= 2 structurally distinct stand-ins** "
        f"(geomean of domain-min ratios {geo:.2f}x; extra rows are "
        "context, not counted).  Every matrix row is the median of its "
        "runs in the artifact named above; pack time is min/median over "
        "those runs on the single-core host."
    )
    return "\n".join(lines)


BEGIN = ("<!-- BEGIN MEASURED (generated by python -m "
         "cvr_tpu_torch.bench.parity) -->")
END = "<!-- END MEASURED -->"


def comm_block(rows, *, link_bw: float, links: int) -> str:
    """The comm-volume / weak-scaling table of the verified rows (the
    latest of each name) over ``links`` links of ``link_bw`` bytes/s."""
    from cvr_tpu_torch.parallel.comm_model import (
        comm_table,
        knee_devices,
        weak_scaling,
    )

    kw = dict(link_bw=link_bw, links=links, f_exp=0.35)
    latest = {}
    for r in rows:
        if r.get("ncols") and r.get("verified") is True:
            latest[r["name"]] = r
    crows = comm_table(list(latest.values()), D=8, **kw)
    lines = [
        "| domain | HBM MB/it | ICI MB/it @8 | E@8 blk/ovl | E@64 | "
        "D at 70% blk/ovl |",
        "|---|---|---|---|---|---|",
    ]
    for cr in crows:
        r = latest[cr.name]
        e64 = weak_scaling(cr.t_comp_s, int(r["ncols"]), 64, **kw)
        kb, ko = knee_devices(cr.t_comp_s, int(r["ncols"]), **kw)
        lines.append(
            f"| {cr.name} | {cr.stream_bytes / 1e6:.0f} | "
            f"{cr.gather_bytes / 1e6:.1f} | "
            f"{cr.eff_blocking:.2f}/{cr.eff_overlap:.2f} | "
            f"{e64[1]:.2f}/{e64[2]:.2f} | {kb}/{ko} |"
        )
    lines.append("")
    lines.append(
        "Model (cvr_tpu_torch/parallel/comm_model.py): per iteration a "
        "shard streams its plane bytes from device memory and receives "
        f"(D-1)/D of x over {links} links of {link_bw / 1e9:g} GB/s; the "
        "overlap column hides comm behind the expand pass (~35% of the "
        "pipeline, the ring path in parallel/dist_routed.py).  Past the "
        "70% knee the answer is a 2D row x col mesh (x sharded over the "
        "second axis)."
    )
    return "\n".join(lines)


def markdown(rows, source: str, *, link_bw: float, links: int) -> str:
    """The whole block between the BEGIN / END markers."""
    return (
        f"{BEGIN}\n\nSource artifact: `{source}`.\n\n{build(rows)}\n\n"
        f"Weak-scaling comm model (same artifact):\n\n"
        f"{comm_block(rows, link_bw=link_bw, links=links)}\n{END}"
    )


def splice(path: str | Path, table: str) -> None:
    """Put ``table`` between the BEGIN / END markers of ``path`` (after
    its text where it has none; a new file where it is missing)."""
    p = Path(path)
    text = p.read_text() if p.exists() else ""
    if BEGIN in text and END in text:
        pre = text.split(BEGIN)[0]
        post = text.split(END)[1]
        p.write_text(pre + table + post)
    else:
        p.write_text((text.rstrip() + "\n\n" if text else "") + table + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jsonl", nargs="?", default=DEFAULT_JSONL)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--parity", default=DEFAULT_PARITY)
    ap.add_argument("--link-bw", type=float, required=True,
                    help="bytes/s per link and direction (comm model)")
    ap.add_argument("--links", type=int, required=True,
                    help="links a device moves x over (comm model)")
    args = ap.parse_args(argv)

    with open(args.jsonl) as f:
        rows = [json.loads(line) for line in f]
    table = markdown(rows, Path(args.jsonl).name, link_bw=args.link_bw,
                     links=args.links)
    if not args.write:
        print(table)
        return 0
    splice(args.parity, table)
    print(f"wrote {args.parity}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
