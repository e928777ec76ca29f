"""The manifest, ``BENCHMARK.json``, and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's entry names its file, the traffic mix is
``traffic/<traffic>.json`` and each metric's reader is
``metrics/<metric>.py``, all found by name, so that a cell, a
configuration, a traffic mix or a metric is added by adding files and
entries.  ``check`` holds a manifest to the rules it keeps on names,
units, keys and counts.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of config ``name``, as a dict."""
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str, here: Path = HERE) -> dict:
    """The limits of the numbers a cell's run compares,
    ``limits/<cell>.json``, with the readings they were set from."""
    with open(here / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in the cells it lists."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def by_path(path: Path, kind: str):
    """The module in file ``path``, loaded by path (a name may hold dots)
    as ``benchmark_<kind>_<name>``."""
    name = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return by_path(here / "metrics" / f"{name}.py", "metric").read


def _line(s) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
            and "\t" not in s)


def check(manifest: dict, root: Path = ROOT) -> list[str]:
    """The manifest's faults against its rules on keys, names, units,
    counts and files; empty when it keeps them."""
    bad = []
    if set(manifest) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(manifest)}")
        return bad
    cmd, paths = manifest["command"], manifest["paths"]
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        bad.append("command")
    if not 1 <= len(paths) <= 16 or not all(
            PATH.fullmatch(p) and not p.startswith("/")
            and ".." not in p.split("/") for p in paths):
        bad.append("paths")
    rs = manifest["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        bad.append("run_seconds")

    def name_ok(n) -> bool:
        return isinstance(n, str) and NAME.fullmatch(n) is not None

    configs, cells = manifest["configs"], manifest["workloads"]
    e2e, layers = manifest["end_to_end"], manifest["per_layer"]
    for group, lo, hi in ((configs, 1, 24), (cells, 1, 24), (e2e, 1, 16),
                          (layers, 1, 128)):
        if not lo <= len(group) <= hi:
            bad.append(f"{len(group)} entries in a group of {lo}-{hi}")
    cfg_names = [c["name"] for c in configs]
    for c in configs:
        if set(c) != CONFIG_KEYS:
            bad.append(f"config {c.get('name')} keys {sorted(c)}")
            continue
        if not (name_ok(c["name"]) and _line(c["source"]) and _line(c["why"])
                and len(c["reduced"]) <= 16
                and all(name_ok(k) for k in c["reduced"])):
            bad.append(f"config {c['name']}")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            bad.append(f"config {c['name']}: file outside paths")
        elif not (root / c["file"]).is_file():
            bad.append(f"config {c['name']}: no file {c['file']}")
    if len(set(c["file"] for c in configs)) != len(configs):
        bad.append("two configs share a file")
    used = {c.get("config") for c in cells}
    bad += [f"config {n} used by no cell" for n in cfg_names if n not in used]
    pairs = set()
    for c in cells:
        if set(c) != CELL_KEYS:
            bad.append(f"cell {c.get('name')} keys {sorted(c)}")
            continue
        if not (name_ok(c["name"]) and name_ok(c["traffic"])
                and c["config"] in cfg_names and c["chips"] in (1, 4)
                and _line(c["why"])):
            bad.append(f"cell {c['name']}")
        pairs.add((c["config"], c["traffic"]))
    if len(pairs) != len(cells):
        bad.append("a pair of config and traffic appears twice")
    cell_names = [c["name"] for c in cells]
    e2e_names = [m["name"] for m in e2e]
    for m in e2e + layers:
        keys = E2E_KEYS if m in e2e else LAYER_KEYS
        if set(m) - {"workloads"} != keys:
            bad.append(f"metric {m.get('name')} keys {sorted(m)}")
            continue
        if not (name_ok(m["name"]) and UNIT.fullmatch(m["unit"])
                and m["better"] in ("lower", "higher")
                and m["source"] in SOURCES):
            bad.append(f"metric {m['name']}")
        if any(w not in cell_names for w in m.get("workloads", [])):
            bad.append(f"metric {m['name']}: unknown workload")
    for m in e2e:
        if m["source"] not in ("host_clock", "device_trace"):
            bad.append(f"metric {m['name']}: end-to-end source")
        if not 0.01 <= m.get("bound", -1) <= 0.25:
            bad.append(f"metric {m['name']}: bound")
    if "setup_s" not in e2e_names:
        bad.append("no setup_s")
    for m in layers:
        if not _line(m["layer"]) or m["moves"] not in e2e_names:
            bad.append(f"metric {m['name']}: layer or moves")
    for names in (cfg_names, cell_names, e2e_names + [m["name"]
                                                      for m in layers]):
        if len(set(names)) != len(names):
            bad.append(f"duplicate names among {names}")
    for c in cells:
        n = c["name"]
        ends = [m for m in metrics_of(manifest, n, False)]
        if "setup_s" not in [m["name"] for m in ends] or len(ends) < 2:
            bad.append(f"cell {n}: end-to-end metrics")
        mine = metrics_of(manifest, n, True)
        if not mine:
            bad.append(f"cell {n}: no per-layer metric")
        for m in mine:
            if m["moves"] not in [e["name"] for e in ends]:
                bad.append(f"cell {n}: {m['name']} moves a metric it lacks")
    return bad
