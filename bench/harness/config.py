"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration lives in ``configs/<name>.json``, the traffic mix in
``traffic/<name>.json`` and each metric's reader in ``metrics/<name>.py``,
all under the benchmark's folder.  The configuration names its builder
and its reference (files under the folder); the traffic names its loop
(``loops/<name>.py``), its input generator (``generators/<name>.py``) and,
where it has one, its arrival process (``arrivals/<name>.py``).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<name>.json
    traffic: dict       # traffic/<name>.json
    end_to_end: list    # BENCHMARK.json metrics this cell reports
    per_layer: list


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    config = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in names
                 and ("workloads" not in m or name in m["workloads"])]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def load_path(rel: str):
    """The module in the file ``rel`` (a path under the benchmark's
    folder), loaded once per process."""
    path = (BENCH_DIR / rel).resolve()
    if BENCH_DIR not in path.parents or path.suffix != ".py":
        raise SystemExit(f"{rel!r} is not a Python file under {BENCH_DIR}")
    key = "bench_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("")
                              .parts).replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        if not path.is_file():
            raise SystemExit(f"no file {rel!r} under {BENCH_DIR}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder: a loop, a
    generator, an arrival process or a metric's reader."""
    return load_path(f"{kind}/{name}.py")
