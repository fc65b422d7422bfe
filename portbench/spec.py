"""Resolve a cell of ``BENCHMARK.json`` to its files, by name."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cfftpack_tpu")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, kind: str):
    """Import the file ``path`` as a module of its own (metric files have
    dots in their names, so they are loaded by path, not by import)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = "portbench_" + kind + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    config: str
    traffic_name: str
    chips: int
    sizes: dict            # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # check name -> {"limit": ..., readings}
    builder: Path          # drives the program
    reference: Path        # the plain reference
    counts: Path           # ideal bytes of a call
    end_to_end: list       # the metric entries this cell reports
    per_layer: list
    root: Path

    def reader(self, metric: str) -> Path:
        return self.root / "portbench" / "metrics" / f"{metric}.py"


def resolve(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files: the
    end-to-end metrics whose ``workloads`` name it (or that have none),
    and the per-layer metrics whose ``workloads`` name it."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = root / conf["file"]
    pkg = root / "portbench"
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(
        name=name, config=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), sizes=load_json(cfg_file),
        traffic=load_json(pkg / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(pkg / "limits" / f"{name}.json"),
        builder=cfg_file.with_suffix(".py"),
        reference=cfg_file.with_name(cfg_file.stem + "_ref.py"),
        counts=pkg / "counts" / f"{w['config']}.py",
        end_to_end=e2e, per_layer=per, root=root)


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def every_cell(root: Path = REPO) -> list[str]:
    return [w["name"] for w in load_json(Path(root) / "BENCHMARK.json")
            ["workloads"]]
