"""What a cell is made of, read from files by name.

``BENCHMARK.json`` lists the cells (``workloads``), the configurations and
the metrics.  Everything of one cell sits in files of its own, found by
name, so that a new cell, configuration, traffic mix or metric is new files
and no edit:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives as the
  configuration's ``file``): the deployment, its scene, its frame size and
  the render path it runs (``render_path``, which the cell's must match);
- ``workloads/<cell>.json``: the render path and its settings, the frames
  the check compares and their limits, the work K2 has to do a frame;
- ``traffic/<traffic>.json``: the parameters of the camera the user flies,
  read by the one generator, ``lib/fly.py``;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``;
- ``inputs/<generator>.py``: a frozen scene generator, ``make(params, dir)``.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    workload: dict  # the cell's file
    traffic: dict  # the traffic mix's file
    end_to_end: tuple  # BENCHMARK.json's metric entries this cell reports
    per_layer: tuple


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell `name` of ``root/BENCHMARK.json``; raises KeyError for a
    cell the file does not list, ValueError for one whose path its
    configuration does not deploy."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    workload = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    if config.get("render_path", workload["path"]) != workload["path"]:
        raise ValueError(f"cell {name!r} renders the {workload['path']} path; its configuration "
                         f"{entry['config']!r} deploys the {config['render_path']} path")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, workload=workload,
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def load_module(path: Path, name: str):
    """A module from its file (metric readers and generators carry dots and
    dashes in their names, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def generator(name: str):
    """``inputs/<name>.py``'s ``make``."""
    return load_module(BENCH_DIR / "inputs" / f"{name}.py", f"portbench_input_{name}").make


def settings(cls, values: dict):
    """An instance of the settings dataclass `cls` from a mapping: nested
    settings as mappings, enums by name, every field not given at its
    default; a key `cls` has no field for raises."""
    defaults = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    kw = {}
    for name, v in values.items():
        d = getattr(defaults, name)
        if dataclasses.is_dataclass(d) and isinstance(v, dict):
            v = settings(type(d), v)
        elif isinstance(d, enum.Enum) and isinstance(v, str):
            v = type(d)[v]
        kw[name] = v
    return cls(**kw)


def render_config(config_module, config: dict, workload: dict):
    """A RenderConfig of `config_module` (the port's ``core.config``): the
    configuration's frame size and the cell's ``render_config`` settings."""
    values = {**workload["render_config"], "width": config["width"],
              "height": config["height"]}
    return settings(config_module.RenderConfig, values)
