"""Finds every part of a cell by its name.

- ``BENCHMARK.json`` at the repository's root lists the configurations,
  the cells (``workloads``) and the metrics;
- a configuration is the JSON file its entry names, and its FLOP counts
  are ``configs/<name>.py`` (a function ``flops(spec)``);
- a traffic mix is ``traffic/<traffic>.json``: the driver it runs on and
  its parameters;
- a cell's own numbers (its correctness limits, a serving rate) are
  ``cells/<cell>.json``;
- a driver is ``drivers/<driver>.py`` (a function ``run``);
- a per-layer metric is ``layer_metrics/<metric>.py`` (a function
  ``read(ctx)`` that returns a number, or None where it finds nothing).

So a later change adds a cell, a configuration or a metric as new files
and a new entry of ``BENCHMARK.json``, and edits none of these files.
"""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict



def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def _by_name(entries, name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench, name: str) -> Dict[str, Any]:
    return _by_name(bench["workloads"], name, "workload")


def spec(root: Path, name: str) -> Dict[str, Any]:
    """Everything a run of cell ``name`` needs, merged: the configuration
    (its file), ``traffic`` (the traffic mix's file), ``cell`` (the cell's
    file), the cell's entry and the metrics it reports."""
    bench = benchmark(root)
    cell = workload(bench, name)
    entry = _by_name(bench["configs"], cell["config"], "config")
    here = root / bench["paths"][0]
    conf = copy.deepcopy(_json(root / entry["file"]))
    conf["config_name"] = entry["name"]
    conf["bench_dir"] = str(here)
    conf["traffic"] = _json(here / "traffic" / f"{cell['traffic']}.json")
    conf["cell"] = _json(here / "cells" / f"{name}.json")
    conf["workload"] = cell
    conf["end_to_end"] = [m for m in bench["end_to_end"]
                          if name in m.get("workloads", [name])]
    conf["per_layer"] = [m for m in bench["per_layer"]
                         if name in m.get("workloads", [name])]
    return conf


def _module(path: Path, modname: str):
    s = importlib.util.spec_from_file_location(modname, path)
    if s is None or s.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def flops(conf) -> Dict[str, float]:
    """The configuration's FLOP counts per image (``configs/<name>.py``)."""
    mod = _module(Path(conf["bench_dir"]) / "configs"
                  / f"{conf['config_name']}.py",
                  f"bench_flops_{conf['config_name'].replace('.', '_')}")
    return mod.flops(conf)


def layer_metric(conf, name: str):
    """The reader of per-layer metric ``name``."""
    return _module(Path(conf["bench_dir"]) / "layer_metrics" / f"{name}.py",
                   f"bench_metric_{name.replace('.', '_')}").read


def driver(name: str):
    return importlib.import_module(f"drivers.{name}")
