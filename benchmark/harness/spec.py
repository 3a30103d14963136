"""The benchmark's table of contents: ``BENCHMARK.json`` and the files it
names, found by name.

Everything that belongs to one configuration, traffic mix, metric or
kernel sits in a file of its own under this folder:

- ``configs/<config>.json``: the configuration as it is run (the file that
  ``BENCHMARK.json`` names), with the ``driver`` that builds it and the
  ``reference`` that checks it;
- ``drivers/<driver>.py``: how a configuration is built from its file and
  which entry of the program the window drives;
- ``references/<reference>.py``: the plain reference;
- ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  one generator in ``harness/traffic.py``;
- ``metrics/<metric>.py``: the reader of one metric, ``read(run)`` (a
  metric split by the kind of cell, ``<base>.<kind>``, may share its
  base's reader);
- ``kernels/<kernel>.py``: one kernel's operations and bytes model.

A later change adds a cell, a configuration or a metric by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


def _load_module(kind, name):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def merged(base, overrides):
    """``base`` with ``overrides`` laid over it, nested dicts merged key by
    key (the tests shrink a configuration or a traffic mix this way)."""
    out = dict(base)
    for key, value in (overrides or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = value
    return out


class Spec:
    """``BENCHMARK.json`` and lookups by name into the benchmark's files."""

    def __init__(self, path=None):
        self.path = path or os.path.join(os.getcwd(), "BENCHMARK.json")
        self.root = os.path.dirname(os.path.abspath(self.path))
        self.data = _load_json(self.path)

    def workload(self, name):
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in {self.path}")

    def config(self, name):
        """The configuration's file, as run."""
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return _load_json(os.path.join(self.root, entry["file"]))
        raise KeyError(f"no configuration named {name!r} in {self.path}")

    def metrics(self, cell_name, section):
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
        the cell reports: those without ``workloads`` and those that list
        it."""
        return [m for m in self.data[section]
                if cell_name in m.get("workloads", [cell_name])]


def traffic(name):
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def driver(name):
    return _load_module("drivers", name)


def reference(name):
    return _load_module("references", name)


def metric_reader(name):
    """``metrics/<name>.py``, or for a metric split by the kind of cell,
    ``<base>.<kind>`` (such as ``dofs_solved_per_s.steps``), the base's
    reader ``metrics/<base>.py`` where the split has no file of its own."""
    base = name.split(".", 1)[0]
    if base != name and not os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{name}.py")):
        return _load_module("metrics", base)
    return _load_module("metrics", name)


def kernel_model(name):
    return _load_module("kernels", name)
