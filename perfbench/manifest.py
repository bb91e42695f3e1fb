"""The manifest (``BENCHMARK.json``) and the files it names.

Every cell, configuration, architecture, traffic mix and per-layer metric
is found by its name: a cell's ``workloads/<cell>.json``, its
configuration's file (the manifest's ``file``), the model file that the
configuration names (``models/<model>.py``: its tree, its counts and its
plain loss), its traffic's ``traffic/<traffic>.json`` and each per-layer
metric's reader ``metrics/<metric>.py``.  A later PR adds a cell, a
configuration, an architecture or a metric by adding such files and
entries.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_manifest", "load_cell",
           "check_manifest", "metric_reader", "model_module", "NAME_RE",
           "UNIT_RE"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of the manifest with every file it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict            # the configuration's file
    traffic_name: str
    traffic: dict           # traffic/<traffic>.json
    spec: dict              # workloads/<cell>.json: what only the harness
                            # reads (the manifest holds config, chips, why)
    end_to_end: tuple       # the manifest's metrics this cell reports
    per_layer: tuple
    model_path: Path        # models/<model>.py of the configuration

    @property
    def grid(self) -> tuple[int, int]:
        n, ppn = self.spec["grid"]
        return int(n), int(ppn)

    @property
    def model(self):
        """The configuration's model file, loaded (:func:`model_module`)."""
        return model_module(self.model_path)

    @property
    def specs(self) -> dict:
        """The weight tree's ``{path: (shape, dtype, scale)}``."""
        return self.model.leaf_specs(self.config)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _bench(root: Path) -> Path:
    """This folder in the checkout at ``root``."""
    return root / HERE.name


def _model_path(config: dict, root: Path) -> Path:
    return _bench(root) / "models" / f"{config['model']}.py"


def load_cell(name: str, manifest: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and spec, and
    the path of its configuration's model file (which must exist)."""
    manifest = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    model_path = _model_path(config, root)
    if not model_path.is_file():
        raise FileNotFoundError(f"{w['config']}: no model file {model_path}")
    traffic = _read_json(_bench(root) / "traffic" / f"{w['traffic']}.json")
    spec = _read_json(_bench(root) / "workloads" / f"{name}.json")
    n, ppn = spec["grid"]
    if n * ppn != w["chips"]:
        raise ValueError(f"{name}: a {n}x{ppn} grid on {w['chips']} chips")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        spec=spec,
        end_to_end=tuple(m for m in manifest["end_to_end"]
                         if _reports(m, name)),
        per_layer=tuple(m for m in manifest["per_layer"]
                        if _reports(m, name)),
        model_path=model_path,
    )


@functools.cache
def model_module(path: Path):
    """The model file at ``path``, loaded once a process: a module with
    ``leaf_specs(config)``, ``active_matmul_params(config)``,
    ``step_flops(config, rows, seq)`` and ``loss(params, batch, config,
    mm)``."""
    if not Path(path).is_file():
        raise FileNotFoundError(f"no model file {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_model_" + re.sub(r"\W", "_", Path(path).stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(trace_run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _line(text, what: str, problems: list) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or any(
            c in text for c in "\n\r\t"):
        problems.append(f"{what}: 1 to 200 characters on one line")


def check_manifest(manifest: dict, root: Path = ROOT) -> list[str]:
    """The manifest's breaches of the benchmark's rules on names, units,
    keys and files (an empty list when there are none)."""
    p: list[str] = []

    def name(v, what):
        if not isinstance(v, str) or not NAME_RE.match(v):
            p.append(f"{what}: bad name {v!r}")

    def unique(vals, what):
        dup = sorted({v for v in vals if vals.count(v) > 1})
        if dup:
            p.append(f"{what} named twice: {dup}")

    for c in manifest["configs"]:
        name(c["name"], "config")
        _line(c["source"], f"config {c['name']} source", p)
        _line(c["why"], f"config {c['name']} why", p)
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced key")
        if not (root / c["file"]).is_file():
            p.append(f"config {c['name']}: no file {c['file']}")
        else:
            model = _read_json(root / c["file"]).get("model")
            if not isinstance(model, str) or not NAME_RE.match(model):
                p.append(f"config {c['name']}: bad model {model!r}")
            elif not _model_path({"model": model}, root).is_file():
                p.append(f"config {c['name']}: no model file "
                         f"models/{model}.py")
    unique([c["name"] for c in manifest["configs"]], "configs")
    cfg_names = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        name(w["name"], "workload")
        name(w["traffic"], "traffic")
        _line(w["why"], f"workload {w['name']} why", p)
        if w["config"] not in cfg_names:
            p.append(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            p.append(f"workload {w['name']}: chips {w['chips']}")
        for f in (_bench(root) / "workloads" / f"{w['name']}.json",
                  _bench(root) / "traffic" / f"{w['traffic']}.json"):
            if not f.is_file():
                p.append(f"workload {w['name']}: no file {f.name}")
    unique([w["name"] for w in manifest["workloads"]], "workloads")
    unique([(w["config"], w["traffic"]) for w in manifest["workloads"]],
           "config and traffic pairs")
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            name(m["name"], group)
            if not UNIT_RE.match(m["unit"]):
                p.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                p.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                p.append(f"metric {m['name']}: source {m['source']!r}")
            for c in m.get("workloads", ()):
                if c not in cells:
                    p.append(f"metric {m['name']}: unknown cell {c}")
            if group == "end_to_end":
                if m["source"] not in ("host_clock", "device_trace"):
                    p.append(f"metric {m['name']}: an end-to-end metric "
                             "comes from host_clock or device_trace")
                if not 0.01 <= m["bound"] <= 0.25:
                    p.append(f"metric {m['name']}: bound {m['bound']}")
            else:
                _line(m["layer"], f"metric {m['name']} layer", p)
                if m["moves"] not in e2e:
                    p.append(f"metric {m['name']}: moves {m['moves']}")
                if not (_bench(root) / "metrics" /
                        f"{m['name']}.py").is_file():
                    p.append(f"metric {m['name']}: no reader")
    unique([m["name"] for g in ("end_to_end", "per_layer")
            for m in manifest[g]], "metrics")
    return p
