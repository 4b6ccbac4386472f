"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and one file each under this folder for a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``), a cell
(``cells/<name>.json``) and a per-layer metric (``metrics/<name>.py``, or
the reader of its quantity, ``spec.quantity``).
A cell, a configuration, a mix or a metric is added by adding its files
and its entry in ``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str, here: Path) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind != 'traffic' else kind} file {path}")
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """Is ``metric`` reported in ``cell``: listed under its ``workloads``,
    or in every cell where it lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One workload: its entry in BENCHMARK.json and the files it names."""

    name: str
    entry: dict        # the workloads entry: name, config, traffic, chips, why
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    params: dict       # cells/<name>.json: cycle counts, the main path, the limits
    end_to_end: list   # the end-to-end metric entries this cell reports
    per_layer: list    # the per-layer metric entries this cell reports

    def deck(self) -> dict:
        """The configuration's deck with the traffic's overrides, as run:
        {block: {key: value}}."""
        deck = {b: dict(kv) for b, kv in self.config["deck"].items()}
        for key, val in self.traffic.get("overrides", {}).items():
            block, k = key.rsplit("/", 1)
            deck.setdefault(block, {})[k] = val
        return deck

    def deck_text(self) -> str:
        """The deck in the input-file dialect both sides parse."""
        lines = []
        for block, kv in self.deck().items():
            lines.append(f"<{block}>")
            lines += [f"{k} = {_deck_value(v)}" for k, v in kv.items()]
            lines.append("")
        return "\n".join(lines)


def _deck_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v) if isinstance(v, float) else str(v)


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files found
    under ``here`` (this folder)."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(entries)})")
    return cell_from_entry(entries[name], bench, here)


def cell_from_entry(entry: dict, bench: dict, here: Path = HERE) -> Cell:
    """The cell of workload ``entry``, its files found under ``here``, with
    the metrics ``bench`` lists for it."""
    name = entry["name"]
    return Cell(name=name, entry=entry, config=_load_json("configs", entry["config"], here),
                traffic=_load_json("traffic", entry["traffic"], here),
                params=_load_json("cells", name, here),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def quantity(name: str) -> str:
    """The quantity a metric measures: its name up to the first dot.  The
    part after it names the cells' family, so that one quantity can move
    (or be bound for) different cells apart: ``device_idle_pct.rhd``
    measures ``device_idle_pct`` and moves the radiation cell's rate."""
    return name.split(".", 1)[0]


def metric_reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``, or where there
    is none, of the reader of its quantity, ``metrics/<quantity>.py``."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        path = here / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{path.stem}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path} for per-layer metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
