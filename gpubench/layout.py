"""Where the benchmark's parts live, found by the names in
``BENCHMARK.json``:

  configs/<config>.json     one model configuration (its released YAML
                            under configs/released/, the overrides, the
                            architecture the reference reads, the bank's
                            count model and the batch contract)
  traffic/<traffic>.json    one traffic mix (its kind and phases)
  limits/<cell>.json        the correctness limits of one cell
  metrics/<metric>.py       the reader of one per-layer metric

A later change adds a cell, a mix or a metric by adding files of these
kinds; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, bench: dict, entry: dict, here: Path = HERE):
        self.name = entry['name']
        self.chips = entry['chips']
        self.config = _read(here / 'configs' / (entry['config'] + '.json'))
        self.traffic = _read(here / 'traffic' / (entry['traffic'] + '.json'))
        self.limits = _read(here / 'limits' / (self.name + '.json'))
        self.end_to_end = [m for m in bench['end_to_end']
                           if self.name in m.get('workloads', [self.name])]
        self.per_layer = [m for m in bench['per_layer']
                          if self.name in m.get('workloads', [self.name])]
        self.here = here

    @property
    def kind(self) -> str:
        return self.traffic['kind']

    def metric_reader(self, name: str):
        """The ``read(record)`` function of ``metrics/<name>.py``."""
        path = self.here / 'metrics' / (name + '.py')
        spec = importlib.util.spec_from_file_location(
            'gpubench_metric_' + name.replace('.', '_').replace('-', '_'),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load(root: Path = ROOT) -> dict:
    return _read(root / 'BENCHMARK.json')


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load(root)
    for entry in bench['workloads']:
        if entry['name'] == name:
            return Cell(bench, entry, here)
    raise KeyError('no workload {!r} in {}'.format(
        name, root / 'BENCHMARK.json'))


def cells(root: Path = ROOT, here: Path = HERE) -> List[Cell]:
    bench = load(root)
    return [Cell(bench, entry, here) for entry in bench['workloads']]


def released_yaml(config: Dict, here: Path = HERE) -> Path:
    return here / config['released_yaml']
