"""Where the benchmark's parts live, found by the names in
``BENCHMARK.json`` and in the configuration files:

  configs/<config>.json     one model configuration (its released YAML
                            under configs/released/, the overrides, the
                            architecture the reference reads, the bank's
                            count model, the batch contract, and the
                            names of its "dataset" and its "reference")
  traffic/<traffic>.json    one traffic mix (its kind and phases)
  limits/<cell>.json        the correctness limits of one cell
  metrics/<metric>.py       the reader of one per-layer metric
  datasets/<dataset>.py     a dataset's harness side: the bank's index
                            tables from the count model, the port's
                            device bank over them, a batch's keys and
                            labels, its real rows, phase A's output key
  reference/datasets/<dataset>.py
                            its reference side, apart from the program:
                            an example's window of bank rows, the loss
  reference/<reference>.py  a plain reference network (``Arch``,
                            ``param_specs``, ``trainable_names``,
                            ``head_features``, ``classify``,
                            ``dropout_shapes``, ``draw_masks``)
  cost/<reference>.py       that network's launches of the port's hand
                            kernels (``backbone_calls``, ``head_calls``,
                            ``fbo_calls``), costed by cost/kernels.py

A later change adds a cell, a mix, a metric, a dataset or a network by
adding files of these kinds; nothing here lists them.  Modules are loaded
by their path under the cell's directory, so a copy of this directory
finds its own.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
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
        self._modules: Dict[str, ModuleType] = {}

    @property
    def kind(self) -> str:
        return self.traffic['kind']

    def metric_reader(self, name: str):
        """The ``read(record)`` function of ``metrics/<name>.py``."""
        return load_file(self.here, 'metrics', name).read

    def module(self, *parts: str) -> ModuleType:
        """``<parts>.py`` under the cell's directory, loaded once a cell."""
        key = '/'.join(parts)
        if key not in self._modules:
            self._modules[key] = load_file(self.here, *parts)
        return self._modules[key]

    @property
    def dataset(self) -> ModuleType:
        """The harness side of the configuration's dataset."""
        return self.module('datasets', self.config['dataset'])

    @property
    def reference_dataset(self) -> ModuleType:
        """The reference side of the configuration's dataset."""
        return self.module('reference', 'datasets', self.config['dataset'])

    @property
    def network(self) -> ModuleType:
        """The configuration's plain reference network."""
        return self.module('reference', self.config['reference'])

    @property
    def launches(self) -> ModuleType:
        """The launch lists of the configuration's reference network."""
        return self.module('cost', self.config['reference'])


def load_file(here: Path, *parts: str) -> ModuleType:
    """Execute ``here/<parts>.py`` as a module of its own."""
    path = here.joinpath(*parts[:-1], parts[-1] + '.py')
    name = 'gpubench_' + '_'.join(parts).replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
