"""The benchmark's files: BENCHMARK.json against its contract, every file
it names, the data-driven layout, and the import rules."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from gpubench import layout

ROOT = layout.ROOT
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
TOP_KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'}
# What the harness reads of each module a configuration names.
DATASET = ('tables', 'port_bank', 'batch_keys', 'real', 'PHASE_A_OUTPUT',
           'compared_logits')
REFERENCE_DATASET = ('window_rows', 'loss', 'loss_count', 'empty_labels',
                     'compared_logits')
NETWORK = ('Arch', 'param_specs', 'trainable_names', 'head_features',
           'classify', 'dropout_shapes', 'draw_masks')
LAUNCHES = ('backbone_calls', 'head_calls', 'fbo_calls')


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH['paths']) <= 16
    for path in BENCH['paths']:
        assert re.match(r'^[A-Za-z0-9_.\-/]{1,200}$', path)
        assert (ROOT / path).is_dir() and not path.endswith('_torch')
    assert 1 <= len(BENCH['command']) <= 32
    assert all(line_ok(word) and not word.startswith('/') and '..' not in word
               for word in BENCH['command'])
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51


def test_entries_keys_names_and_units():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and line_ok(c['source'])
        assert line_ok(c['why']) and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith('gpubench/')
        assert (ROOT / c['file']).is_file()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        for key in ('name', 'config', 'traffic'):
            assert NAME.match(w[key])
        assert w['chips'] in (1, 4) and line_ok(w['why'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert line_ok(m['layer'])
    names = [x['name'] for x in BENCH['configs']]
    cells = [x['name'] for x in BENCH['workloads']]
    metrics = [x['name'] for x in BENCH['end_to_end'] + BENCH['per_layer']]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert set(names) == {w['config'] for w in BENCH['workloads']}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def reports(metric, cell):
    return cell in metric.get('workloads', [cell])


def test_every_cell_reports_enough_and_moves_are_reported():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for w in BENCH['workloads']:
        cell = w['name']
        own = [m['name'] for m in BENCH['end_to_end'] if reports(m, cell)]
        assert 'setup_s' in own and len(own) >= 2
        assert any(reports(m, cell) for m in BENCH['per_layer'])
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        for w in BENCH['workloads']:
            if reports(m, w['name']):
                assert reports(e2e[m['moves']], w['name']), (m['name'],
                                                             w['name'])


def test_every_named_file_parses():
    for cell in layout.cells():
        assert cell.config['name'] == next(
            w['config'] for w in BENCH['workloads'] if w['name'] == cell.name)
        assert layout.released_yaml(cell.config).is_file()
        assert set(cell.config['reduced']) <= set(cell.config['overrides'])
        assert cell.kind in ('two_phase', 'train')
        assert set(cell.limits['checks'])
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m['name']))
        for module, names in ((cell.dataset, DATASET),
                              (cell.reference_dataset, REFERENCE_DATASET),
                              (cell.network, NETWORK),
                              (cell.launches, LAUNCHES)):
            assert Path(module.__file__).is_relative_to(layout.HERE)
            for name in names:
                assert hasattr(module, name), (module.__file__, name)


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / 'gpubench').rglob('*'):
        if '__pycache__' in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_.\-/]+$', rel), rel


def test_added_files_are_found_without_editing_any(tmp_path):
    """A new configuration, mix, limits and metric, added as files to a
    copy, make a new cell that the harness finds by name."""
    shutil.copytree(ROOT / 'gpubench', tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    here = tmp_path / 'gpubench'
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((here / 'configs' / 'ava_r101_nl3l.json').read_text())
    config['name'] = 'ava_r101_nl3l_copy'
    (here / 'configs' / 'ava_r101_nl3l_copy.json').write_text(
        json.dumps(config))
    mix = json.loads((here / 'traffic' / 'two_phase.json').read_text())
    mix['pool'] = 2
    (here / 'traffic' / 'two_phase_small.json').write_text(json.dumps(mix))
    name = 'ava_r101_nl3l_copy.two_phase_small'
    shutil.copy(here / 'limits' / 'ava_r101_nl3l.two_phase.json',
                here / 'limits' / (name + '.json'))
    (here / 'metrics' / 'iterations_seen.py').write_text(
        'def read(record):\n    return float(record["iterations"])\n')
    bench['configs'].append({'name': 'ava_r101_nl3l_copy', 'source': 'x',
                             'file': 'gpubench/configs/'
                                     'ava_r101_nl3l_copy.json',
                             'reduced': [], 'why': 'a copy'})
    bench['workloads'].append({'name': name, 'config': 'ava_r101_nl3l_copy',
                               'traffic': 'two_phase_small', 'chips': 1,
                               'why': 'a copy'})
    bench['per_layer'].append({'name': 'iterations_seen', 'unit': 'n',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'steps', 'moves': 'setup_s',
                               'workloads': [name]})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = layout.cell(name, root=tmp_path, here=here)
    assert cell.traffic['pool'] == 2
    assert cell.config['name'] == 'ava_r101_nl3l_copy'
    assert [m['name'] for m in cell.per_layer] == ['iterations_seen']
    assert cell.metric_reader('iterations_seen')({'iterations': 3}) == 3.0


def digests(here: Path):
    return {path.relative_to(here).as_posix(): hashlib.sha256(
        path.read_bytes()).hexdigest() for path in sorted(here.rglob('*'))
        if path.is_file() and '__pycache__' not in path.parts}


@pytest.mark.parametrize('traffic', ('two_phase_fused', 'train'))
def test_a_new_dataset_and_network_are_new_files_only(tmp_path, traffic):
    """A configuration that names a dataset and a reference network of its
    own, added to a copy as new files (copies of Charades' two dataset
    modules, of the reference network and of its launch lists) and
    entries, makes cells of both kinds that the harness runs from the
    copy's modules to ``correct``, with the checks of the Charades cell
    (the same work, so the same numbers, to float32 rounding); no file
    the copy had changes."""
    import torch
    from gpubench import run
    from gpubench.tests.tiny import tiny_cell
    shutil.copytree(ROOT / 'gpubench', tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    here = tmp_path / 'gpubench'
    before = digests(here)
    for src, dst in (('datasets/charades.py', 'datasets/clipcopy.py'),
                     ('reference/datasets/charades.py',
                      'reference/datasets/clipcopy.py'),
                     ('reference/model.py', 'reference/model_copy.py'),
                     ('cost/model.py', 'cost/model_copy.py')):
        shutil.copy(here / src, here / dst)
    config = json.loads((here / 'configs' /
                         'charades_r101_nl.json').read_text())
    config.update(name='clipcopy_r101', dataset='clipcopy',
                  reference='model_copy')
    (here / 'configs' / 'clipcopy_r101.json').write_text(json.dumps(config))
    original = 'charades_r101_nl.' + traffic
    name = 'clipcopy_r101.' + traffic
    shutil.copy(here / 'limits' / (original + '.json'),
                here / 'limits' / (name + '.json'))
    bench = json.loads(json.dumps(BENCH))
    bench['configs'].append({'name': 'clipcopy_r101', 'source': 'x',
                             'file': 'gpubench/configs/clipcopy_r101.json',
                             'reduced': ['NUM_GPUS'], 'why': 'a copy'})
    bench['workloads'].append({'name': name, 'config': 'clipcopy_r101',
                               'traffic': traffic, 'chips': 1,
                               'why': 'a copy'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if original in m.get('workloads', []):
            m['workloads'].append(name)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        checks = {}
        for cell_name, root, cell_here in ((name, tmp_path, here),
                                           (original, ROOT, layout.HERE)):
            cell = tiny_cell(cell_name, root=root, here=cell_here)
            for module in (cell.dataset, cell.reference_dataset,
                           cell.network, cell.launches):
                assert Path(module.__file__).is_relative_to(cell_here)
            result, lines = run.run_cell(cell, 2 ** 40 + 17, 0.0, False,
                                         device='cpu',
                                         t_start=time.perf_counter())
            assert result['correct'], (cell_name, lines)
            checks[cell_name] = {k: v['value']
                                 for k, v in result['checks'].items()}
    finally:
        torch.set_num_threads(threads)
    assert checks[name] == pytest.approx(checks[original], rel=1e-6)
    after = digests(here)
    assert {k: after[k] for k in before} == before


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_jax_and_a_reference_apart_from_the_program():
    """Nothing under gpubench/ imports jax, jaxlib, flax or lfb_tpu (top
    names compared whole: lfb_tpu_torch is not lfb_tpu); the reference and
    the cost model import nothing of lfb_tpu_torch either."""
    here = ROOT / 'gpubench'
    apart = []
    for path in here.rglob('*.py'):
        tops = {name.split('.')[0] for name in _imports(path)}
        assert not tops & {'jax', 'jaxlib', 'flax', 'lfb_tpu'}, path
        rel = path.relative_to(here).parts
        if rel[0] in ('reference', 'cost', 'metrics') or \
                path.name == 'roofline.py':
            apart.append(rel)
            assert 'lfb_tpu_torch' not in tops, path
            assert 'chip_smoke' not in tops and 'bench' not in tops, path
    # Every configuration's reference side of its dataset, its network
    # and its launch lists are among the files held apart.
    for cell in layout.cells():
        for module in (cell.reference_dataset, cell.network, cell.launches):
            assert Path(module.__file__).relative_to(here).parts in apart


def test_import_rule_compares_whole_names():
    import sys
    from gpubench import run
    assert 'lfb_tpu_torch' not in run.FORBIDDEN
    sys.modules['lfb_tpu_torch_probe_x'] = object()
    try:
        assert 'lfb_tpu_torch_probe_x' not in run.forbidden_modules()
    finally:
        del sys.modules['lfb_tpu_torch_probe_x']


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of the first cell on a card (skips without one)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import time
    from gpubench import run
    cell = layout.cells()[0]
    result, lines = run.run_cell(cell, 20261018, 2.0, False,
                                 t_start=time.perf_counter())
    assert result['correct'], lines
