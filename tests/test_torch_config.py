"""The port's YAML-subset reader and config loader against PyYAML and
lfb_tpu on the CPU.

* ``lfb_tpu_torch.core.yaml_subset.load`` against ``yaml.safe_load`` on
  every released config (value and type, key by key) and on documents that
  ``yaml.safe_dump(default_flow_style=None, sort_keys=True)`` writes from
  generated nested dicts, and its refusals, each naming its line;
* ``lfb_tpu_torch.core.config.load_config`` against
  ``lfb_tpu.core.config.load_config`` on every released config, with and
  without CLI overrides, the probes that must raise, ``clone``;
* ``build_spec`` of both packages on every released config, in the test,
  bank-extraction and train phases;
* the port's configurations (``lfb_tpu_torch/config.py``) against the
  port's ``load_config`` of their YAMLs.
"""

import dataclasses
import glob
import os
import re

import pytest

pytest.importorskip('torch')
yaml = pytest.importorskip('yaml')

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu_torch import config as port_configs  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.core import yaml_subset  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, 'configs', '*.yaml')))


def config_path(name):
    return os.path.join(REPO, 'configs', name)


def assert_same(mine, theirs, where=''):
    """Equal values of the same types, dicts with the same keys in order."""
    assert type(mine) is type(theirs), (where, mine, theirs)
    if isinstance(theirs, dict):
        assert list(mine) == list(theirs), where
        for key in theirs:
            assert_same(mine[key], theirs[key], '{}.{}'.format(where, key))
    elif isinstance(theirs, list):
        assert len(mine) == len(theirs), where
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert_same(a, b, '{}[{}]'.format(where, i))
    else:
        assert mine == theirs, (where, mine, theirs)


def test_there_are_26_released_configs():
    assert len(CONFIGS) == 26


@pytest.mark.parametrize('name', CONFIGS)
def test_reader_matches_safe_load(name):
    with open(config_path(name)) as f:
        text = f.read()
    assert_same(yaml_subset.load(text), yaml.safe_load(text))


KEYS = st.text('ABCDEFGHIJKLMNOPQRSTUVWXYZ_0123456789', max_size=11).map(
    lambda s: 'K' + s)
SCALARS = st.one_of(
    st.booleans(), st.integers(-10 ** 12, 10 ** 12), st.none(),
    st.floats(allow_nan=False),
    st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=50),
    # Strings that only quoting keeps strings, and the configs' own.
    st.sampled_from(['', '.', 'data/epic/frames', 'steps_with_relative_lrs',
                     '1e-5', '1.0e5', '1.0e-05', 'yes', 'null', '~', '0x1F',
                     '017', '1:30', '-', '- a', 'a: b', '#x', "it's",
                     '2001-01-01', '<<', '=', ' a', 'a ', '[1]', '{a: 1}']))
VALUES = st.recursive(
    SCALARS, lambda inner: st.one_of(st.lists(SCALARS, max_size=12),
                                     st.dictionaries(KEYS, inner, max_size=8)),
    max_leaves=30)


@settings(max_examples=100, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.dictionaries(KEYS, VALUES, max_size=10))
def test_reader_reads_what_safe_dump_writes(doc):
    """Nested dicts of sections, flow lists and scalars, dumped as the
    released configs were (``tools/gen_configs.py``), long flow
    collections and strings continued over several lines."""
    text = yaml.safe_dump(doc, sort_keys=True, default_flow_style=None)
    assert_same(yaml_subset.load(text), yaml.safe_load(text))


REFUSED = {
    'tab': ('A: 1\nB:\t2\n', 2),
    'anchor': ('A: 1\nB: &x 2\n', 2),
    'alias': ('A: &x 1\n', 1),
    'alias use': ('A: 1\nB: {C: *x}\n', 2),
    'tag': ('A: !!str 1\n', 1),
    'document start': ('A: 1\n---\nB: 2\n', 2),
    'document end': ('A: 1\n...\n', 2),
    'directive': ('%YAML 1.1\nA: 1\n', 1),
    'block sequence': ('A: 1\nB:\n- 1\n- 2\n', 3),
    'literal block scalar': ('A: |\n  text\n', 1),
    'folded block scalar': ('A: 1\nB: >\n  text\n', 2),
    'duplicate key': ('A: 1\nB: 2\nA: 3\n', 3),
    'duplicate flow key': ('A: {B: 1,\n  B: 2}\n', 2),
    'complex key': ('? A\n: 1\n', 1),
    'escape': ('A: "x\\ty"\n', 1),
    'timestamp': ('A: 2001-12-14\n', 1),
    'mapping in a value': ('A: B: 1\n', 1),
    'blank line in a value': ('A: [1,\n\n  2]\n', 2),
    'unterminated flow': ('A: [1, 2\nB: 3\n', 1),
}


@pytest.mark.parametrize('construct', sorted(REFUSED))
def test_reader_refuses_what_is_outside_the_subset(construct):
    text, line = REFUSED[construct]
    with pytest.raises(ValueError, match=r'^line {}: '.format(line)):
        yaml_subset.load(text)


def test_reader_resolves_scalars_as_pyyaml():
    """The scalar forms of the configs and their near misses."""
    text = ('A: 1.0000001e-05\nB: 1e-5\nC: 1.0e5\nD: 1.25e-05\nE: .\n'
            "F: ''\nG: true\nH: False\nI: 16\nJ: -3\nK: 0.3\nL: .inf\n"
            'M: steps_with_relative_lrs\nN: data/epic/frames\nO: ~\nP:\n'
            'Q: 0x1F\nR: 017\nS: 1:30\nT: 1_000\nU: On\nV: +.5\n')
    assert_same(yaml_subset.load(text), yaml.safe_load(text))
    assert yaml_subset.load(text)['A'] == 1.0000001e-05
    assert yaml_subset.load(text)['B'] == '1e-5'


def flat(cfg, prefix=''):
    """{dotted.key: value} of a nested config."""
    out = {}
    for key, value in cfg.items():
        if isinstance(value, dict):
            out.update(flat(value, prefix + key + '.'))
        else:
            out[prefix + key] = value
    return out


def assert_same_config(mine, theirs):
    mine, theirs = flat(mine), flat(theirs)
    assert sorted(mine) == sorted(theirs)
    for key, value in theirs.items():
        assert_same(mine[key], value, key)


OPTS = ['NUM_GPUS', '1', 'TRAIN.BATCH_SIZE', '8', 'SOLVER.BASE_LR', '0.5',
        'SOLVER.LRS', '[1, 0.5]', 'MODEL.USE_BGR', 'True',
        'LFB.LOAD_LFB_PATH', 'data/lfb_x1', 'TPU.REMAT', "''",
        'LFB.WINDOW_SIZE', '7']


@pytest.mark.parametrize('name', CONFIGS)
def test_load_config_matches_lfb_tpu(name):
    path = config_path(name)
    for opts in ([], OPTS):
        mine = port_config.load_config(path, opts)
        assert isinstance(mine, port_config.AttrDict)
        assert_same_config(mine, jax_config.load_config(path, opts))
    assert mine.LFB.WINDOW_SIZE == 7 and mine.SOLVER.LRS == [1, 0.5]


def write(tmp_path, text):
    path = tmp_path / 'cfg.yaml'
    path.write_text(text)
    return str(path)


PROBES = {
    'unknown YAML key': (KeyError, 'NOT_A_KEY', lambda m, p: m.load_config(
        p('MODEL: {NOT_A_KEY: 1}\n'))),
    'type mismatch': (ValueError, 'TRAIN.BATCH_SIZE',
                      lambda m, p: m.load_config(None, ['TRAIN.BATCH_SIZE',
                                                        'abc'])),
    'bool mismatch': (ValueError, 'LFB.ENABLED',
                      lambda m, p: m.load_config(p('LFB: {ENABLED: 1}\n'))),
    'odd arity': (AssertionError, 'Specify values',
                  lambda m, p: m.load_config(None, ['NUM_GPUS'])),
    'unknown CLI key': (AssertionError, 'MODEL.NOPE',
                        lambda m, p: m.load_config(None, ['MODEL.NOPE', '1'])),
}


@pytest.mark.parametrize('probe', sorted(PROBES))
def test_probes_raise_as_in_lfb_tpu(probe, tmp_path):
    error, match, call = PROBES[probe]
    for module in (port_config, jax_config):
        with pytest.raises(error, match=re.escape(match)):
            call(module, lambda text: write(tmp_path, text))


def test_clone_does_not_alias():
    cfg = port_config.load_config(config_path('epic_verb_r50_lfb_nl.yaml'))
    new = port_config.clone(cfg, {'SOLVER.BASE_LR': 0.5})
    new.SOLVER.LRS.append(7)
    new.MODEL.NUM_CLASSES = 3
    assert cfg.SOLVER.BASE_LR == 0.001 and new.SOLVER.BASE_LR == 0.5
    assert cfg.SOLVER.LRS == [1, 0.1, 0.01] and cfg.MODEL.NUM_CLASSES == 125
    assert isinstance(new.SOLVER, port_config.AttrDict)


PHASES = {'test': ('test', {}), 'train': ('train', {}),
          'lfb_infer_only': ('test', {'lfb_infer_only': True})}


def assert_same_spec(spec, jspec):
    for field in dataclasses.fields(spec):
        mine, theirs = getattr(spec, field.name), getattr(jspec, field.name)
        if dataclasses.is_dataclass(mine):
            mine, theirs = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert mine == theirs, field.name


@pytest.mark.parametrize('phase', sorted(PHASES))
@pytest.mark.parametrize('name', CONFIGS)
def test_build_spec_matches_lfb_tpu(name, phase):
    """Every field of the port's spec, ``remat`` included (the YAMLs keep
    lfb_tpu's default 'stage')."""
    split, kwargs = PHASES[phase]
    cfg = port_config.load_config(config_path(name))
    jcfg = jax_config.load_config(config_path(name))
    spec = build_spec(cfg, split, **kwargs)
    assert_same_spec(spec, jax_models.build_spec(jcfg, split, **kwargs))
    assert spec.remat == 'stage'


# Every key the port reads (models/spec.py, train/, bank/) but TPU.REMAT,
# which the port's config helpers turn off (config.PORT_SETTINGS).
PORT_READS = {
    'DATASET': (), 'DATA_MEAN': (), 'DATA_STD': (),
    'TRAIN': ('VIDEO_LENGTH', 'CROP_SIZE', 'DROPOUT_RATE'),
    'TEST': ('VIDEO_LENGTH', 'CROP_SIZE'),
    'SOLVER': ('BASE_LR', 'LR_POLICY', 'LRS', 'STEP_SIZES', 'STEPS',
               'MAX_ITER', 'GAMMA', 'STEP_SIZE', 'MOMENTUM', 'NESTEROV',
               'WEIGHT_DECAY', 'WEIGHT_DECAY_BN', 'SCALE_MOMENTUM',
               'SCALE_MOMENTUM_THRESHOLD', 'WARMUP'),
    'MODEL': ('NUM_CLASSES', 'DEPTH', 'VIDEO_ARC_CHOICE', 'MULTI_LABEL',
              'USE_AFFINE', 'BN_EPSILON', 'BN_MOMENTUM', 'BN_INIT_GAMMA',
              'FC_INIT_STD', 'DILATIONS_AFTER_CONV5', 'FREEZE_BACKBONE',
              'USE_BGR'),
    'RESNETS': ('NUM_GROUPS', 'WIDTH_PER_GROUP'),
    'NONLOCAL': ('CONV_INIT_STD', 'NO_BIAS', 'USE_MAXPOOL', 'USE_SOFTMAX',
                 'USE_ZERO_INIT_CONV', 'USE_BN', 'USE_SCALE', 'USE_AFFINE',
                 'BN_EPSILON', 'BN_INIT_GAMMA', 'LAYER_MOD',
                 'CONV3_NONLOCAL', 'CONV4_NONLOCAL'),
    'LFB': ('ENABLED', 'FBO_TYPE', 'LFB_DIM', 'WINDOW_SIZE', 'LOAD_LFB',
            'LOAD_LFB_PATH'),
    'FBO_NL': ('NUM_LAYERS', 'PRE_ACT', 'PRE_ACT_LN', 'SCALE', 'LATENT_DIM',
               'INPUT_REDUCE_DIM', 'DROPOUT_RATE', 'INPUT_DROPOUT_ON',
               'LFB_DROPOUT_ON'),
    'ROI': ('SCALE_FACTOR', 'XFORM_RESOLUTION'),
    'AVA': ('LFB_MAX_NUM_FEAT_PER_STEP',),
    'CHARADES': ('FPS', 'LFB_CLIPS_PER_SECOND'),
    'EPIC': ('CLASS_TYPE', 'FPS', 'VERB_LFB_CLIPS_PER_SECOND',
             'NOUN_LFB_FRAMES_PER_SECOND', 'MAX_NUM_FEATS_PER_NOUN_LFB_FRAME'),
    'TPU': ('COMPUTE_DTYPE', 'PALLAS_BOTTLENECK', 'BANK_DTYPE', 'BANK_K_STORE',
            'BANK_MAX_PER_VIDEO', 'SHARD_MAP', 'BANK_SHARDED'),
}

PORT_CONFIGS = {
    'flagship': (port_configs.flagship_cfg, 'ava_r101_lfb_nl_3l.yaml'),
    'charades': (port_configs.charades_cfg, 'charades_r101_lfb_nl.yaml'),
    'epic_verb': (port_configs.epic_verb_cfg, 'epic_verb_r50_lfb_nl.yaml'),
    'epic_noun': (port_configs.epic_noun_cfg, 'epic_noun_r50_lfb_nl.yaml'),
}


@pytest.mark.parametrize('name', sorted(PORT_CONFIGS))
def test_port_configs_are_their_yamls(name):
    make, yaml_name = PORT_CONFIGS[name]
    mine = make()
    released = port_config.load_config(config_path(yaml_name))
    for section, keys in PORT_READS.items():
        for key in keys or (None,):
            a = mine[section] if key is None else mine[section][key]
            b = released[section] if key is None else released[section][key]
            assert a == b and type(a) is type(b), (section, key)
    assert mine.TPU.REMAT == '' and released.TPU.REMAT == 'stage'
    assert_same_spec(build_spec(mine, 'test'), dataclasses.replace(
        build_spec(released, 'test'), remat=''))
    if name.startswith('epic'):
        # Nothing but the port's settings and the caller's overrides.
        assert flat(mine) == {**flat(released), 'TPU.REMAT': ''}
        cfg = make({'NUM_GPUS': 1, 'TPU.PALLAS_BOTTLENECK': True})
        assert cfg.NUM_GPUS == 1 and cfg.TPU.PALLAS_BOTTLENECK
        with pytest.raises(ValueError, match='NUM_GPUS'):
            make({'NUM_GPUS': 'one'})
