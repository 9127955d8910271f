"""The config keys and defaults, and the loading of a config: the port's own
copy of ``lfb_tpu/core/config.py`` (``AttrDict`` / ``Config``,
``default_config``, the type-checked merges of a YAML file and of CLI
overrides, ``finalize``, ``clone`` and ``load_config``; reference
``lib/core/config.py``).

YAML files are read by :mod:`lfb_tpu_torch.core.yaml_subset`, which gives
the values PyYAML's ``safe_load`` gives for the released configs, so the
port needs no PyYAML.  The comments on the ``TPU.*`` keys describe
``lfb_tpu``'s use of them; the port reads ``TPU.COMPUTE_DTYPE``,
``TPU.PALLAS_BOTTLENECK``, ``TPU.REMAT`` and the bank keys.
``tests/test_torch_model.py`` and ``tests/test_torch_config.py`` hold this
copy to the original key by key.
"""

from __future__ import annotations

import copy
from ast import literal_eval
from typing import Any, Iterable

from lfb_tpu_torch.core import yaml_subset


class AttrDict(dict):
    """A dict whose entries are also attributes."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def from_nested(cls, d: dict) -> "AttrDict":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_nested(v) if isinstance(v, dict) else v
        return out


Config = AttrDict


def default_config() -> Config:
    """Build a fresh config populated with every supported key.

    Key inventory and defaults follow reference ``lib/core/config.py``.
    """
    c = AttrDict()
    c.DEBUG = False

    c.DATALOADER = AttrDict()
    # Retained for YAML compatibility; the reference never reads it either.
    c.DATALOADER.MAX_BAD_IMAGES = 100
    # lfb_tpu extensions: host pipeline parallelism.
    c.DATALOADER.NUM_WORKERS = 8
    c.DATALOADER.PREFETCH_BATCHES = 4

    c.DATA_MEAN = [0.45, 0.45, 0.45]
    c.DATA_STD = [0.225, 0.225, 0.225]

    c.TRAIN = AttrDict()
    c.TRAIN.PARAMS_FILE = ''
    c.TRAIN.DATA_TYPE = 'train'
    c.TRAIN.BATCH_SIZE = 64
    c.TRAIN.RESUME_FROM_BATCH_SIZE = -1
    c.TRAIN.RESET_START_ITER = False
    c.TRAIN.JITTER_SCALES = [256, 480]
    c.TRAIN.CROP_SIZE = 224
    c.TRAIN.USE_COLOR_AUGMENTATION = False
    c.TRAIN.PCA_JITTER_ONLY = True  # read (not defined!) in reference; defined here
    c.TRAIN.PCA_EIGVAL = [0.225, 0.224, 0.229]
    c.TRAIN.PCA_EIGVEC = [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203]]
    c.TRAIN.COMPUTE_PRECISE_BN = True
    c.TRAIN.ITER_COMPUTE_PRECISE_BN = 200
    c.TRAIN.EVAL_PERIOD = 4000
    c.TRAIN.DATASET_SIZE = 0
    c.TRAIN.VIDEO_LENGTH = 32
    c.TRAIN.SAMPLE_RATE = 2
    c.TRAIN.DROPOUT_RATE = 0.0
    c.TRAIN.TEST_AFTER_TRAIN = True

    c.MODEL = AttrDict()
    c.MODEL.NUM_CLASSES = -1
    c.MODEL.MODEL_NAME = ''
    c.MODEL.VIDEO_ARC_CHOICE = 2  # 1: C2D-R50, 2: I3D-R50, 3: C2D-R101, 4: I3D-R101
    c.MODEL.DEPTH = 50
    c.MODEL.BN_MOMENTUM = 0.9
    c.MODEL.BN_EPSILON = 1.0000001e-5
    c.MODEL.BN_INIT_GAMMA = 1.0
    c.MODEL.FC_INIT_STD = 0.01
    c.MODEL.MEAN = 114.75
    c.MODEL.STD = 57.375
    # In-place flags are meaningless under XLA (kept for YAML compat).
    c.MODEL.ALLOW_INPLACE_SUM = True
    c.MODEL.ALLOW_INPLACE_RELU = True
    c.MODEL.ALLOW_INPLACE_RESHAPE = True
    # MEMONGER=True maps to jax.checkpoint (rematerialization) on res-stages.
    c.MODEL.MEMONGER = True
    c.MODEL.USE_BGR = False
    c.MODEL.USE_AFFINE = False
    c.MODEL.SAMPLE_THREADS = 8
    c.MODEL.MULTI_LABEL = True
    c.MODEL.DILATIONS_AFTER_CONV5 = True
    c.MODEL.FREEZE_BACKBONE = False

    c.RESNETS = AttrDict()
    c.RESNETS.NUM_GROUPS = 1
    c.RESNETS.WIDTH_PER_GROUP = 64
    c.RESNETS.STRIDE_1X1 = False
    c.RESNETS.TRANS_FUNC = 'bottleneck_transformation_3d'

    c.TEST = AttrDict()
    c.TEST.PARAMS_FILE = ''
    c.TEST.DATA_TYPE = ''
    c.TEST.BATCH_SIZE = 64
    c.TEST.SCALE = 256
    c.TEST.CROP_SIZE = 256
    c.TEST.DATASET_SIZE = 0
    c.TEST.VIDEO_LENGTH = 32
    c.TEST.SAMPLE_RATE = 2
    c.TEST.CROP_SHIFT = 1  # 0: left, 1: center, 2: right

    c.SOLVER = AttrDict()
    c.SOLVER.NESTEROV = True
    c.SOLVER.WEIGHT_DECAY = 0.0001
    c.SOLVER.WEIGHT_DECAY_BN = 0.0001
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.LR_POLICY = 'steps_with_relative_lrs'
    c.SOLVER.BASE_LR = 0.1
    c.SOLVER.STEP_SIZES = [100000, 20000, 20000]
    c.SOLVER.LRS = [1, 0.1, 0.01]
    c.SOLVER.MAX_ITER = 140000
    c.SOLVER.STEPS = None
    c.SOLVER.STEP_SIZE = 0  # for LR_POLICY == 'step'
    c.SOLVER.GAMMA = 0.1
    c.SOLVER.SCALE_MOMENTUM = False
    c.SOLVER.SCALE_MOMENTUM_THRESHOLD = 1.1
    c.SOLVER.WARMUP = AttrDict()
    c.SOLVER.WARMUP.WARMUP_ON = False
    c.SOLVER.WARMUP.WARMUP_START_LR = 0.1
    c.SOLVER.WARMUP.WARMUP_END_ITER = 5000

    c.CHECKPOINT = AttrDict()
    c.CHECKPOINT.CHECKPOINT_MODEL = True
    c.CHECKPOINT.CHECKPOINT_PERIOD = -1
    c.CHECKPOINT.RESUME = True
    c.CHECKPOINT.DIR = '.'
    c.CHECKPOINT.CONVERT_MODEL = False

    c.NONLOCAL = AttrDict()
    c.NONLOCAL.CONV_INIT_STD = 0.01
    c.NONLOCAL.NO_BIAS = 0
    c.NONLOCAL.USE_MAXPOOL = True
    c.NONLOCAL.USE_SOFTMAX = True
    c.NONLOCAL.USE_ZERO_INIT_CONV = False
    c.NONLOCAL.USE_BN = True
    c.NONLOCAL.USE_SCALE = True
    c.NONLOCAL.USE_AFFINE = False
    c.NONLOCAL.BN_MOMENTUM = 0.9
    c.NONLOCAL.BN_EPSILON = 1.0000001e-5
    c.NONLOCAL.BN_INIT_GAMMA = 0.0
    c.NONLOCAL.LAYER_MOD = 2
    c.NONLOCAL.CONV3_NONLOCAL = True
    c.NONLOCAL.CONV4_NONLOCAL = True

    c.DATADIR = ''
    c.DATASET = ''
    c.ROOT_GPU_ID = 0  # YAML compat; unused on TPU
    c.NUM_GPUS = 8     # = number of data-parallel devices in the mesh
    c.CUDNN_WORKSPACE_LIMIT = 256  # YAML compat; unused on TPU
    c.RNG_SEED = 2
    c.USE_CYTHON = False
    c.LOG_PERIOD = 10
    c.PROF_DAG = False  # maps to jax.profiler traces
    c.INTERPOLATION = 'INTER_LINEAR'
    c.MINIBATCH_QUEUE_SIZE = 64

    c.AVA = AttrDict()
    c.AVA.FRAME_LIST_DIR = 'data/ava/frame_lists'
    c.AVA.ANNOTATION_DIR = 'data/ava/annotations'
    c.AVA.FPS = 30
    c.AVA.FULL_EVAL_DURING_TRAINING = False
    c.AVA.DETECTION_SCORE_THRESH_TRAIN = 0.9
    c.AVA.DETECTION_SCORE_THRESH_EVAL = [0.85]
    c.AVA.LFB_DETECTION_SCORE_THRESH = 0.9
    c.AVA.TRAIN_ON_TRAIN_VAL = False
    c.AVA.TEST_ON_TEST_SET = False
    c.AVA.TRAIN_LISTS = ['train.csv']
    c.AVA.TEST_LISTS = ['val.csv']
    c.AVA.TRAIN_BOX_LISTS = ['ava_train_v2.1.csv', 'ava_train_predicted_boxes.csv']
    c.AVA.TEST_BOX_LISTS = ['ava_val_predicted_boxes.csv']
    c.AVA.TRAIN_LFB_BOX_LISTS = ['ava_train_predicted_boxes.csv']
    c.AVA.TEST_LFB_BOX_LISTS = ['ava_val_predicted_boxes.csv']
    c.AVA.TEST_MULTI_CROP = False
    c.AVA.TEST_MULTI_CROP_SCALES = [224, 256, 320]
    c.AVA.FORCE_TEST_FLIP = False
    c.AVA.LFB_MAX_NUM_FEAT_PER_STEP = 5

    c.EPIC = AttrDict()
    c.EPIC.FRAME_LIST_DIR = 'data/epic/frame_lists'
    c.EPIC.ANNOTATION_DIR = 'data/epic/annotations'
    c.EPIC.TRAIN_LISTS = ['train.csv']
    c.EPIC.TEST_LISTS = ['val.csv']
    c.EPIC.ANNOTATIONS = 'EPIC_train_action_labels.csv'
    c.EPIC.FPS = 30
    c.EPIC.CLASS_TYPE = ''
    c.EPIC.VERB_LFB_CLIPS_PER_SECOND = 1
    c.EPIC.NOUN_LFB_FRAMES_PER_SECOND = 1
    c.EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME = 10

    c.CHARADES = AttrDict()
    c.CHARADES.FRAME_LIST_DIR = 'data/charades/frame_lists'
    c.CHARADES.TRAIN_LISTS = ['train.csv']
    c.CHARADES.TEST_LISTS = ['val.csv']
    c.CHARADES.FPS = 24
    c.CHARADES.NUM_TEST_CLIPS_DURING_TRAINING = 9
    c.CHARADES.NUM_TEST_CLIPS_FINAL_EVAL = 30
    c.CHARADES.LFB_CLIPS_PER_SECOND = 2

    c.ROI = AttrDict()
    c.ROI.SCALE_FACTOR = 16
    c.ROI.XFORM_RESOLUTION = 7

    c.LFB = AttrDict()
    c.LFB.ENABLED = False
    c.LFB.MODEL_PARAMS_FILE = ''
    c.LFB.WRITE_LFB = False
    c.LFB.LOAD_LFB = False
    c.LFB.LOAD_LFB_PATH = ''
    c.LFB.LFB_DIM = 2048
    c.LFB.WINDOW_SIZE = 100
    c.LFB.FBO_TYPE = 'nl'

    c.FBO_NL = AttrDict()
    c.FBO_NL.NUM_LAYERS = 2
    c.FBO_NL.PRE_ACT = True
    c.FBO_NL.PRE_ACT_LN = True
    c.FBO_NL.SCALE = True
    c.FBO_NL.LATENT_DIM = 512
    c.FBO_NL.INPUT_REDUCE_DIM = True
    c.FBO_NL.DROPOUT_RATE = 0.2
    c.FBO_NL.INPUT_DROPOUT_ON = True
    c.FBO_NL.LFB_DROPOUT_ON = True
    c.FBO_NL.NL_DROPOUT_ON = True

    c.IMG_LOAD_RETRY = 10
    c.GET_TRAIN_LFB = False  # YAML compat; lfb_tpu passes this explicitly

    # lfb_tpu extensions (TPU-specific knobs; all optional in YAML).
    c.TPU = AttrDict()
    c.TPU.COMPUTE_DTYPE = 'bfloat16'   # activations/matmul dtype
    c.TPU.PARAM_DTYPE = 'float32'      # master weights
    c.TPU.USE_PALLAS = True            # fused Pallas kernels where available
    # Pack the stem conv 2x2 into channels for MXU efficiency (1.8x faster
    # stem).  Off by default: the packed conv shape triggers nondeterministic
    # multi-minute compiles on some XLA:TPU remote-compile services.
    c.TPU.CONV1_SPACE_TO_DEPTH = False
    # Pallas stem kernel (ops/pallas_stem.py): VMEM-resident unfold with
    # one MXU pass for all 4 spatial taps; ~2.7x faster than the plain XLA
    # stem conv at B=16 on v5e and compiles deterministically (no conv
    # autotuning).  Used in training too via a custom VJP (XLA conv
    # backward).
    c.TPU.PALLAS_STEM = True
    # Fused identity-bottleneck kernel (ops/pallas_bottleneck.py): whole
    # residual block per (batch, frame) with intermediates in VMEM and the
    # frozen affine folded into the weights -- halves res-stage HBM traffic.
    # Off by default: measured on v5e it ties or slightly loses to the XLA
    # conv path (see BENCHMARKS.md "fused bottleneck experiment"); the
    # narrow bottleneck channels waste MXU lanes and the saved bandwidth
    # does not pay for the lost overlap.  Inference only; requires
    # MODEL.USE_AFFINE.
    c.TPU.PALLAS_BOTTLENECK = False
    c.TPU.REMAT = 'stage'              # '', 'stage', 'res2', or 'block' remat
    # Run the per-iteration forward/backward as an explicit shard_map body
    # instead of auto-sharded jit.  Numerically identical (loss sums/counts
    # psum into the exact global mean) and lets the fused Pallas kernels run
    # on multi-chip meshes.  Train path requires MODEL.USE_AFFINE.
    c.TPU.SHARD_MAP = False
    c.TPU.MESH_SHAPE = []              # e.g. [8] -> data mesh; [] -> all devices
    # Keep the LFB in HBM and gather windows on device instead of shipping
    # per-example windows through the input pipeline (parity-identical for
    # all datasets; EPIC-noun banks flatten ragged per-frame detector
    # features into repeated frame ids at build time).
    c.TPU.DEVICE_BANK = False
    # Ship raw uint8 crops from the host and normalize ((x/255-mean)/std +
    # BGR->RGB constant reorder) inside the jitted step: 4x less
    # host->device traffic and no host float math.  Automatically falls
    # back to the float host path when color augmentation is enabled.
    c.TPU.DEVICE_NORMALIZE = True
    # AVA device-bank index-table width per (video, sec).  0 (default)
    # auto-sizes to the largest feature count in the bank so window sampling
    # draws from ALL features, matching the host/reference sampler
    # (``ava.py:300-323``).  A positive value bounds table memory; overflow
    # entries are uniformly subsampled once at bank-build time.
    c.TPU.BANK_K_STORE = 0
    # Frame-level device banks (Charades / EPIC) auto-size their per-video
    # index tables to the single LONGEST video; this caps the per-video
    # entry count instead (0 = auto/store-all).  Videos over the cap get
    # their entries uniformly subsampled once at bank-build time.
    c.TPU.BANK_MAX_PER_VIDEO = 0
    # Row-shard the device bank's feature table over the data mesh axis:
    # per-chip bank HBM drops by the mesh size (the reference replicates
    # the 1-4 GB bank per process via the host pipeline); window gathers
    # are reassembled on-device with an index all_gather + reduce_scatter.
    # Requires TPU.SHARD_MAP (the feature shard enters the step body as an
    # explicit P('data') operand).
    c.TPU.BANK_SHARDED = False
    # Storage dtype for the HBM-resident device bank ('float32' or
    # 'bfloat16').  bfloat16 halves bank HBM (AVA: 3.3 GB -> 1.65 GB,
    # reference GETTING_STARTED.md:45) and matches the default bf16 FBO
    # compute dtype; the host pickle interchange stays float32 either way.
    c.TPU.BANK_DTYPE = 'float32'
    # Fixed-shape padding cap for AVA boxes (XLA needs static shapes; the
    # reference ships ragged per-box rows instead).  Keyframes with more
    # boxes than this are truncated with a warning.
    c.TPU.MAX_BOXES_PER_CLIP = 32

    return c


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce ``value`` to the type of the default ``old`` (with literal_eval
    of strings), enforcing type compatibility like reference
    ``config.py:394-420``."""
    if isinstance(value, str):
        try:
            value = literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if old is None or value is None:
        return value
    if isinstance(old, bool) is not isinstance(value, bool) and (
            isinstance(old, bool) or isinstance(value, bool)):
        raise ValueError('Type mismatch (bool) for config key: {}'.format(key))
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if type(old) is not type(value):
        # str defaults accept any str-able literal-eval failure case
        if isinstance(old, str) and isinstance(value, (bytes,)):
            return value.decode()
        raise ValueError('Type mismatch ({} vs. {}) for config key: {}'.format(
            type(old), type(value), key))
    return value


def merge_dict_into(cfg: Config, other: dict, prefix: str = '') -> None:
    """Recursively merge ``other`` into ``cfg``, type-checked."""
    for key, value in other.items():
        full = prefix + key
        if key not in cfg:
            raise KeyError('Invalid key in config file: {}'.format(full))
        if isinstance(value, dict):
            if not isinstance(cfg[key], AttrDict):
                raise ValueError('Config key {} is not a section'.format(full))
            merge_dict_into(cfg[key], value, full + '.')
        else:
            cfg[key] = _coerce(value, cfg[key], full)


def merge_cfg_from_file(cfg: Config, filename: str) -> None:
    """Merge the YAML file ``filename`` into ``cfg`` (read by
    :mod:`~lfb_tpu_torch.core.yaml_subset`)."""
    loaded = yaml_subset.load_file(filename)
    if loaded:
        merge_dict_into(cfg, loaded)


def merge_cfg_from_list(cfg: Config, args_list: Iterable[str]) -> None:
    """Apply dotted-key overrides, e.g. ['TRAIN.BATCH_SIZE', '16']."""
    args_list = list(args_list)
    assert len(args_list) % 2 == 0, 'Specify values or keys for args'
    for key, value in zip(args_list[0::2], args_list[1::2]):
        parts = key.split('.')
        node = cfg
        for subkey in parts[:-1]:
            assert subkey in node, 'Config key {} not found'.format(key)
            node = node[subkey]
        subkey = parts[-1]
        assert subkey in node, 'Config key {} not found'.format(key)
        node[subkey] = _coerce(value, node[subkey], key)


def finalize(cfg: Config) -> Config:
    """Compute derived keys + invariants (reference ``config.py:373-391``)."""
    if cfg.SOLVER.STEPS is None:
        steps = [0]
        for size in cfg.SOLVER.STEP_SIZES:
            steps.append(steps[-1] + size)
        cfg.SOLVER.STEPS = steps
    assert cfg.TRAIN.BATCH_SIZE % cfg.NUM_GPUS == 0, \
        'Train batch size should be multiple of num devices.'
    assert cfg.TEST.BATCH_SIZE % cfg.NUM_GPUS == 0, \
        'Test batch size should be multiple of num devices.'
    assert cfg.TPU.BANK_DTYPE in ('float32', 'bfloat16'), \
        "TPU.BANK_DTYPE must be 'float32' or 'bfloat16', got {!r}".format(
            cfg.TPU.BANK_DTYPE)
    assert not cfg.TPU.BANK_SHARDED or cfg.TPU.SHARD_MAP, \
        'TPU.BANK_SHARDED requires the explicit shard_map step (TPU.SHARD_MAP)'
    # Without a device bank there is nothing to shard: the dataset keeps a
    # host bank and BANK_SHARDED would silently do nothing.
    assert not cfg.TPU.BANK_SHARDED or cfg.TPU.DEVICE_BANK, \
        'TPU.BANK_SHARDED requires TPU.DEVICE_BANK (the HBM-resident bank)'
    # Only used by AVA: total bank-window entries per example.
    cfg.LFB.NUM_LFB_FEAT = (
        cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP * cfg.LFB.WINDOW_SIZE)
    return cfg


def clone(cfg: Config, overrides: dict | None = None) -> Config:
    """Deep-copy a config, optionally applying {dotted.key: value} overrides.

    This replaces the reference's pattern of mutating the global config
    between phases (e.g. multi-crop scale loops at
    ``tools/test_net.py:62-70``).
    """
    new = copy.deepcopy(cfg)
    if overrides:
        for key, value in overrides.items():
            parts = key.split('.')
            node = new
            for subkey in parts[:-1]:
                node = node[subkey]
            node[parts[-1]] = value
    return new


def load_config(config_file: str | None = None,
                opts: Iterable[str] = ()) -> Config:
    """Build a finalized config: defaults <- YAML <- CLI overrides."""
    cfg = default_config()
    if config_file:
        merge_cfg_from_file(cfg, config_file)
    if opts:
        merge_cfg_from_list(cfg, opts)
    return finalize(cfg)
