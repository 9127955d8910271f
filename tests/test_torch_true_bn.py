"""True-BN training in the port (``MODEL.USE_AFFINE False``, batch
statistics) against lfb_tpu on the CPU.

The model is ``tests/test_torch_parallel.py``'s: the flagship arc cut to R50
arc 2 with 8 channels a group, T 4, crop 32, f32, dropout off, 2 box rows a
clip, on global batches of 4 clips with host windows.  Two BN modes:

* 'all': ``MODEL.USE_AFFINE False`` with ``NONLOCAL.USE_BN True`` /
  ``NONLOCAL.USE_AFFINE False`` (``lfb_tpu``'s defaults): every BN layer
  normalizes with the batch's statistics and records them;
* 'mixed': the frozen affine in the backbone with true-BN non-local blocks:
  those normalize with batch statistics, but, as in ``lfb_tpu``, no
  'bn_updates' exist and their running statistics never move.

The params are seeded perturbed ones, but the BN layers that end a residual
branch get scales near 0, as the reference's init has them
(:func:`true_bn_params`).  A random deep BN net is chaotic (its gradients
explode at init): a perturbation of 5e-7 of the params moved some gradients
by 1e-2 of their largest value, and a gap of one step's rounding grows
step by step, faster the more ReLU inputs sit near 0 as batch statistics
put them (lfb_tpu's own one-device and two-device runs parted by hundreds
of times the bounds below after 3 steps; so did the port at 2 and 8
threads).  So each step is compared from the same state, lfb_tpu's state
before it (teacher forcing): the running statistics, momentum and LR of
later steps are exercised, one step's rounding at a time.

Bounds, relative to the largest lfb_tpu value of each tensor unless
stated: ``apply_norm``'s output, statistics and gradients 1e-6 in f32 (one
bf16 step, 2^-8, for the bf16 output); the forward's statistics and prob
1e-5; each of three train steps (:func:`assert_step_close`) the loss rtol
1e-5, the prob 1e-5, the running statistics elementwise rtol 1e-4, atol
1e-6, the first step's params and momentum elementwise too, a later step's
as a whole (relative L2 1e-2; a ReLU gate at 0 to rounding flips in one
package and not the other).

Two gloo ranks (``tests/torch_parallel_ranks.py``, case ``true_bn``) take
the global batch's statistics: their first two steps, from the same states,
against ``lfb_tpu``'s one-device step, its auto-sharded step on a 2-device
mesh (XLA inserts the collectives of the batch statistics) and the port in
one process, at the same bounds (the probs on the valid box rows: padding
rows read another clip once a rank localises them), every rank holding the
same params, momentum and running statistics; precise BN over the ranks'
shards against one process, 1e-5.
"""

import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.models import model as jax_model  # noqa: E402
from lfb_tpu.models.layers import apply_norm as jax_apply_norm  # noqa: E402
from lfb_tpu.parallel import create_mesh  # noqa: E402
from lfb_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from lfb_tpu.train import optimizer as jax_opt  # noqa: E402
from lfb_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from lfb_tpu.train.steps import split_params as jax_split_params  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.models import model as port_model  # noqa: E402
from lfb_tpu_torch.models.layers import apply_norm  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train.precise_bn import compute_precise_bn_stats  # noqa: E402
from lfb_tpu_torch.train.steps import make_train_step, split_params  # noqa: E402
from tests import torch_parallel_ranks  # noqa: E402
from tests.test_torch_model import perturbed_params  # noqa: E402
from tests.test_torch_parallel import BOX_MASK, CFG, WORLD, ava_batch  # noqa: E402
from tests.test_torch_trainer import count_calls  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

MODES = {'all': {'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_BN': True,
                 'NONLOCAL.USE_AFFINE': False},
         'mixed': {'NONLOCAL.USE_BN': True, 'NONLOCAL.USE_AFFINE': False}}
LRS = (0.01, 0.02, 0.02)             # three steps
RANK_STEPS = 2                       # the ranks take the first two


def close(got, ref, tol):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def to_np(t):
    return t.detach().float().numpy()


def true_bn_params(jspec, rng):
    """:func:`perturbed_params` with the scales of the BN layers that end a
    residual branch (``*_branch2c_bn_s``, the non-local blocks' ``*_bn_s``)
    drawn near 0 (x 0.02), where the reference starts them
    (``MODEL.BN_INIT_GAMMA`` and ``NONLOCAL.BN_INIT_GAMMA`` 0)."""
    params = perturbed_params(jspec, rng)
    for name in params:
        if name.endswith('_branch2c_bn_s') or (
                name.startswith('nonlocal_') and name.endswith('_bn_s')):
            params[name] = params[name] * np.float32(0.02)
    return params


@pytest.fixture(scope='module')
def inputs():
    """Per mode: the cfg overrides, lfb_tpu-layout params; the batches."""
    rng = np.random.RandomState(4)
    out = {'cfg': CFG, 'true_bn_modes': MODES, 'true_bn_params': {},
           'true_bn_lrs': LRS[:RANK_STEPS]}
    for mode, overrides in MODES.items():
        jspec = jax_models.build_spec(
            flagship_cfg({**CFG, **overrides}), 'train')
        out['true_bn_params'][mode] = true_bn_params(jspec, rng)
    out['batch'] = ava_batch(rng, jspec)
    out['precise_bn_batches'] = [ava_batch(rng, jspec, labels=False)
                                 for _ in range(2)]
    return out


# --------------------------------------------------------------------------- #
# apply_norm and the forward's statistics
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_apply_norm_in_training_matches_lfb_tpu(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 5, 4, 16) * 2 + 1).astype('f')
    scale, bias = rng.randn(16).astype('f'), rng.randn(16).astype('f')
    weight = rng.randn(*x.shape).astype('f')

    def jloss(x, scale, bias):
        updates = {}
        y = jax_apply_norm({'n_bn_s': scale, 'n_bn_b': bias}, 'n_bn', x,
                           use_affine=False, train=True, epsilon=1e-5,
                           bn_updates=updates)
        return jnp.sum(y.astype(jnp.float32) * weight), (y, updates)

    jx = jnp.asarray(x).astype(dtype)
    (_, (jy, jupdates)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jx, jnp.asarray(scale),
                                                jnp.asarray(bias))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    updates = {}
    y = apply_norm({'n_bn_s': ts, 'n_bn_b': tb}, 'n_bn', tx, use_affine=False,
                   epsilon=1e-5, train=True, bn_updates=updates)
    (y.float() * torch.from_numpy(weight)).sum().backward()
    assert y.dtype == tx.dtype and list(updates) == list(jupdates) == ['n_bn']
    close(to_np(y), np.asarray(jy, np.float32),
          1e-6 if dtype == 'float32' else 2 ** -8)
    for got, want in zip(updates['n_bn'], jupdates['n_bn']):
        assert got.dtype == torch.float32
        close(to_np(got), want, 1e-6)
    if dtype == 'float32':
        for got, want in zip((tx.grad, ts.grad, tb.grad), jgrads):
            close(to_np(got), want, 1e-6)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_forward_bn_updates_match_lfb_tpu(inputs, mode):
    """The train-mode forward's 'bn_updates': the same layer names, and
    each (mean, var) within 1e-5; none in the mixed case, as lfb_tpu."""
    cfg = flagship_cfg({**CFG, **MODES[mode]})
    jspec = jax_models.build_spec(cfg, 'train')
    params = inputs['true_bn_params'][mode]
    batch = {k: v for k, v in inputs['batch'].items() if k != 'labels'}
    ref = jax.jit(lambda p, b: jax_model.forward(
        jspec, p, b, train=True, rng=jax.random.PRNGKey(0)))(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = port_model.forward(
            build_spec(cfg, 'train'), params_from_jax(params, device='cpu'),
            {k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
            generator=torch.Generator().manual_seed(0))
    close(to_np(out['prob']), ref['prob'], 1e-5)
    if mode == 'mixed':
        assert 'bn_updates' not in out and 'bn_updates' not in ref
        return
    assert sorted(out['bn_updates']) == sorted(ref['bn_updates'])
    assert len(out['bn_updates']) == sum(
        k.endswith('_bn_rm') for k in params)
    for name, stats in out['bn_updates'].items():
        for got, want in zip(stats, ref['bn_updates'][name]):
            close(to_np(got), want, 1e-5)


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #

def initial_state(cfg, params):
    """lfb_tpu's split of ``params`` (its layout) into (trainable, frozen)
    and zero momentum: the state (trainable, frozen, momentum) the steps
    start from, numpy arrays in lfb_tpu's layout."""
    jspec = jax_models.build_spec(cfg, 'train')
    frozen_names = jax_model.frozen_param_names(jspec, params)
    return ({k: v for k, v in params.items() if k not in frozen_names},
            {k: v for k, v in params.items() if k in frozen_names},
            {k: np.zeros_like(v) for k, v in params.items()
             if k not in frozen_names})


def copies(tensors):
    return {k: np.array(v) for k, v in tensors.items()}


def port_step(step, state, batch, seed, lr):
    """One step of the port's ``step`` in this process from ``state``:
    (loss, prob, trainable, momentum, frozen), lfb_tpu's layout."""
    trainable, frozen, momentum = (params_from_jax(d, device='cpu')
                                   for d in state)
    trainable, frozen, mstate, aux = step(
        trainable, frozen, opt.SGDState(momentum=momentum),
        torch_parallel_ranks.tensors(batch),
        torch.Generator().manual_seed(seed), lr)
    return (aux['loss'].item(), aux['prob'].numpy().copy(),
            copies(params_to_jax(trainable)),
            copies(params_to_jax(mstate.momentum)),
            copies(params_to_jax(frozen)))


def jax_step(step, state, batch, seed, lr, mesh=None):
    """One step of lfb_tpu's (non-shard_map) ``step`` from ``state``, on
    ``mesh`` when given, as :func:`port_step`."""
    trainable, frozen, momentum = ({k: jnp.asarray(v) for k, v in d.items()}
                                   for d in state)
    feed = (jax_shard_batch(mesh, batch) if mesh is not None
            else {k: jnp.asarray(v) for k, v in batch.items()})
    trainable, frozen, mstate, aux = step(
        trainable, frozen, jax_opt.SGDState(momentum=momentum), feed,
        jax.random.PRNGKey(seed), jnp.float32(lr))
    return (float(aux['loss']), np.asarray(aux['prob']), copies(trainable),
            copies(mstate.momentum), copies(frozen))


def next_state(result):
    """The (trainable, frozen, momentum) state after a step's result."""
    return result[2], result[4], result[3]


def rel_l2(got, ref, base=None):
    """The relative L2 distance of the tensors ``got`` from ``ref`` (less
    ``base``, when given), over all of them at once."""
    base = base or {k: 0.0 for k in ref}
    num = sum(np.square((got[k] - base[k]) - (ref[k] - base[k]),
                        dtype=np.float64).sum() for k in ref)
    return np.sqrt(num / sum(np.square(ref[k] - base[k], dtype=np.float64)
                             .sum() for k in ref))


def assert_step_close(got, ref, state, rows=slice(None)):
    """One step from ``state``: ``got`` against ``ref`` (both (loss, prob,
    params, momentum, frozen) in lfb_tpu's layout).  The loss rtol 1e-5,
    the prob's ``rows`` 1e-5 of the largest, the running statistics rtol
    1e-4, atol 1e-6.  The params and momentum of a first step (zero
    momentum) rtol 1e-4, atol 1e-6; of a later one their relative L2
    distance, the params' update's and the momentum's, 1e-2: a ReLU input
    that sits at 0 to rounding flips its gate in one package and not the
    other, and at res5's 32 positions a channel then moves by a thirtieth
    (1.9e-3 and 2.3e-3 in the second step here; a wrong statistic or
    gradient moves them by their own scale)."""
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    close(got[1][rows], ref[1][rows], 1e-5)
    for mine, theirs in zip(got[2:], ref[2:]):
        assert set(mine) == set(theirs)
    for name, value in ref[4].items():
        np.testing.assert_allclose(got[4][name], value, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    if not any(v.any() for v in state[2].values()):
        for mine, theirs in zip(got[2:4], ref[2:4]):
            for name in theirs:
                np.testing.assert_allclose(mine[name], theirs[name],
                                           rtol=1e-4, atol=1e-6, err_msg=name)
        return
    assert rel_l2(got[2], ref[2], state[0]) <= 1e-2
    assert rel_l2(got[3], ref[3]) <= 1e-2


@pytest.fixture(scope='module')
def steps(inputs):
    """Per mode, len(LRS) steps of lfb_tpu's step from the initial state,
    each state in turn; beside each, the port's step from the same state
    (teacher forcing: each step starts both packages from lfb_tpu's state
    before it, so a comparison holds one step's rounding, not the gaps the
    steps before it left, which a deep BN net amplifies).  [(the state
    before, lfb_tpu's step, the port's step)] per mode."""
    out = {}
    for mode, overrides in MODES.items():
        cfg = flagship_cfg({**CFG, **overrides})
        jstep = jax_make_train_step(jax_models.build_spec(cfg, 'train'),
                                    cfg.SOLVER, None)
        step = make_train_step(build_spec(cfg, 'train'), cfg.SOLVER)
        state = initial_state(cfg, inputs['true_bn_params'][mode])
        out[mode] = []
        for i, lr in enumerate(LRS):
            ref = jax_step(jstep, state, inputs['batch'], i, lr)
            out[mode].append((state, ref,
                              port_step(step, state, inputs['batch'], i, lr)))
            state = next_state(ref)
    return out


@pytest.mark.parametrize('mode', sorted(MODES))
def test_three_steps_match_lfb_tpu(inputs, steps, mode):
    """Each of three steps (LRs 0.01, 0.02, 0.02) from lfb_tpu's state
    before it: the running statistics move every step by BN_MOMENTUM from
    the last ones, and in the mixed case never (as in lfb_tpu)."""
    initial = inputs['true_bn_params'][mode]
    for state, ref, got in steps[mode]:
        assert_step_close(got, ref, state)
        for name, value in got[4].items():
            if name.endswith(('_rm', '_riv')):
                moved = not np.array_equal(value, state[1][name])
                assert moved == (mode == 'all'), name
                if mode == 'mixed':
                    np.testing.assert_array_equal(value, initial[name])
    got = steps[mode][0][2]
    assert np.abs(got[3]['conv1_w']).max() > 0
    if mode == 'all':      # the BN scale and bias train under true BN
        assert np.abs(got[3]['res2_0_branch2a_bn_s']).max() > 0
        assert np.abs(got[3]['nonlocal_conv3_1_bn_b']).max() > 0


@pytest.mark.parametrize('mode', sorted(MODES))
def test_remat_under_true_bn(inputs, mode, monkeypatch):
    """``TPU.REMAT 'stage'`` recomputes nothing in true-BN training (8
    attention forwards a step, as under '', and the same steps bitwise);
    in the mixed case it stays on (13: res3 and res4 run again, their
    non-local blocks deriving the same batch statistics)."""
    results = {}
    for remat in ('', 'stage'):
        cfg = flagship_cfg({**CFG, **MODES[mode], 'TPU.REMAT': remat})
        spec = build_spec(cfg, 'train')
        assert spec.remat == remat
        step = make_train_step(spec, cfg.SOLVER)
        state = initial_state(cfg, inputs['true_bn_params'][mode])
        runs = []
        with monkeypatch.context() as m:
            calls = count_calls(m)
            for i, lr in enumerate(LRS):
                runs.append(port_step(step, state, inputs['batch'], i, lr))
                state = next_state(runs[-1])
        results[remat] = runs, dict(calls)
    steps = len(LRS)
    assert results['stage'][1]['attention'] == (8 * steps if mode == 'all'
                                                else 13 * steps)
    assert results[''][1]['attention'] == 8 * steps
    for plain, stage in zip(results[''][0], results['stage'][0]):
        assert plain[0] == stage[0]
        for a, b in zip(plain[2:], stage[2:]):
            for name in a:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# --------------------------------------------------------------------------- #
# Two gloo ranks: global batch statistics
# --------------------------------------------------------------------------- #

@pytest.fixture(scope='module')
def ranks(tmp_path_factory, inputs, steps):
    """[rank 0's results, rank 1's] of case ``true_bn``: a step from the
    initial state and one from lfb_tpu's state after the first step, per
    mode."""
    root = tmp_path_factory.mktemp('true_bn_ranks')
    with open(root / 'inputs.pkl', 'wb') as f:
        pickle.dump({**inputs, 'true_bn_states': {
            mode: [state for state, _, _ in runs[:RANK_STEPS]]
            for mode, runs in steps.items()}}, f)
    torch.multiprocessing.start_processes(
        torch_parallel_ranks.main, args=(WORLD, str(root), ('true_bn',)),
        nprocs=WORLD, start_method='spawn')
    results = []
    for r in range(WORLD):
        with open(root / 'rank{}.pkl'.format(r), 'rb') as f:
            results.append(pickle.load(f)['true_bn'])
    shutil.rmtree(root)         # about 0.5 GB of params and momentum
    return results


def rank_step(result):
    """A rank's step in lfb_tpu's layout, as :func:`port_step`."""
    def jax_layout(d):
        return params_to_jax({k: torch.from_numpy(v) for k, v in d.items()})
    return (result['loss'], result['prob'], jax_layout(result['params']),
            jax_layout(result['momentum']), jax_layout(result['frozen']))


@pytest.mark.parametrize('mode', sorted(MODES))
def test_two_ranks_match_lfb_tpu(steps, ranks, mode):
    """Both steps of the ranks against lfb_tpu's one-device step from the
    same state, which takes the global batch's statistics."""
    for k in range(RANK_STEPS):
        state, ref, _ = steps[mode][k]
        assert_step_close(rank_step(ranks[0][mode, k]), ref, state,
                          rows=BOX_MASK > 0)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_two_ranks_match_lfb_tpus_mesh_step(inputs, steps, ranks, mode):
    """lfb_tpu's auto-sharded step on a 2-device mesh, where XLA inserts
    the collectives of the batch statistics, from the same states."""
    cfg = flagship_cfg({**CFG, **MODES[mode]})
    mesh = create_mesh(WORLD)
    jstep = jax_make_train_step(jax_models.build_spec(cfg, 'train'),
                                cfg.SOLVER, mesh)
    for k in range(RANK_STEPS):
        state = steps[mode][k][0]
        ref = jax_step(jstep, state, inputs['batch'], k, LRS[k], mesh)
        assert_step_close(rank_step(ranks[0][mode, k]), ref, state,
                          rows=BOX_MASK > 0)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_two_ranks_match_one_process(steps, ranks, mode):
    """Against the port's step in one process from the same states (the
    valid box rows of the prob: a rank's padding rows read another clip
    once localised), every rank holding the same results."""
    for k in range(RANK_STEPS):
        state, _, one = steps[mode][k]
        assert_step_close(rank_step(ranks[0][mode, k]), one, state,
                          rows=BOX_MASK > 0)
        a, b = (r[mode, k] for r in ranks)
        assert a['loss'] == b['loss']
        for key in ('params', 'momentum', 'frozen'):
            for name in a[key]:
                np.testing.assert_array_equal(a[key][name], b[key][name])


def test_precise_bn_two_ranks_match_one_process(inputs, ranks):
    cfg = flagship_cfg({**CFG, **MODES['all']})
    spec = build_spec(cfg, 'train')
    new = compute_precise_bn_stats(
        spec, params_from_jax(inputs['true_bn_params']['all'], device='cpu'),
        [torch_parallel_ranks.tensors(b) for b in inputs['precise_bn_batches']],
        2)
    got = ranks[0]['precise_bn']
    assert set(got) == {k for k in new if k.endswith(('_rm', '_riv'))}
    for name, value in got.items():
        want = to_np(new[name])
        if name.endswith('_riv'):
            # E[x^2] - E[x]^2: held to the E[x^2] it is taken from.
            scale = np.abs(want + to_np(new[name[:-3] + 'rm']) ** 2).max()
        else:
            scale = np.abs(want).max()
        np.testing.assert_allclose(value, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
        np.testing.assert_array_equal(value, ranks[1]['precise_bn'][name])
