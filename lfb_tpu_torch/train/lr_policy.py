"""Learning-rate schedules: the port's own copy of ``lfb_tpu/train/
lr_policy.py`` (reference ``lib/utils/lr_policy.py``).

Pure functions of (solver config, iteration); the linear warmup overlays any
base policy exactly like reference ``get_lr_at_iter`` (``lr_policy.py:41-65``).
``tests/test_torch_train.py`` holds this copy to the original across warm-up
and every step boundary.
"""

from __future__ import annotations


def get_lr_at_iter(solver, it: int) -> float:
    """``solver`` is the cfg.SOLVER AttrDict (or anything with these keys)."""
    lr = _base_lr(solver, it)
    warmup = solver.WARMUP
    last_it = warmup.WARMUP_END_ITER
    if warmup.WARMUP_ON and it < last_it:
        lr_start = float(warmup.WARMUP_START_LR)
        lr_end = _base_lr(solver, last_it)
        lr = it * (lr_end - lr_start) / (last_it - 1) + lr_start
    return float(lr)


def _base_lr(solver, it: int) -> float:
    policy = solver.LR_POLICY
    if policy == 'steps_with_relative_lrs':
        return float(solver.LRS[_step_index(solver, it)] * solver.BASE_LR)
    if policy == 'steps_with_lrs':
        return float(solver.LRS[_step_index(solver, it)])
    if policy == 'steps_with_decay':
        return float(solver.BASE_LR * solver.GAMMA ** _step_index(solver, it))
    if policy == 'step':
        return float(solver.BASE_LR * solver.GAMMA ** (it // solver.STEP_SIZE))
    raise NotImplementedError('Unknown LR policy: {}'.format(policy))


def _step_index(solver, it: int) -> int:
    steps = list(solver.STEPS) + [solver.MAX_ITER]
    assert steps[0] == 0, 'The first step should always start at 0.'
    ind = len(steps) - 1
    for i, step in enumerate(steps):
        if it < step:
            ind = i
            break
    return ind - 1
