"""Training orchestration (port of ``lfb_tpu/train/trainer.py``; reference
``train_net.py:93-212``).

The host loop handles LR scheduling + momentum correction, checkpoint
cadence, periodic eval, precise-BN, metrics and the NaN watchdog, around
the port's train step (forward, backward and the SGD update as PyTorch
launches on the device).  Metric pulls (device -> host) wait for
LOG_PERIOD, checkpoints and evals, so the host runs ahead of the device
between them.

In a process group (``lfb_tpu``'s mesh) every rank runs this loop on its
shard of each ``TRAIN.BATCH_SIZE`` batch, from the same params (checked at
start-up), and makes the same update with the summed gradients; rank 0
alone writes the checkpoints, the json_stats and the log, every rank reads
the resume point, and the NaN watchdog reads the global loss, so all ranks
stop together.  Without a group it trains on one device.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from lfb_tpu_torch.bank.device_bank import shard_bank
from lfb_tpu_torch.core.config import clone
from lfb_tpu_torch.data.loader import (DataLoader, DeviceFeed, get_input_db,
                                       to_device)
from lfb_tpu_torch.eval.metrics import MetricsCalculator
from lfb_tpu_torch.models.model import frozen_param_names, init_params
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.parallel import mesh
from lfb_tpu_torch.train import checkpoints as ckpt
from lfb_tpu_torch.train import optimizer as opt
from lfb_tpu_torch.train.lr_policy import get_lr_at_iter
from lfb_tpu_torch.train.precise_bn import compute_precise_bn_stats
from lfb_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       split_params)
from lfb_tpu_torch.utils.logging_utils import (describe_params,
                                               get_json_stats_dict,
                                               log_json_stats)
from lfb_tpu_torch.utils.profiling import StepTrace
from lfb_tpu_torch.utils.timer import Timer

logger = logging.getLogger(__name__)

def _device_bank(db):
    """The dataset's bank when it holds it on the device (TPU.DEVICE_BANK),
    for the step to gather windows from; None for host windows."""
    bank = getattr(db, 'lfb', None)
    return bank if hasattr(bank, 'gather') else None


class Trainer:

    def __init__(self, cfg, output_dir: Optional[str] = None,
                 train_lfb=None, test_lfb=None, device='cuda'):
        self.cfg = cfg
        self.device = torch.device(device)
        self.output_dir = output_dir or cfg.CHECKPOINT.DIR
        self.checkpoint_dir = os.path.join(
            os.path.abspath(self.output_dir), 'checkpoints')
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        logger.info('Training on %d rank(s) (%s) for NUM_GPUS %d: %d clips a '
                    'step on each, the global TRAIN.BATCH_SIZE %d',
                    self.world, self.device, cfg.NUM_GPUS,
                    cfg.TRAIN.BATCH_SIZE // self.world, cfg.TRAIN.BATCH_SIZE)
        self.train_lfb = train_lfb
        self.test_lfb = test_lfb

        self.spec = build_spec(cfg, 'train')
        self.test_spec = build_spec(cfg, cfg.TEST.DATA_TYPE or 'val')
        params = init_params(self.spec, torch.Generator(
            device=self.device).manual_seed(cfg.RNG_SEED))

        # Data.
        self.train_db = get_input_db(cfg, 'train', lfb=train_lfb,
                                     device=self.device)
        self.train_loader = DataLoader(
            self.train_db, cfg.TRAIN.BATCH_SIZE,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
            seed=cfg.RNG_SEED, is_train=True, rank=self.rank,
            world=self.world)
        # Training-time evaluation mirrors the reference's phase injection
        # (``train_net.py:107-108``): the val split uses the TRAIN detection
        # threshold and the mini (sec%4==0) subset unless
        # FULL_EVAL_DURING_TRAINING.
        test_cfg = cfg
        if cfg.DATASET == 'ava':
            test_cfg = clone(cfg, {
                'AVA.DETECTION_SCORE_THRESH':
                    cfg.AVA.DETECTION_SCORE_THRESH_TRAIN,
                'AVA.FULL_EVAL': cfg.AVA.FULL_EVAL_DURING_TRAINING,
            })
        self.test_db = get_input_db(test_cfg, cfg.TEST.DATA_TYPE or 'val',
                                    lfb=test_lfb, device=self.device)
        self.test_loader = DataLoader(
            self.test_db, cfg.TEST.BATCH_SIZE,
            num_workers=cfg.DATALOADER.NUM_WORKERS,
            prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
            seed=cfg.RNG_SEED + 1, is_train=False, rank=self.rank,
            world=self.world)

        # Model/optimizer state.
        self.frozen_names = frozen_param_names(self.spec, params)
        self.start_iter, prev_lr, params, momentum = self._load_initial(params)
        self.current_lr = prev_lr if prev_lr > 0 else get_lr_at_iter(
            cfg.SOLVER, self.start_iter)
        self.trainable, self.frozen = split_params(self.spec, params)
        if momentum is None:
            self.mstate = opt.init_state(params, self.frozen_names)
        else:
            self.mstate = opt.SGDState(momentum={
                k: momentum[k] for k in self.trainable})
        mesh.check_same({**params, **{'momentum ' + k: v for k, v in
                                      self.mstate.momentum.items()}},
                        'the initial params and momentum')

        # Datasets convert host banks to device banks under TPU.DEVICE_BANK;
        # read the (possibly converted) bank back for the steps.
        train_bank = _device_bank(self.train_db)
        test_bank = _device_bank(self.test_db)
        if cfg.TPU.BANK_SHARDED:
            train_bank, test_bank = shard_bank(train_bank), shard_bank(
                test_bank)
        self.train_bank = train_bank
        self.train_step = make_train_step(self.spec, cfg.SOLVER,
                                          bank=train_bank)
        self.eval_step = make_eval_step(self.test_spec, bank=test_bank,
                                        bank_seed=cfg.RNG_SEED)

        # Meters.
        self.train_meter = MetricsCalculator(
            cfg, 'train',
            video_idx_to_name=self.train_db.video_idx_to_name,
            total_num_boxes=getattr(self.train_db, 'num_boxes_used', None),
            output_dir=self.output_dir)
        self.test_meter = MetricsCalculator(
            cfg, 'val',
            video_idx_to_name=self.test_db.video_idx_to_name,
            total_num_boxes=getattr(self.test_db, 'num_boxes_used', None),
            num_test_clips=(self.test_db.num_test_clips
                            if cfg.DATASET == 'charades' else 1),
            full_eval=(cfg.AVA.FULL_EVAL_DURING_TRAINING
                       if cfg.DATASET == 'ava' else True),
            output_dir=self.output_dir)

    # ------------------------------------------------------------------ #

    def _load_initial(self, params):
        """Reference 4-case resume logic (``checkpoints.py:180-237``)."""
        cfg = self.cfg
        momentum = None
        start_iter, prev_lr = 0, 0.0

        resume_file = (ckpt.latest_checkpoint(self.checkpoint_dir)
                       if cfg.CHECKPOINT.RESUME else None)
        if resume_file:
            logger.info('Resuming from %s', resume_file)
            mzero = {k: torch.zeros_like(v) for k, v in params.items()
                     if k not in self.frozen_names}
            params, momentum, start_iter, prev_lr = ckpt.load_params_into(
                resume_file, params, load_momentum=True, momentum=mzero,
                device=self.device)
        elif cfg.TRAIN.PARAMS_FILE:
            logger.info('Initializing from pre-trained %s',
                        cfg.TRAIN.PARAMS_FILE)
            params, _, start_iter, prev_lr = ckpt.load_params_into(
                cfg.TRAIN.PARAMS_FILE, params,
                convert_model=cfg.CHECKPOINT.CONVERT_MODEL,
                load_momentum=False, device=self.device)
            if cfg.TRAIN.RESUME_FROM_BATCH_SIZE > 0:
                start_iter = ckpt.resume_iter_for_batch_size(
                    start_iter, cfg.TRAIN.RESUME_FROM_BATCH_SIZE,
                    cfg.TRAIN.BATCH_SIZE)
            if cfg.TRAIN.RESET_START_ITER:
                start_iter = 0
        else:
            logger.info('No checkpoint found; training from scratch...')
        return start_iter, prev_lr, params, momentum

    def _update_lr(self, cur_iter: int) -> float:
        """LR step + momentum correction (reference
        ``model_builder_video.py:258-314``)."""
        cfg = self.cfg
        new_lr = get_lr_at_iter(cfg.SOLVER, cur_iter)
        if new_lr != self.current_lr and self.current_lr > 0:
            ratio = max(new_lr / max(self.current_lr, 1e-10),
                        self.current_lr / max(new_lr, 1e-10))
            if (cfg.SOLVER.SCALE_MOMENTUM and self.current_lr > 1e-7
                    and ratio > cfg.SOLVER.SCALE_MOMENTUM_THRESHOLD):
                scale = new_lr / self.current_lr
                logger.info('Scaling update history by %.6f (new/old lr)',
                            scale)
                self.mstate = opt.correct_momentum(self.mstate, scale)
        self.current_lr = new_lr
        return new_lr

    # ------------------------------------------------------------------ #

    def _maybe_precise_bn(self):
        """Recompute the true-BN running statistics before a checkpoint or
        an eval (reference ``train_net.py:163-182``, ``lfb_tpu``
        ``trainer.py:198-215``) over the first
        ``TRAIN.ITER_COMPUTE_PRECISE_BN`` train batches, each rank its
        shards, with the train step's bank; no-op in frozen-affine mode."""
        cfg = self.cfg
        if not cfg.TRAIN.COMPUTE_PRECISE_BN or self.spec.use_affine:
            return
        num = cfg.TRAIN.ITER_COMPUTE_PRECISE_BN
        params = compute_precise_bn_stats(
            self.spec, self.params(),
            (to_device(b, self.device)
             for b in self.train_loader.batches(num_batches=num)),
            num, bank=self.train_bank)
        for name in self.frozen:
            self.frozen[name] = params[name]

    def save_checkpoint(self, cur_iter: int) -> str:
        """Rank 0 writes the checkpoint; every rank waits for it and gets
        its path."""
        path = os.path.join(self.checkpoint_dir,
                            'c2_model_iter{}.pkl'.format(cur_iter + 1))
        if self.rank == 0:
            ckpt.save_params(path, self.params(), model_iter=cur_iter + 1,
                             lr=self.current_lr,
                             momentum=self.mstate.momentum)
            logger.info('Saved checkpoint %s', path)
        mesh.barrier()
        return path

    def params(self) -> Dict[str, torch.Tensor]:
        return {**self.trainable, **self.frozen}

    def train(self):
        """Run the full training loop; returns the last checkpoint path."""
        cfg = self.cfg
        last_checkpoint = ckpt.latest_checkpoint(self.checkpoint_dir)
        log_period = max(1, cfg.LOG_PERIOD)
        t_start = time.time()
        pending = []  # (iter, aux, labels, lr) not yet pulled to host
        # Per-iteration wall clock (reference ``Timer`` around every step,
        # ``metrics.py:348-366``) + a steady-state window that excludes the
        # first log period (pipeline fill), so e2e throughput is measurable
        # from the outside.
        self.iter_timer = Timer()
        steady = {'t0': None, 'start': None}
        self.steady_clips_per_sec = 0.0

        def drain():
            for it, aux, labels, lr in pending:
                loss = float(aux['loss'])
                if not np.isfinite(loss):
                    raise RuntimeError(
                        'ERROR: Got NaN loss at iter {}'.format(it))
                self.train_meter.update_train(
                    loss, aux['prob'].float().cpu().numpy(),
                    labels.cpu().numpy(), lr)
            pending.clear()

        logger.info('Model parameters:\n%s',
                    describe_params(self.params(), max_rows=8))

        train_feed = DeviceFeed(
            self.train_loader, self.device, 'train sweep',
            num_batches=cfg.SOLVER.MAX_ITER - self.start_iter,
            start_batch=self.start_iter)
        trace = StepTrace(cfg.PROF_DAG, self.start_iter, self.output_dir,
                          self.device)
        try:
            for cur_iter, (_, batch) in enumerate(train_feed,
                                                  self.start_iter):
                # PROF_DAG: trace steps 1-3 (reference uses the prof_dag
                # executor for per-op timing, ``train_net.py:69-72``).
                trace.step(cur_iter)
                self.iter_timer.tic()
                lr = self._update_lr(cur_iter)
                self.trainable, self.frozen, self.mstate, aux = \
                    self.train_step(
                        self.trainable, self.frozen, self.mstate, batch,
                        torch.Generator(device=self.device).manual_seed(
                            mesh.step_seed(cfg.RNG_SEED * 1000003
                                           + cur_iter)), lr)
                pending.append((cur_iter, aux,
                                mesh.gather_rows(batch['labels']), lr))
                self.iter_timer.toc()

                if (cur_iter + 1) % log_period == 0:
                    drain()
                    if steady['t0'] is None:
                        # First drain done: the prefetch fill is behind us.
                        steady['t0'] = time.time()
                        steady['start'] = cur_iter + 1
                    elapsed = time.time() - t_start
                    done = cur_iter + 1 - self.start_iter
                    eta = elapsed / done * (cfg.SOLVER.MAX_ITER - cur_iter - 1)
                    logger.info(
                        '| Train ETA: %.0fs LR: %.8f Iters [%d/%d] Loss %7.4f',
                        eta, lr, cur_iter + 1, cfg.SOLVER.MAX_ITER,
                        self.train_meter.aggr_loss
                        / max(self.train_meter.aggr_batch_size, 1))

                if (cfg.CHECKPOINT.CHECKPOINT_PERIOD > 0 and (cur_iter + 1)
                        % cfg.CHECKPOINT.CHECKPOINT_PERIOD == 0) \
                        or cur_iter + 1 == cfg.SOLVER.MAX_ITER:
                    drain()
                    self._maybe_precise_bn()
                    last_checkpoint = self.save_checkpoint(cur_iter)

                if (cur_iter + 1) % cfg.TRAIN.EVAL_PERIOD == 0:
                    drain()
                    self._maybe_precise_bn()
                    self.evaluate(name='iter{}'.format(cur_iter + 1))
                    self.train_meter.finalize_metrics(is_train=True)
                    stats = get_json_stats_dict(
                        cfg, self.train_meter, self.test_meter, cur_iter,
                        self.device)
                    if self.rank == 0:
                        log_json_stats(stats)
                    self.train_meter.reset()

            drain()
            trace.close()
            if (steady['t0'] is not None
                    and cfg.SOLVER.MAX_ITER > steady['start']):
                self.steady_clips_per_sec = (
                    (cfg.SOLVER.MAX_ITER - steady['start'])
                    * cfg.TRAIN.BATCH_SIZE / (time.time() - steady['t0']))
        finally:
            self.train_loader.shutdown()
            self.test_loader.shutdown()
        return last_checkpoint

    def evaluate(self, name: str = 'latest') -> Optional[Dict[str, float]]:
        """One full sweep over the test split; each rank sweeps its shards,
        rank 0 gathers the logits, labels, boxes and metadata, and computes
        and returns the metrics (None on the other ranks)."""
        self.test_meter.reset()
        params = self.params()
        for _, dev_batch in DeviceFeed(self.test_loader, self.device,
                                       'eval sweep ({})'.format(name)):
            out = self.eval_step(params, dev_batch)
            batch = mesh.gather_host(dev_batch, ('labels', 'original_boxes',
                                                 'metadata', 'box_mask'))
            if self.rank == 0:
                self.test_meter.update_test(
                    out['logits'].float().cpu().numpy(), batch['labels'],
                    original_boxes=batch.get('original_boxes'),
                    metadata=batch.get('metadata'),
                    box_mask=batch.get('box_mask'))
        if self.rank:
            return None
        metrics = self.test_meter.finalize_metrics(name=name)
        self.test_meter.compute_and_log_best()
        logger.info('Eval %s: %s', name, metrics)
        return metrics
