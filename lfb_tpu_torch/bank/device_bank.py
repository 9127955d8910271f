"""Device-resident long-term feature banks with on-device window gather
(port of ``lfb_tpu/bank/device_bank.py``: ``AvaDeviceBank``,
``FrameDeviceBank``, the window functions and ``build_device_bank``).

The reference ships each example's bank window through the input pipeline
as a host-assembled (W*K, 2048) blob (``lib/datasets/ava.py:300-323``).
Here the whole bank lives in device memory once and each step gathers its
windows on the device with index ops:

* :class:`AvaDeviceBank` -- per-(video, second) feature lists, keyed by
  (video_idx, sec); <= K random features per second.
* :class:`FrameDeviceBank` -- per-video frame-indexed features (Charades,
  EPIC verb, EPIC noun), keyed by (video_idx, clip center); the first W
  features whose frame falls in the window, as the host samplers take them
  (``lfb_tpu/data/charades.py:53``, ``lfb_tpu/data/epic.py``).

Row ids, the seeded subsampling over a width cap and the window arithmetic
are ``lfb_tpu``'s, so both packages gather the same rows from the same host
bank.  :func:`shard_bank` row-shards a bank's feature table over the ranks
of the process group (``TPU.BANK_SHARDED``).  ``_BoundFeatsBank`` (a jit
workaround) is not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from lfb_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)

AVA_SEC_BASE = 902
AVA_NUM_SECS = 897  # seconds 902..1798

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _stack_rows(rows: List[np.ndarray], lfb_dim: int) -> np.ndarray:
    """(R + 1, D) f32: the rows, then the zero row."""
    flat = np.empty((len(rows) + 1, lfb_dim), np.float32)
    if rows:
        np.stack(rows, out=flat[:-1])
    flat[-1] = 0.0
    return flat


class AvaDeviceBank:
    """Packed AVA bank: flat features + (video, sec, slot) index table."""

    def __init__(self, feats: torch.Tensor, table: torch.Tensor,
                 counts: torch.Tensor, *, window_size: int, k: int):
        self.feats = feats          # (R+1, D); row R is the zero row
        self.zero_idx = feats.shape[0] - 1
        self.table = table          # (V, AVA_NUM_SECS, K_store) row ids, int64
        self.counts = counts        # (V, AVA_NUM_SECS) valid slots, int64
        self.window_size = window_size
        self.k = k

    def num_videos(self) -> int:
        return self.table.shape[0]

    @classmethod
    def build(cls, host_bank: Dict[int, Dict[int, list]], *, window_size: int,
              k: int, lfb_dim: int = 2048, k_store: int = 0,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = 'cuda') -> 'AvaDeviceBank':
        """Same rows, table and counts as ``lfb_tpu``'s
        ``AvaDeviceBank.build`` (row ids in host-bank iteration order; the
        same seeded subsampling over an explicit ``k_store`` cap), filled
        per (video, sec) entry instead of per row and stacked once."""
        num_videos = max(host_bank.keys()) + 1 if host_bank else 0
        if k_store <= 0:
            k_store = max([k] + [len(f) for secs in host_bank.values()
                                 for f in secs.values()])
            logger.info('AvaDeviceBank: auto k_store=%d; index table %d x %d '
                        'x %d', k_store, num_videos, AVA_NUM_SECS, k_store)
        rows = []
        table = np.full((num_videos, AVA_NUM_SECS, k_store), -1, np.int64)
        counts = np.zeros((num_videos, AVA_NUM_SECS), np.int64)
        truncated = 0
        sub_rng = np.random.default_rng(20190607)  # as lfb_tpu: same subsets
        for video, secs in host_bank.items():
            for sec, feats in secs.items():
                si = sec - AVA_SEC_BASE
                if not 0 <= si < AVA_NUM_SECS:
                    continue
                if len(feats) > k_store:
                    truncated += 1
                    keep = sub_rng.choice(len(feats), k_store, replace=False)
                    feats = [feats[i] for i in sorted(keep)]
                n = len(feats)
                counts[video, si] = n
                table[video, si, :n] = np.arange(len(rows), len(rows) + n)
                rows.extend(feats)
        if truncated:
            logger.warning('AvaDeviceBank: %d (video, sec) entries exceeded '
                           'k_store=%d and were uniformly subsampled',
                           truncated, k_store)
        flat = _stack_rows(rows, lfb_dim)
        zero_idx = flat.shape[0] - 1
        table = np.where(table < 0, zero_idx, table)
        return cls(torch.from_numpy(flat).to(device=device, dtype=dtype),
                   torch.from_numpy(table).to(device),
                   torch.from_numpy(counts).to(device),
                   window_size=window_size, k=k)

    def choose_rows(self, video_idx: torch.Tensor, sec: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """(N,) video ids + (N,) keyframe seconds -> (N, W*K) feature-row
        ids.  Per second, min(count, K) distinct features are drawn
        uniformly into the leading slots; the other slots point at the zero
        row (host ``sample_lfb_window`` semantics)."""
        W, K = self.window_size, self.k
        dev = self.table.device
        k_store = self.table.shape[-1]
        N = video_idx.shape[0]

        lower = sec.to(dev).long() - W // 2 - AVA_SEC_BASE
        sec_idx = lower[:, None] + torch.arange(W, device=dev)
        in_range = (sec_idx >= 0) & (sec_idx < AVA_NUM_SECS)
        sec_c = sec_idx.clamp(0, AVA_NUM_SECS - 1)
        vid = video_idx.to(dev).long()[:, None]
        counts = torch.where(in_range, self.counts[vid, sec_c], 0)    # (N, W)
        slots = self.table[vid, sec_c]                                # (N, W, Ks)

        # Random distinct slots: sort uniforms, invalid slots pushed last.
        u = torch.rand((N, W, k_store), generator=generator, device=dev)
        u = u + (torch.arange(k_store, device=dev) >= counts[..., None]) * 10.0
        order = torch.argsort(u, dim=-1)[..., :K]
        chosen = torch.take_along_dim(slots, order, dim=-1)
        valid = (torch.arange(K, device=dev)
                 < torch.clamp(counts, max=K)[..., None])
        chosen = torch.where(valid, chosen, self.zero_idx)
        return chosen.reshape(N, W * K)

    def gather(self, video_idx: torch.Tensor, sec: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        """(N,) video ids + (N,) keyframe seconds -> (N, W*K, D) windows."""
        return self.feats[self.choose_rows(video_idx, sec, generator)]


def _cap_frame_table_width(label: str, auto_width: int, cap: int,
                           window_size: int, num_videos: int) -> int:
    """The per-video index-table width: ``cap`` (at least ``window_size``)
    when ``TPU.BANK_MAX_PER_VIDEO`` > 0, else the longest video's count."""
    if cap > 0:
        width = max(cap, window_size)
        logger.info('%s: explicit per-video cap %d (index tables 2 x %d x %d)',
                    label, width, num_videos, width)
        return width
    logger.info('%s: auto per-video width %d (longest video); index tables '
                '2 x %d x %d', label, auto_width, num_videos, auto_width)
    return auto_width


class FrameDeviceBank:
    """Packed frame-level bank: flat features + per-video sorted frame ids.

    ``window_mode`` ('charades', 'epic_verb' or 'epic_noun') with the fps
    and rate fields maps a clip center to an inclusive [begin, end] frame
    window."""

    def __init__(self, feats: torch.Tensor, frame_ids: torch.Tensor,
                 rows: torch.Tensor, *, window_size: int,
                 window_mode: str = 'charades', fps: int = 24,
                 clips_per_second: int = 2, max_per_frame: int = 1,
                 frames_per_second: int = 1):
        self.feats = feats          # (R+1, D); last row zero
        self.zero_idx = feats.shape[0] - 1
        self.frame_ids = frame_ids  # (V, M) sorted, -1 padded, int64
        self.rows = rows            # (V, M) row ids (zero row where padded)
        self.window_size = window_size
        self.window_mode = window_mode
        self.fps = fps
        self.clips_per_second = clips_per_second
        self.max_per_frame = max_per_frame
        self.frames_per_second = frames_per_second

    def num_videos(self) -> int:
        return self.frame_ids.shape[0]

    def window(self, center: torch.Tensor):
        if self.window_mode == 'charades':
            return charades_window(center, window_size=self.window_size,
                                   clips_per_second=self.clips_per_second,
                                   fps=self.fps)
        if self.window_mode == 'epic_noun':
            return epic_noun_window(
                center, window_size=self.window_size,
                max_per_frame=self.max_per_frame,
                frames_per_second=self.frames_per_second, fps=self.fps)
        if self.window_mode != 'epic_verb':
            raise ValueError('unknown window mode {!r}'.format(
                self.window_mode))
        return epic_verb_window(center, window_size=self.window_size,
                                fps=self.fps)

    def gather_centers(self, video_idx: torch.Tensor,
                       center: torch.Tensor) -> torch.Tensor:
        """(N,) video ids + (N,) clip centers (frames) -> (N, W, D)."""
        begin, end = self.window(center.to(self.frame_ids.device))
        return self.gather(video_idx, begin, end)

    @classmethod
    def _from_entries(cls, entries, num_videos: int, width: int, label: str,
                      lfb_dim: int, dtype: torch.dtype, device, **kwargs):
        """``entries`` [(video_idx, [(frame, feat), ...] in frame order)]:
        rows in that order; a video over ``width`` entries keeps a seeded
        uniform subset (``lfb_tpu``'s generator, draws and order)."""
        frame_ids = np.full((num_videos, width), -1, np.int64)
        rows_tab = np.zeros((num_videos, width), np.int64)
        rows = []
        truncated = 0
        sub_rng = np.random.default_rng(20190607)  # as lfb_tpu: same subsets
        for vi, flat in entries:
            if len(flat) > width:
                truncated += 1
                keep = sub_rng.choice(len(flat), width, replace=False)
                flat = [flat[i] for i in sorted(keep)]
            n = len(flat)
            frame_ids[vi, :n] = [frame for frame, _ in flat]
            rows_tab[vi, :n] = np.arange(len(rows), len(rows) + n)
            rows.extend(np.asarray(f, np.float32) for _, f in flat)
        if truncated:
            logger.warning('%s: %d videos exceeded the per-video cap %d and '
                           'were uniformly subsampled', label, truncated,
                           width)
        flat_feats = _stack_rows(rows, lfb_dim)
        rows_tab = np.where(frame_ids < 0, flat_feats.shape[0] - 1, rows_tab)
        return cls(torch.from_numpy(flat_feats).to(device=device, dtype=dtype),
                   torch.from_numpy(frame_ids).to(device),
                   torch.from_numpy(rows_tab).to(device), **kwargs)

    @classmethod
    def build(cls, host_bank: Dict, video_key_to_idx=None, *,
              window_size: int, lfb_dim: int = 2048,
              window_mode: str = 'charades', fps: int = 24,
              clips_per_second: int = 2, max_per_video: int = 0,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = 'cuda') -> 'FrameDeviceBank':
        """``host_bank`` {video_key: {frame: feat}}; ``video_key_to_idx``
        maps keys to dense indices (identity for int keys).
        ``max_per_video`` > 0 caps the per-video table width
        (``TPU.BANK_MAX_PER_VIDEO``); 0 stores every feature."""
        if video_key_to_idx is None:
            video_key_to_idx = {k: int(k) for k in host_bank}
        num_videos = max(video_key_to_idx.values()) + 1 if host_bank else 0
        # At least window_size columns so a gather can always yield W rows.
        width = max(max((len(v) for v in host_bank.values()), default=1),
                    window_size)
        width = _cap_frame_table_width('FrameDeviceBank', width,
                                       max_per_video, window_size, num_videos)
        entries = [(video_key_to_idx[key],
                    [(frame, frames[frame]) for frame in sorted(frames)])
                   for key, frames in host_bank.items()]
        return cls._from_entries(
            entries, num_videos, width, 'FrameDeviceBank', lfb_dim, dtype,
            device, window_size=window_size, window_mode=window_mode,
            fps=fps, clips_per_second=clips_per_second)

    @classmethod
    def build_noun(cls, host_bank: Dict, *, window_size: int,
                   max_per_frame: int, frames_per_second: int, fps: int,
                   lfb_dim: int = 2048, max_per_video: int = 0,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = 'cuda') -> 'FrameDeviceBank':
        """Noun banks ``{video_idx: {frame: (n, D) detector feats}}``: each
        frame's first ``max_per_frame`` features become consecutive entries
        sharing its frame id (empty frames are skipped), so the first-W
        gather is the host sampler's early-exit fill."""
        num_videos = max((int(k) for k in host_bank), default=-1) + 1
        entries = []
        width = window_size
        for key, frames in host_bank.items():
            flat = []
            for frame in sorted(frames):
                feats = np.asarray(frames[frame], np.float32)
                if feats.size == 0:
                    continue
                if feats.ndim == 1:
                    feats = feats[None]
                flat.extend((frame, f) for f in feats[:max_per_frame])
            entries.append((int(key), flat))
            width = max(width, len(flat))
        width = _cap_frame_table_width('FrameDeviceBank(noun)', width,
                                       max_per_video, window_size, num_videos)
        return cls._from_entries(
            entries, num_videos, width, 'FrameDeviceBank(noun)', lfb_dim,
            dtype, device, window_size=window_size, window_mode='epic_noun',
            fps=fps, max_per_frame=max_per_frame,
            frames_per_second=frames_per_second)

    def choose_rows(self, video_idx: torch.Tensor, begin: torch.Tensor,
                    end: torch.Tensor) -> torch.Tensor:
        """(N,) video ids + inclusive [begin, end] frame windows -> (N, W)
        row ids: the first W bank entries inside the window, in frame order;
        the other slots point at the zero row."""
        dev = self.frame_ids.device
        vid = video_idx.to(dev).long()
        fids = self.frame_ids[vid]                     # (N, M)
        M = fids.shape[-1]
        begin, end = begin.to(dev).long(), end.to(dev).long()
        valid = (fids >= 0) & (fids >= begin[:, None]) & (fids <= end[:, None])
        # Order-preserving selection of the first W valid entries.
        key = torch.where(valid, torch.arange(M, device=dev), M + 1)
        order = torch.argsort(key, dim=-1, stable=True)[:, :self.window_size]
        chosen = torch.take_along_dim(self.rows[vid], order, dim=-1)
        return torch.where(torch.take_along_dim(valid, order, dim=-1), chosen,
                           self.zero_idx)

    def gather(self, video_idx: torch.Tensor, begin: torch.Tensor,
               end: torch.Tensor) -> torch.Tensor:
        """(N, W, D) window features (see :meth:`choose_rows`)."""
        return self.feats[self.choose_rows(video_idx, begin, end)]


def sharded_rows_lookup(feats_local: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """Rows of a table row-sharded over the ranks, for this rank's windows
    (``lfb_tpu``'s ``sharded_rows_lookup``).  ``feats_local`` is this rank's
    (S, D) shard of the (world * S, D) table; ``rows`` (N, M) are global
    row ids of the rank's windows.  Every row lives on one rank, so: gather
    every rank's row ids (int32), look up the rows held here with zeros for
    the others, and sum-scatter the windows back, each rank keeping its own
    (N, M, D).  A window's row is its holder's row plus exact zeros, so the
    result is bitwise that of a whole table."""
    S = feats_local.shape[0]
    all_rows = mesh.gather_rows(rows.to(torch.int32)).long()
    local = all_rows - mesh.rank() * S
    held = (local >= 0) & (local < S)
    vals = feats_local[local.clamp(0, S - 1)]
    vals = torch.where(held[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                          device=vals.device))
    if not mesh.distributed():
        return vals
    out = vals.new_empty(rows.shape + vals.shape[-1:])
    dist.reduce_scatter_tensor(out, vals)
    return out


class ShardedDeviceBank:
    """A device bank whose feature table is row-sharded over the ranks of
    the process group (``lfb_tpu``'s ``ShardedDeviceBank``): each rank
    holds ``ceil(R / world)`` rows (the table padded with zero rows to a
    multiple of the world), cutting the bank's memory per card by the world
    size; window gathers reassemble through :func:`sharded_rows_lookup`.
    The index tables stay whole in every rank.  The inner bank's table is
    dropped (``inner.feats`` None), so a stray gather from it fails."""

    def __init__(self, inner):
        if inner.feats is None:
            raise ValueError(
                "bank already sharded: this inner bank's feature table was "
                'dropped by a previous shard_bank; reuse that '
                'ShardedDeviceBank (shard_bank() does this automatically)')
        self.inner = inner
        self.world, r = mesh.world_size(), mesh.rank()
        feats = inner.feats
        per_rank = -(-feats.shape[0] // self.world)
        shard = feats[r * per_rank:(r + 1) * per_rank]
        self.feats = torch.zeros((per_rank,) + tuple(feats.shape[1:]),
                                 dtype=feats.dtype, device=feats.device)
        self.feats[:shard.shape[0]] = shard
        inner.feats = None
        inner._sharded_wrapper = self

    def num_videos(self) -> int:
        return self.inner.num_videos()

    def gather(self, *args) -> torch.Tensor:
        """As the inner bank's ``gather`` (AVA: video, sec, generator;
        frame-level: video, begin, end)."""
        return sharded_rows_lookup(self.feats, self.inner.choose_rows(*args))

    def gather_centers(self, video_idx: torch.Tensor,
                       center: torch.Tensor) -> torch.Tensor:
        begin, end = self.inner.window(center.to(self.inner.frame_ids.device))
        return self.gather(video_idx, begin, end)


def shard_bank(bank):
    """Row-shard a device bank's feature table over the process group's
    ranks (idempotent: a bank already sharded, or an inner bank whose table
    a previous call took, gives that ``ShardedDeviceBank``)."""
    if bank is None or isinstance(bank, ShardedDeviceBank):
        return bank
    cached = getattr(bank, '_sharded_wrapper', None)
    if cached is not None:
        if cached.world != mesh.world_size():
            raise ValueError('bank already sharded over {} ranks, not '
                             '{}'.format(cached.world, mesh.world_size()))
        return cached
    return ShardedDeviceBank(bank)


def build_device_bank(cfg, host_bank: Dict, video_name_to_idx=None, *,
                      device: torch.device | str = 'cuda'):
    """Host bank (from :mod:`lfb_tpu_torch.bank.lfb` or a reference pickle)
    -> the device-resident bank of the configured dataset: AVA
    {video: {sec: [feat]}}; Charades {video_idx: {frame: feat}}; EPIC verb
    {video_name: {frame: feat}} with ``video_name_to_idx``; EPIC noun
    {video_idx: {frame: (n, D) feats}}.  ``TPU.BANK_DTYPE`` sets the row
    dtype."""
    dtype = _DTYPES[cfg.TPU.BANK_DTYPE]
    if cfg.DATASET == 'ava':
        return AvaDeviceBank.build(
            host_bank, window_size=cfg.LFB.WINDOW_SIZE,
            k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP, lfb_dim=cfg.LFB.LFB_DIM,
            k_store=cfg.TPU.BANK_K_STORE, dtype=dtype, device=device)
    if cfg.DATASET == 'charades':
        return FrameDeviceBank.build(
            host_bank, window_size=cfg.LFB.WINDOW_SIZE,
            lfb_dim=cfg.LFB.LFB_DIM, window_mode='charades',
            fps=cfg.CHARADES.FPS,
            clips_per_second=cfg.CHARADES.LFB_CLIPS_PER_SECOND,
            max_per_video=cfg.TPU.BANK_MAX_PER_VIDEO, dtype=dtype,
            device=device)
    if cfg.DATASET == 'epic':
        if cfg.EPIC.CLASS_TYPE == 'noun':
            return FrameDeviceBank.build_noun(
                host_bank, window_size=cfg.LFB.WINDOW_SIZE,
                max_per_frame=cfg.EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME,
                frames_per_second=cfg.EPIC.NOUN_LFB_FRAMES_PER_SECOND,
                fps=cfg.EPIC.FPS, lfb_dim=cfg.LFB.LFB_DIM,
                max_per_video=cfg.TPU.BANK_MAX_PER_VIDEO, dtype=dtype,
                device=device)
        if video_name_to_idx is None:
            raise ValueError('EPIC verb banks are keyed by video name: pass '
                             'video_name_to_idx')
        return FrameDeviceBank.build(
            host_bank, video_name_to_idx, window_size=cfg.LFB.WINDOW_SIZE,
            lfb_dim=cfg.LFB.LFB_DIM, window_mode='epic_verb',
            fps=cfg.EPIC.FPS, max_per_video=cfg.TPU.BANK_MAX_PER_VIDEO,
            dtype=dtype, device=device)
    raise ValueError('unknown DATASET {!r}'.format(cfg.DATASET))


def charades_window(center: torch.Tensor, *, window_size: int,
                    clips_per_second: int, fps: int):
    """Inclusive [begin, end] frame window for Charades (reference
    ``charades.py:259-261``): begin rounds half to even in f32, as
    ``lfb_tpu``'s ``jnp.round``."""
    secs = window_size // clips_per_second
    begin = torch.round(center.float() - float(secs) / 2.0 * fps).long()
    return begin, begin + secs * fps


def epic_verb_window(center: torch.Tensor, *, window_size: int, fps: int):
    """Inclusive [lower, upper] frame window for EPIC verbs (reference
    ``epic.py:312-316``)."""
    half_len = (window_size * fps) // 2
    c = center.long()
    return c - half_len, c + half_len


def epic_noun_window(center: torch.Tensor, *, window_size: int,
                     max_per_frame: int, frames_per_second: int, fps: int):
    """Inclusive [lower, upper] frame window for EPIC nouns (reference
    ``epic.py:344-347``): ``secs = W / (max_per_frame * frames_per_second)``,
    ``lower = int(c - secs / 2 * fps)``, ``upper = int(lower + secs * fps)``,
    in exact integer arithmetic with truncating division (Python's ``int()``
    truncates toward zero)."""
    c = center.long()
    num = window_size * fps                  # secs * fps == num / den
    den = max_per_frame * frames_per_second
    lower = torch.div(c * (2 * den) - num, 2 * den, rounding_mode='trunc')
    upper = torch.div(lower * den + num, den, rounding_mode='trunc')
    return lower, upper
