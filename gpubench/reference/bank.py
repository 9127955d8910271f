"""The reference's bank windows: which rows of a resident feature bank an
example's window holds (the LFB paper's ``lib/datasets/ava.py:300-323``
and ``charades.py:250-270`` samplers, over packed index tables).

The tables are the benchmark's (:mod:`gpubench.bank`), the rows those the
benchmark drew; the random draw of an AVA window (at most K features of
each second, uniformly among that second's) is worked out again here from
the generator the program was given: one uniform number per (row, second,
stored slot), the K smallest taken, empty slots last.
"""

from __future__ import annotations

import torch

AVA_SEC_BASE = 902
AVA_NUM_SECS = 897


def ava_rows(table, counts, video, sec, *, zero: int, window: int, k: int,
             generator: torch.Generator) -> torch.Tensor:
    """(N,) videos and keyframe seconds -> (N, window * k) bank row ids;
    the zero row ``zero`` fills what a second lacks."""
    dev = table.device
    k_store = table.shape[-1]
    secs = (sec.to(dev).long()[:, None] - window // 2 - AVA_SEC_BASE
            + torch.arange(window, device=dev))
    inside = (secs >= 0) & (secs < AVA_NUM_SECS)
    secs = secs.clamp(0, AVA_NUM_SECS - 1)
    vid = video.to(dev).long()[:, None]
    n = torch.where(inside, counts[vid, secs], 0)
    u = torch.rand((video.shape[0], window, k_store), generator=generator,
                   device=dev)
    u = u + (torch.arange(k_store, device=dev) >= n[..., None]) * 10.0
    pick = torch.argsort(u, dim=-1)[..., :k]
    rows = torch.take_along_dim(table[vid, secs], pick, dim=-1)
    keep = torch.arange(k, device=dev) < n.clamp(max=k)[..., None]
    return torch.where(keep, rows, zero).reshape(video.shape[0], window * k)


def frame_rows(frame_ids, rows, video, center, *, zero: int, window: int,
               clips_per_second: int, fps: int) -> torch.Tensor:
    """(N,) videos and clip centres (frames) -> (N, window) row ids: the
    first ``window`` features whose frame lies in [begin, begin + secs *
    fps], begin = round(centre - secs / 2 * fps), secs = window /
    clips_per_second; the zero row ``zero`` after them."""
    dev = frame_ids.device
    secs = window // clips_per_second
    begin = torch.round(center.to(dev).float() - secs / 2.0 * fps).long()
    end = begin + secs * fps
    fid = frame_ids[video.to(dev).long()]
    inside = (fid >= 0) & (fid >= begin[:, None]) & (fid <= end[:, None])
    width = fid.shape[1]
    key = torch.where(inside, torch.arange(width, device=dev), width + 1)
    pick = torch.argsort(key, dim=-1, stable=True)[:, :window]
    got = torch.take_along_dim(rows[video.to(dev).long()], pick, dim=-1)
    return torch.where(torch.take_along_dim(inside, pick, dim=-1), got, zero)
