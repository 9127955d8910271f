"""Host-side clip preprocessing (numpy/cv2), vectorized over the clip: the
port's copy of ``lfb_tpu/data/transforms.py``.

Reproduces the reference augmentation semantics
(``lib/datasets/data_input_helper.py:70-139`` + ``lib/datasets/
image_processor.py``) but operates on one (T, H, W, C) array instead of
per-frame Python lists, and emits channels-last RGB ready for the NDHWC
model input:

  train: inverse-uniform short-side jitter in [min,max] -> random crop ->
         50% horizontal flip (box coords follow).
  test:  short-side scale to TEST.SCALE -> optional force-flip (AVA
         multi-crop) -> 3-position spatial-shift crop.
  both:  /255, optional PCA lighting, per-channel mean/std normalize,
         BGR->RGB unless MODEL.USE_BGR.

Randomness is explicit (``numpy.random.Generator``) instead of global.

OpenCV decodes (``cv2.imread``) and resizes (``cv2.resize``), as in
``lfb_tpu``, so the clips are bitwise its clips.  It is imported at first
use, in :func:`short_side_scale` and :func:`load_frames`: importing this
module loads no ``cv2``, and a host without it raises ``ImportError`` there.
``lfb_tpu``'s native libjpeg decoder (``native/clip_loader.cc``) is not
ported: the port needs no libjpeg to link against.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np


def _cv2():
    """OpenCV, imported on first use, with OpenCL off as in ``lfb_tpu``."""
    import cv2
    cv2.ocl.setUseOpenCL(False)
    return cv2


# ----------------------------------------------------------------------- #
# Geometry
# ----------------------------------------------------------------------- #

def short_side_scale(clip: np.ndarray, size: int,
                     interpolation: str = 'INTER_LINEAR') -> np.ndarray:
    """Scale so the short side equals ``size`` (no-op if already there)."""
    t, h, w = clip.shape[:3]
    if (w <= h and w == size) or (h <= w and h == size):
        return clip
    if w < h:
        nw, nh = size, int(math.floor(float(h) / w * size))
    else:
        nw, nh = int(math.floor(float(w) / h * size)), size
    cv2 = _cv2()
    interp = getattr(cv2, interpolation)
    # Resize in the input dtype: the reference resizes the raw uint8 imread
    # output and only then converts to float (``image_processor.py:189-204``).
    out = np.empty((t, nh, nw, clip.shape[3]), clip.dtype)
    for i in range(t):
        out[i] = cv2.resize(clip[i], (nw, nh), interpolation=interp)
    return out


def scale_boxes(size: int, boxes: np.ndarray, height: int,
                width: int) -> np.ndarray:
    """Rescale pixel boxes to the short-side-scaled frame."""
    if (width <= height and width == size) or (height <= width and height == size):
        return boxes
    if width < height:
        factor = float(int(math.floor(float(height) / width * size))) / height
    else:
        factor = float(int(math.floor(float(width) / height * size))) / width
    return boxes * factor


def jitter_scale(rng: np.random.Generator, min_size: int, max_size: int) -> int:
    """Inverse-uniform short-side sample (reference
    ``image_processor.py:229``)."""
    return int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))


def random_crop(rng: np.random.Generator, clip: np.ndarray, size: int,
                boxes: Optional[np.ndarray] = None):
    t, h, w = clip.shape[:3]
    if h == size and w == size:
        return clip, boxes
    y0 = int(rng.integers(0, h - size)) if h > size else 0
    x0 = int(rng.integers(0, w - size)) if w > size else 0
    out = clip[:, y0:y0 + size, x0:x0 + size]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, [0, 2]] -= x0
        boxes[:, [1, 3]] -= y0
    return out, boxes


def spatial_shift_crop(clip: np.ndarray, size: int, shift: int,
                       boxes: Optional[np.ndarray] = None):
    """Crop at one of three positions along the long side (0/1/2 =
    left/center/right or top/center/bottom)."""
    assert shift in (0, 1, 2)
    t, h, w = clip.shape[:3]
    y0 = int(math.ceil((h - size) / 2))
    x0 = int(math.ceil((w - size) / 2))
    if h > w:
        if shift == 0:
            y0 = 0
        elif shift == 2:
            y0 = h - size
    else:
        if shift == 0:
            x0 = 0
        elif shift == 2:
            x0 = w - size
    out = clip[:, y0:y0 + size, x0:x0 + size]
    assert out.shape[1] == size and out.shape[2] == size
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, [0, 2]] -= x0
        boxes[:, [1, 3]] -= y0
    return out, boxes


def horizontal_flip(rng: Optional[np.random.Generator], clip: np.ndarray,
                    prob: float = 0.5, boxes: Optional[np.ndarray] = None,
                    force: bool = False):
    w = clip.shape[2]
    if force or (rng is not None and rng.uniform() < prob):
        clip = clip[:, :, ::-1]
        if boxes is not None:
            flipped = boxes.copy()
            flipped[:, 0] = w - boxes[:, 2] - 1
            flipped[:, 2] = w - boxes[:, 0] - 1
            boxes = flipped
    return clip, boxes


def clip_boxes_to_image(boxes: np.ndarray, height: int,
                        width: int) -> np.ndarray:
    boxes = boxes.copy()
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0.0, width - 1.0)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0.0, height - 1.0)
    return boxes


# ----------------------------------------------------------------------- #
# Color (clip is (T, H, W, C) in [0, 1]; channel order BGR at this stage)
# ----------------------------------------------------------------------- #

def lighting(rng: np.random.Generator, clip: np.ndarray, alphastd: float,
             eigval: np.ndarray, eigvec: np.ndarray) -> np.ndarray:
    """PCA lighting noise; eig pairs are RGB-based, clip is BGR, hence the
    channel reversal (reference ``image_processor.py:253-269``)."""
    if alphastd == 0:
        return clip
    alpha = rng.normal(0, alphastd, size=(1, 3))
    rgb = np.sum(eigvec * np.repeat(alpha, 3, axis=0)
                 * np.repeat(np.reshape(eigval, (1, 3)), 3, axis=0), axis=1)
    return clip + rgb[::-1].astype(np.float32)  # broadcast over (T,H,W,C=BGR)


def _grayscale(clip: np.ndarray) -> np.ndarray:
    gray = (0.299 * clip[..., 2] + 0.587 * clip[..., 1]
            + 0.114 * clip[..., 0])
    return np.repeat(gray[..., None], 3, axis=-1)


def color_jitter(rng: np.random.Generator, clip: np.ndarray,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4) -> np.ndarray:
    ops = []
    if brightness:
        ops.append('brightness')
    if contrast:
        ops.append('contrast')
    if saturation:
        ops.append('saturation')
    for idx in rng.permutation(len(ops)):
        name = ops[idx]
        if name == 'brightness':
            alpha = 1.0 + rng.uniform(-brightness, brightness)
            clip = clip * alpha
        elif name == 'contrast':
            alpha = 1.0 + rng.uniform(-contrast, contrast)
            # Blend toward each frame's mean intensity.
            gray_mean = _grayscale(clip).mean(axis=(1, 2, 3), keepdims=True)
            clip = clip * alpha + gray_mean * (1 - alpha)
        else:
            alpha = 1.0 + rng.uniform(-saturation, saturation)
            clip = clip * alpha + _grayscale(clip) * (1 - alpha)
    return clip.astype(np.float32)


# ----------------------------------------------------------------------- #
# Full pipeline
# ----------------------------------------------------------------------- #

def preprocess_clip(
    clip: np.ndarray,
    *,
    is_train: bool,
    crop_size: int,
    cfg,
    rng: Optional[np.random.Generator] = None,
    spatial_shift: int = 1,
    boxes: Optional[np.ndarray] = None,
    force_flip: bool = False,
    output_uint8: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(T, H, W, 3) BGR uint8/float frames -> (T, crop, crop, 3) normalized
    RGB float32 (+ transformed pixel boxes).

    Geometry (resize/crop/flip) runs in the input dtype -- uint8 from the
    decoder, exactly like the reference, which resizes the raw imread
    output (``image_processor.py:189-204``).  With ``output_uint8`` the
    float normalization (/255, mean/std) is skipped and the clip returns as
    channel-reordered uint8 for ON-DEVICE normalization
    (``TPU.DEVICE_NORMALIZE``): 4x less host->device traffic and no host
    float math; the model normalizes uint8 frames on the card
    (``models/model.py``).
    Requires color augmentation off (released configs never enable it).

    Boxes arrive normalized to [0, 1] (AVA CSV convention) and leave in crop
    pixel coordinates, clipped.
    """
    t, height, width = clip.shape[:3]

    if boxes is not None:
        boxes = boxes.copy().astype(np.float32)
        boxes[:, [0, 2]] *= width
        boxes[:, [1, 3]] *= height
        boxes = clip_boxes_to_image(boxes, height, width)

    if is_train:
        assert rng is not None
        size = jitter_scale(rng, cfg.TRAIN.JITTER_SCALES[0],
                            cfg.TRAIN.JITTER_SCALES[1])
        if boxes is not None:
            boxes = scale_boxes(size, boxes, height, width)
        clip = short_side_scale(clip, size, cfg.INTERPOLATION)
        clip, boxes = random_crop(rng, clip, crop_size, boxes)
        clip, boxes = horizontal_flip(rng, clip, 0.5, boxes)
    else:
        if boxes is not None:
            boxes = scale_boxes(cfg.TEST.SCALE, boxes, height, width)
        clip = short_side_scale(clip, cfg.TEST.SCALE, cfg.INTERPOLATION)
        if force_flip:
            clip, boxes = horizontal_flip(None, clip, boxes=boxes, force=True)
        clip, boxes = spatial_shift_crop(clip, crop_size, spatial_shift, boxes)

    if output_uint8:
        assert not (is_train and cfg.TRAIN.USE_COLOR_AUGMENTATION), \
            'color augmentation needs the float path'
        if not cfg.MODEL.USE_BGR:
            clip = clip[..., ::-1]  # BGR -> RGB
        if boxes is not None:
            boxes = clip_boxes_to_image(boxes, crop_size, crop_size)
        return np.ascontiguousarray(clip, dtype=np.uint8), boxes

    clip = np.ascontiguousarray(clip, dtype=np.float32) / 255.0

    if is_train and cfg.TRAIN.USE_COLOR_AUGMENTATION:
        if not cfg.TRAIN.PCA_JITTER_ONLY:
            clip = color_jitter(rng, clip)
        clip = lighting(rng, clip, 0.1,
                        np.asarray(cfg.TRAIN.PCA_EIGVAL, np.float32),
                        np.asarray(cfg.TRAIN.PCA_EIGVEC, np.float32))

    mean = np.asarray(cfg.DATA_MEAN, np.float32)
    std = np.asarray(cfg.DATA_STD, np.float32)
    clip = (clip - mean) / std

    if not cfg.MODEL.USE_BGR:
        clip = clip[..., ::-1]  # BGR -> RGB

    if boxes is not None:
        boxes = clip_boxes_to_image(boxes, crop_size, crop_size)
    return np.ascontiguousarray(clip, dtype=np.float32), boxes


def load_frames(paths, retry: int = 10) -> np.ndarray:
    """Read JPEG frames (BGR, HWC) with ``cv2.imread``, retrying the clip up
    to ``retry`` times a second apart (reference
    ``data_input_helper.py:51-61``); raises ``IOError`` when a frame still
    does not read."""
    cv2 = _cv2()
    for attempt in range(retry):
        imgs = [cv2.imread(p) for p in paths]
        if all(img is not None for img in imgs):
            return np.stack(imgs)
        if attempt == retry - 1:
            raise IOError('Failed to load images {}'.format(paths))
        time.sleep(1.0)
