"""A cell cut to a size the CPU runs in seconds: full depth and widths,
crop 64, 4 frames, 2 clips, small banks; float32 unless asked."""

from __future__ import annotations

from gpubench import layout


def tiny_cell(name: str, dtype: str = 'float32', crop: int = 64,
              frames: int = 4, clips: int = 2, root=layout.ROOT,
              here=layout.HERE) -> layout.Cell:
    cell = layout.cell(name, root, here)
    config, model = cell.config, cell.config['model']
    for split in ('TEST', 'TRAIN'):
        for key, value in (('CROP_SIZE', crop), ('VIDEO_LENGTH', frames),
                           ('BATCH_SIZE', clips)):
            model[split + '.' + key] = value
            config['overrides'][split + '.' + key] = value
    model['TPU.COMPUTE_DTYPE'] = dtype
    config['overrides']['TPU.COMPUTE_DTYPE'] = dtype
    for count_model in config['bank'].values():
        count_model['videos'] = 5
        if 'video0_rows' in count_model:
            count_model['video0_rows'] = 100
    cell.traffic['profile_iterations'] = 1
    return cell
