"""mfu.train: the train steps' share of the card's bf16 peak (989
TFLOP/s): the reference's FLOPs of one step (the forward and the backward
of the trainable parameters, once, over the real boxes or clips), times
the window's steps, over the window's seconds."""

PEAK = 989e12


def read(record):
    if record['kind'] != 'train' or record['window_s'] <= 0:
        return None
    rate = record['flops_per_iteration'] * record['iterations'] / \
        record['window_s']
    return 100.0 * rate / PEAK
