"""mfu.infer: the two-phase sweep's share of the card's bf16 peak (989
TFLOP/s): the reference's FLOPs of phase A and phase B over the real boxes
or clips of one iteration, times the window's iterations, over the
window's seconds."""

PEAK = 989e12


def read(record):
    if record['kind'] != 'two_phase' or record['window_s'] <= 0:
        return None
    rate = record['flops_per_iteration'] * record['iterations'] / \
        record['window_s']
    return 100.0 * rate / PEAK
