"""device_idle_pct.infer: the share of the traced window (the profiled
iterations, from the first one's start on the host to the last device
operation's end) in which no kernel, copy or fill ran on the card."""


def read(record):
    trace = record.get('trace')
    if record['kind'] != 'two_phase' or not trace or trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
