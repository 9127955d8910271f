"""dispatch_ms.infer: host milliseconds from a step call to its return,
before the benchmark synchronizes, per call, over the whole window (a
two-phase iteration makes two calls, a train step one)."""


def read(record):
    if record['kind'] != 'two_phase' or record['calls'] <= 0:
        return None
    return 1e3 * record['dispatch_s'] / record['calls']
