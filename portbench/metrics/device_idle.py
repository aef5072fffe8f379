"""``device_idle``: the share (%) of the profiled clip (the one after the
measured window) in which no kernel, copy or set ran on the card:
100 * (1 - union of the device intervals / the clip's span), from the
profiler's trace (``bench/tracing.py``). Nothing when the trace holds no
device event."""


def read(record: dict):
    tr = record["trace"]
    if not tr or not tr["n_device_events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
