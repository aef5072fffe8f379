"""``clip_s``: seconds per clip, on the host clock: the whole window (from
the start of its first clip to the end of the first clip that ends at or
after ``--seconds``) divided by the clips completed in it."""


def read(record: dict):
    return record["window_s"] / record["clips"]
