"""``clip_mfu``: the whole clip's share (%) of the card's bf16 peak: the
model FLOPs of the clips in the measured window (``work/<family>.py``, from
the configuration's widths and the traffic's shapes) over the window's
seconds times 989 TFLOP/s."""


def read(record: dict):
    if not record["flops_per_clip"] or record["window_s"] <= 0:
        return None
    return 100.0 * record["flops_per_clip"] * record["clips"] / (record["window_s"] * record["peak_flops"])
