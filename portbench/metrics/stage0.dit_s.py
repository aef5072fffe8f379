"""``stage0.dit_s``: seconds per clip of Stage 0's ``dit_sample`` sub-phase (host clock
after a device synchronisation, ``ActionMeshPipeline.stage0_seconds``),
summed over the measured window's clips (untraced: the
profiled clip after the window is not counted) and divided by their count. Nothing
in a cell whose Stage 0 has no such sub-phase."""


def read(record: dict):
    vals = [s.get("dit_sample") for s in record["stage0_seconds"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / record["clips"]
