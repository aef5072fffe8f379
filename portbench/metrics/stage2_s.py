"""``stage2_s``: seconds per clip of the pipeline's ``stage2`` phase (host clock
after a device synchronisation, ``ActionMeshPipeline.phase_seconds``),
summed over the measured window's clips (untraced: the
profiled clip after the window is not counted) and divided by their count."""


def read(record: dict):
    vals = [p.get("stage2") for p in record["phase_seconds"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / record["clips"]
