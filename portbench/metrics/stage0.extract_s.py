"""``stage0.extract_s``: seconds per clip of the SDF extraction's own host work (the span
``extract`` less its field queries: band dilation, the unique fine ids, marching cubes),
the key ``decode.extract`` of ``ActionMeshPipeline.stage0_seconds`` (the span's own
seconds on the host clock, from the program's span tree), summed over the measured
window's clips (untraced: the profiled clip after the window is not counted) and divided
by their count. Nothing where the program records no such span: a cell whose Stage 0 has
no extraction or mesh processing, or a program without the span tree."""


def read(record: dict):
    vals = [s.get("decode.extract") for s in record["stage0_seconds"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / record["clips"]
