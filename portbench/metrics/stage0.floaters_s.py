"""``stage0.floaters_s``: seconds per clip of the mesh processing's floater removal, the
key ``process_mesh.floaters`` of ``ActionMeshPipeline.stage0_seconds`` (the span's own
seconds on the host clock, from the program's span tree), summed over the measured
window's clips (untraced: the profiled clip after the window is not counted) and divided
by their count. Nothing where the program records no such span: a cell whose Stage 0 has
no extraction or mesh processing, or a program without the span tree."""


def read(record: dict):
    vals = [s.get("process_mesh.floaters") for s in record["stage0_seconds"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / record["clips"]
