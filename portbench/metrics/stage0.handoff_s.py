"""``stage0.handoff_s``: seconds per clip of Stage 0's ``handoff`` sub-phase (a Stage-0
model that generates outside Stage I's latent space hands its mesh over: surface samples
encoded by TripoSG's VAE; host clock after a device synchronisation,
``ActionMeshPipeline.stage0_seconds``), summed over the measured window's clips
(untraced: the profiled clip after the window is not counted) and divided by their
count. A clip whose Stage 0 generated in Stage I's own latent space (a ``dit_sample``
and no ``handoff``, as TripoSG's) hands nothing over: 0 s. Nothing in a cell whose
Stage 0 generates nothing ({video + 3D}), or a program without the span tree."""


def read(record: dict):
    vals = []
    for s in record["stage0_seconds"]:
        if "handoff" in s:
            vals.append(s["handoff"])
        elif "dit_sample" in s:
            vals.append(0.0)
        else:
            return None
    if not vals:
        return None
    return sum(vals) / record["clips"]
