"""``setup_s``: seconds on the host clock from the start of ``run.py`` to
the start of the first timed clip: imports, CUDA context, the kernels'
build-cache load (their build, in a checkout's first run), the traffic and
the weights made from the seed, the pipeline, and the one-step warm-up."""


def read(record: dict):
    return record["setup_s"]
