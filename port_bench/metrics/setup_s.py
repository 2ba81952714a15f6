"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernels' library (built on a checkout's first run), the
frame pool and the warm-up."""


def read(record):
    return record.setup_s
