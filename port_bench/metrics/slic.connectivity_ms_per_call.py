"""The host's time a call of SLIC's connectivity pass, in ms: the counters
``connectivity_ns`` over ``connectivity_calls`` of the loaded
``models.slic`` module of the port, so every pass of the process, the
warm-up's included (the native library's first build is not in them).
Nothing to read where the module is not loaded, lacks the counters or has
counted no pass."""

import sys

MODULE = "various_image_processings_tpu_torch.models.slic"


def read(record):
    module = sys.modules.get(MODULE)
    ns = getattr(module, "connectivity_ns", None)
    calls = getattr(module, "connectivity_calls", None)
    if type(ns) is not int or type(calls) is not int or calls == 0:
        return None
    return ns / calls / 1e6
