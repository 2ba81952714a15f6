"""Megapixels of every call the window completed over the window's wall time."""


def read(record):
    w = record.window
    return w.calls * record.pixels_per_call / 1e6 / w.seconds
