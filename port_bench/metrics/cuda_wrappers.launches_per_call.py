"""The rise of the kernel wrappers' launch counters over the window, per call."""


def read(record):
    return record.window.launches / record.window.calls
