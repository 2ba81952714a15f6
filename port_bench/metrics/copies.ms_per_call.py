"""The device time a call of the copies between host and device, in ms: the
trace's operations whose name holds ``Memcpy`` (a device-to-device copy
aside) over the calls.  Nothing to read without a trace of the device."""


def read(record):
    p = record.profile
    if p is None or not p.device or p.calls == 0:
        return None
    ns = sum(end - start for name, start, end in p.device
             if "Memcpy" in name and "DtoD" not in name)
    return ns / 1e6 / p.calls
