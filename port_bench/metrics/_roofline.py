"""The kernels' share of the roofline, which ``kernels.call_roofline`` and
``kernels.short_call_roofline`` read: the call's least time on the card
(the larger of its operations at the float32 peak and its bytes at the HBM
peak; counts/) over the device time of a call: every device operation of
the profiled window, whatever its name, over the calls.  Nothing to read
without device operations."""


def read(record):
    p = record.profile
    if p is None or not p.device or p.calls == 0:
        return None
    device_s = sum(end - start for _, start, end in p.device) / 1e9 / p.calls
    least_s = max(record.ops_per_call / record.peaks["f32_ops_per_s"],
                  record.bytes_per_call / record.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / device_s
