"""The SLIC k-means kernels' share of their roofline: the least time of a
call's k-means (``counts/slic.py``: its operations at the float32 peak or its
bytes at the HBM peak, the larger) over the device time a call of the
trace's operations whose name holds ``slic_`` (the association, snap-key
and update kernels).  Nothing to read without such operations."""


def read(record):
    p = record.profile
    if p is None or p.calls == 0:
        return None
    ns = sum(end - start for name, start, end in p.device if "slic_" in name)
    if ns == 0:
        return None
    least_s = max(record.ops_per_call / record.peaks["f32_ops_per_s"],
                  record.bytes_per_call / record.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (ns / 1e9 / p.calls)
