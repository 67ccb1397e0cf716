"""prefill_host_self_ms: host milliseconds a request inside the
``prefill`` span less the time inside CUDA runtime and driver calls (the
union of the trace's calls within the span): the program's own host work,
readable where the launch queue fills and the call returns with the
device.  None without spans."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    if att is None or not att.host_self_ns:
        return None
    return sum(att.host_self_ns) / len(att.host_self_ns) / 1e6
