"""stack_other_ms: device milliseconds a request of the kernels outside
the port's hand-written kernels and the matmuls ("other" and "copy":
weight casts, norms, rope, bias, gating, softmax, conv, copies)."""


def read(slc):
    if not slc.requests or not slc.ops:
        return None
    g = slc.ms_by_group()
    return (g.get("other", 0.0) + g.get("copy", 0.0)) / len(slc.requests)
