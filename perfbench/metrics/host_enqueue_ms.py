"""host_enqueue_ms: host milliseconds from the call of
``models.transformer.prefill`` until it returns, before the request's
sync, on the harness's clock: a mean over the traced run's requests
outside the profiler's slice (so the profiler's host cost is left out)."""


def read(slc):
    vals = slc.enqueue_ms_outside
    return sum(vals) / len(vals) if vals else None
