"""prefill_idle_ms: device idle milliseconds a request during which the
host was inside a ``prefill`` span (``models.transformer.prefill``): idle
that the program, not the harness, causes.  By ``perfbench/spans.py``'s
split of each idle interval; None without spans."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    return att.per_request_ms(att.idle_inside, "prefill") if att else None
