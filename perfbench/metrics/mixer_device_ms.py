"""mixer_device_ms: device milliseconds a request of the operations
launched inside the model stack's ``mixer`` spans
(``models.layers.mamba_apply``: the in projection, the conv, the x / dt
projections, the scan K8 inside its ``scan`` span, the gating and the out
projection), by ``perfbench/spans.py``'s attribution.  None without spans,
or when no ``mixer`` span was traced."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    return att.per_request_ms(att.device_inside, "mixer") if att else None
