"""attn_device_ms: device milliseconds a request of the operations launched
inside the model stack's ``attn`` spans (``models.layers.attn_apply``: the
QKV projections and bias, rope, the cache write, the attention itself and
the output projection), by ``perfbench/spans.py``'s attribution.  None
without spans, or when no ``attn`` span was traced."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    return att.per_request_ms(att.device_inside, "attn") if att else None
