"""rope_device_ms: device milliseconds a request of the operations launched
inside the model stack's ``rope`` spans (``models.layers.attn_apply``'s
rotation of q and k, inside ``attn``), by ``perfbench/spans.py``'s
attribution.  None without spans, or when no ``rope`` span was traced."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    return att.per_request_ms(att.device_inside, "rope") if att else None
