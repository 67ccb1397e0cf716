"""mlp_device_ms: device milliseconds a request of the operations launched
inside the model stack's ``mlp`` spans (``models.layers.mlp_apply``: the
gate, up and down projections and the activation), by
``perfbench/spans.py``'s attribution.  None without spans, or when no
``mlp`` span was traced."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    return att.per_request_ms(att.device_inside, "mlp") if att else None
