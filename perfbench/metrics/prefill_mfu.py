"""prefill_mfu: the model FLOPs of the slice's requests over the slice's
wall seconds (host clock, profiler overhead inside) at the card's dense
bf16 peak, in %.  The family's reference counts the FLOPs from the shapes
alone (2 x matmul parameters x tokens, causal attention, the last-token
unembedding), whatever implements the work."""

from perfbench import peaks


def read(slc):
    if not slc.requests or slc.wall_s <= 0:
        return None
    flops = sum(slc.reference.model_flops(slc.config, B, S) for B, S in slc.requests)
    return 100.0 * flops / (slc.wall_s * peaks.BF16_OPS_PER_S)
