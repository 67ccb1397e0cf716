"""k5_roofline: the least time of the slice's K5 launches (the frozen
``attention_bound`` of ``perfbench/kernels/k5.py``, at the launches'
shapes: bf16 q, k, v and output, causal self-attention of a request's S
rows over the S cache rows it has just written) over their device time,
in %.  Each request of the slice launches K5 once a layer at its (B, S),
with the reference's heads, KV heads and head dim; the bound a launch is
their mean, times the launches the trace holds.  Nothing when the trace
holds no K5 launch."""


def read(slc):
    k5 = slc.kernel("K5")
    ops = [o for o in slc.ops if o.group == "K5"]
    if k5 is None or not ops or not slc.requests:
        return None
    sizes = slc.reference.sizes(slc.config)
    H, K, D = sizes["heads"], sizes["kv_heads"], sizes["head_dim"]
    bounds = [k5.attention_bound(B, H, K, S, S, D, True, None, "bfloat16")[0]
              for B, S in slc.requests]
    per_launch_ms = sum(bounds) / len(bounds)
    device_ms = sum(o.us for o in ops) / 1e3
    return 100.0 * per_launch_ms * len(ops) / device_ms
