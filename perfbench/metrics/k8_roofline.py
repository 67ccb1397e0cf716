"""k8_roofline: the least time of the slice's K8 launches (the
frozen ``scan_bound`` of ``perfbench/kernels/k8.py``, at the launches'
shapes: bf16 xi, B and C, float32 dt and y, a state in and out) over
their device time, in %.  Each request of the slice launches K8 once a
layer at its (B, S); the bound a launch is their mean, times the launches
the trace holds.  Nothing when the trace holds no K8 launch."""


def read(slc):
    k8 = slc.kernel("K8")
    ops = [o for o in slc.ops if o.group == "K8"]
    if k8 is None or not ops or not slc.requests:
        return None
    sizes = slc.reference.sizes(slc.config)
    din, n = sizes["d_inner"], sizes["state"]
    bounds = [k8.scan_bound(B, S, din, n, 2, 4, 4, True)[0] for B, S in slc.requests]
    per_launch_ms = sum(bounds) / len(bounds)
    device_ms = sum(o.us for o in ops) / 1e3
    return 100.0 * per_launch_ms * len(ops) / device_ms
