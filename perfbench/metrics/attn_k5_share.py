"""attn_k5_share: attention calls that took the flash-attention kernel K5
over all attention calls of the traced requests, in %, from the counters
(``attn.k5``, ``attn.plain``) on each ``prefill`` span.  None without
spans, or where the requests made no attention call."""

from perfbench import spans


def read(slc):
    att = spans.attribution(slc)
    if att is None or not att.counts:
        return None
    k5 = sum(c.get("attn.k5", 0) for c in att.counts)
    calls = k5 + sum(c.get("attn.plain", 0) for c in att.counts)
    return 100.0 * k5 / calls if calls else None
