"""The comparison that decides ``correct``: a request the timed path
served, held against the family's plain reference run over the same
token ids and weights.

Numbers compared (each against its limit in
``perfbench/limits/<cell>.json``), the worst over the compared requests:

  ``logits_err``   max over rows of max |logits - reference| / the
                   reference row's standard deviation;
  ``<entry>_err``  for each cache entry the request wrote (k and v, or
                   conv and ssm): the worst layer's ||cache - reference|| /
                   ||reference||.
"""

from __future__ import annotations

from typing import Dict


def compare(reference, weights: dict, config: dict, served: dict) -> Dict[str, float]:
    """``served``: ``tokens`` (B, S), ``logits`` (B, V) and ``cache``
    ({entry: (layers, B, ...)}) of one request."""
    worst: Dict[str, float] = {name: 0.0 for name in served["cache"]}

    def on_layer(i, entries):
        for name, want in entries.items():
            got = served["cache"][name][i].float()
            err = (got - want).norm() / want.norm().clamp_min(1e-30)
            worst[name] = max(worst[name], float(err))

    ref = reference.prefill(weights, config, served["tokens"], on_layer=on_layer)
    logits = served["logits"].reshape(ref.shape).float()
    out = {"logits_err": float(((logits - ref).abs().amax(dim=-1) / ref.std(dim=-1)).max())}
    out.update({f"{name}_err": v for name, v in worst.items()})
    return out


def worst_of(readings) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limit has its number and no number exceeds it (a
    NaN exceeds any limit)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
