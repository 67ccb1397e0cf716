"""The port's ``core.roofline`` against the JAX package's, on the CPU.

``analyze`` on the same profiles and machines gives every field of the
JAX package's report to 1e-12 relative (both are the same NumPy float64
operations), with NaN and inf where the JAX package has them;
``markdown_table`` gives the same string; ``as_dict`` / ``from_dict`` round
trip, strict-JSON-safe; ``model_flops_for`` gives the same numbers.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

import repro.core as R
from repro.core import roofline as RR
from repro.core.model_zoo import resolve_suite as ref_resolve_suite

import repro_torch.core as P
from repro_torch.core import roofline as PR
from test_torch_backend import both_profiles, profile_dicts

RTOL = 1e-12


def _machines():
    """(reference, port) machine pairs: the named variants, idealized ones,
    and rate-zero machines (inf / nan terms)."""
    pairs = [(r, p) for r, p in zip(R.VARIANTS, P.VARIANTS)]
    for sub in ("compute", "memory"):
        pairs.append((R.TPU_V5E.idealized(R.Subsystem(sub)),
                      P.TPU_V5E.idealized(P.Subsystem(sub))))
    for field in ("hbm_bw", "ici_bw"):
        pairs.append((dataclasses.replace(R.TPU_V5E, **{field: 0.0}),
                      dataclasses.replace(P.TPU_V5E, **{field: 0.0})))
    return pairs


def _profiles():
    ref, port = both_profiles(profile_dicts(12, seed=4))
    # a zero-FLOP cell and a zero-device one (nan ratios)
    zero = dict(name="idle", flops=0.0, bytes_accessed=1e6, model_flops=0.0,
                collective_bytes={"all-reduce": 0.0})
    r0, p0 = both_profiles([zero, dict(zero, name="nodev", num_devices=0,
                                       model_flops=1e9)])
    ref += r0
    port += p0
    smoke_ref = ref_resolve_suite("zoo-smoke")
    ref += smoke_ref
    port += [P.WorkloadProfile.from_json(p.to_json()) for p in smoke_ref]
    return ref, port


def _same(a, b, what):
    if isinstance(b, float):
        if math.isnan(b):
            assert math.isnan(a), what
        elif math.isinf(b):
            assert a == b, what
        else:
            assert abs(a - b) <= RTOL * abs(b), (what, a, b)
    else:
        assert a == b, what


@pytest.mark.parametrize("mi", range(len(_machines())))
def test_analyze_matches_reference(mi):
    rm, pm = _machines()[mi]
    ref, port = _profiles()
    n_nonfinite = 0
    for rp, pp in zip(ref, port):
        want, got = RR.analyze(rp, rm), PR.analyze(pp, pm)
        for f in dataclasses.fields(RR.RooflineReport):
            _same(getattr(got, f.name), getattr(want, f.name), f"{rp.name}.{f.name}")
            v = getattr(want, f.name)
            n_nonfinite += isinstance(v, float) and not math.isfinite(v)
        assert got.one_liner() == want.one_liner()
    assert n_nonfinite > 0   # the zero-FLOP / zero-device cells reach nan


def test_zero_peak_flops_raises_as_the_reference_does():
    """A machine with no FLOP rate divides the ideal time by zero in Python
    floats: ``ZeroDivisionError`` in both packages."""
    ref, port = _profiles()
    with pytest.raises(ZeroDivisionError):
        RR.analyze(ref[-1], dataclasses.replace(R.TPU_V5E, peak_flops=0.0))
    with pytest.raises(ZeroDivisionError):
        PR.analyze(port[-1], dataclasses.replace(P.TPU_V5E, peak_flops=0.0))


def test_markdown_table_matches_reference():
    ref, port = _profiles()
    for (rm, pm) in _machines()[:3]:
        want = RR.markdown_table([RR.analyze(p, rm) for p in ref], title=rm.name)
        got = PR.markdown_table([PR.analyze(p, pm) for p in port], title=pm.name)
        assert got == want
    assert PR.markdown_table([]) == RR.markdown_table([])


@pytest.mark.parametrize("mi", [0, len(_machines()) - 2, len(_machines()) - 1])
def test_report_round_trips_strict_json(mi):
    _, pm = _machines()[mi]
    _, port = _profiles()
    for p in port:
        rep = PR.analyze(p, pm)
        d = rep.as_dict()
        text = json.dumps(d, allow_nan=False)
        back = PR.RooflineReport.from_dict(json.loads(text))
        for f in dataclasses.fields(PR.RooflineReport):
            _same(getattr(back, f.name), getattr(rep, f.name), f.name)
    rep = dataclasses.replace(PR.analyze(port[0], pm), mfu_bound=-math.inf,
                              roofline_fraction=math.nan)
    d = rep.as_dict()
    assert d["mfu_bound"] == "-inf" and d["roofline_fraction"] == "nan"
    with pytest.raises(ValueError, match="unknown RooflineReport fields"):
        PR.RooflineReport.from_dict(dict(d, bogus=1.0))


@pytest.mark.parametrize("kind", ["train", "infer", "prefill", "decode"])
def test_model_flops_for_matches_reference(kind):
    rng = np.random.default_rng(0)
    for _ in range(20):
        n, t = float(10 ** rng.uniform(5, 12)), int(rng.integers(1, 10 ** 7))
        assert PR.model_flops_for(params_active=n, tokens=t, step_kind=kind) == \
            RR.model_flops_for(params_active=n, tokens=t, step_kind=kind)
