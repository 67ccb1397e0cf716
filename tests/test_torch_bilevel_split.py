"""A bilevel split that does not move, in both packages (ROADMAP R16).

On the hillclimb launcher's flash profile of chatglm3-6b's train_4k (the
port's op counts on ``meta``, one device, the K5 substitution applied) and
the three named seeds, ``bilevel_codesign`` leaves the area / power split
of a total budget at the uniform 0.5 and its J* where it started, at every
outer step.  The JAX package (``tests/torch_codesign_reference.py``, entry
``hillclimb``, wrapper ``codesign_bilevel``) does the same on the same
profile, seeds and totals: the port reproduces the reference, so this is
no fault of the port.  At these totals the inner optimum leaves both
budgets slack (shadow prices 0), so dJ*/ds is 0 and no outer step is
taken.
"""

import numpy as np
import pytest

from repro_torch import configs as C
from repro_torch.configs.shapes import resolve_shape
from repro_torch.core import implicit as PI
from repro_torch.launch import hillclimb as HC
from torch_codesign_reference import run_reference

TOTALS = (0.3, 1.0)
INNER_STEPS, OUTER_STEPS = 5, 2
RTOL = 1e-9


@pytest.fixture(scope="module")
def flash_profile():
    """The launcher's ``--mode flash`` profile (its steps 1-2)."""
    cfg, shape = C.get_config("chatglm3-6b"), resolve_shape("train_4k")
    prof = HC.run_cell(cfg, shape, device="meta")
    L = HC.attention_layers(cfg)
    added = HC.flash_kernel_bytes_per_layer(cfg, shape, 1) * L
    removed = HC.quadratic_attention_bytes(cfg, shape) / 2.0 * L
    prof.hbm_bytes = max(prof.hbm_bytes - removed + added, added)
    prof.name += "+flash"
    prof.meta = {}
    return prof


@pytest.fixture(scope="module")
def reference(flash_profile, tmp_path_factory):
    cases = {f"t{i}": {"entry": "hillclimb", "fn": "codesign_bilevel",
                       "args": [t, INNER_STEPS], "kwargs": {},
                       "profiles": [flash_profile.to_json()],
                       "bilevel_defaults": {"outer_steps": OUTER_STEPS}}
             for i, t in enumerate(TOTALS)}
    return run_reference(cases, tmp_path_factory.mktemp("ref_bilevel_split"))


@pytest.mark.parametrize("i", range(len(TOTALS)))
def test_the_split_stays_uniform_in_both_packages(flash_profile, reference,
                                                  monkeypatch, i):
    monkeypatch.setitem(PI._BILEVEL_DEFAULTS, "outer_steps", OUTER_STEPS)
    res = HC.codesign_bilevel(flash_profile, TOTALS[i], INNER_STEPS, device="cpu")
    ref = reference[f"t{i}"][0]
    np.testing.assert_array_equal(ref["split_trajectory"], 0.5)
    np.testing.assert_array_equal(res.split_trajectory, 0.5)
    np.testing.assert_allclose(res.objective_trajectory, ref["objective_trajectory"],
                               rtol=RTOL)
    assert np.ptp(res.objective_trajectory) == 0.0
