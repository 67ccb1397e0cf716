"""The port's co-design service (``repro_torch.serving.codesign_service``)
and its launcher, with ``device="cpu"``.

* Sweeps and mega-sweeps through the port's service (the plain ``torch``
  version, float64) are held in this process to the JAX package's service
  with ``backend="numpy"`` at rtol 1e-9, fronts and best fits by name,
  shard events exactly.
* Each caller's slice of a micro-batched sweep equals that request run
  alone exactly (the pin the card's run holds too); a repeat is a memo
  hit; a tighter frontier schedule is a warm hit equal to the direct call
  from the cached continuation; every co-design kind equals its direct
  library call; a threaded service (``workers=2``) equals the synchronous
  one (``workers=0``).
* The queue's semantics (overload, expiry, cancellation, streaming) and
  the result protocol, as the JAX package's ``tests/test_serving.py``
  holds them.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import WorkloadProfile as RefWorkloadProfile
from repro.core.spec import CodesignSpec as RefSpec
from repro.serving import codesign_service as RS

import repro_torch.core as P
from repro_torch.core.sweep import MachineBatch
from repro_torch.serving.codesign_service import (
    CANCELLED,
    DONE,
    TIMEOUT,
    CodesignRequest,
    CodesignService,
    JobCancelled,
    JobTimeout,
    ServiceOverloadError,
    render_result,
)
from torch_codesign_reference import params_array, resume_pick

RTOL = 1e-9
SPEC = P.CodesignSpec(n=48, seed=0, backend="torch")


def gen(n, offset=0):
    """``n`` generated apps, renamed so two suites never share a name."""
    return [P.WorkloadProfile.from_json(dict(p.to_json(),
                                             name=f"s{offset}/{p.name}"))
            for p in P.resolve_suite(f"gen:{n + offset}")[offset:]]


def ref_profiles(profiles):
    return [RefWorkloadProfile.from_json(p.to_json()) for p in profiles]


def service(**kw):
    return CodesignService(auto_start=False, device="cpu", **kw)


def sweep_req(profiles, spec=SPEC, **kw):
    return CodesignRequest(kind="sweep", profiles=profiles, spec=spec, **kw)


def direct_sweep(profiles, spec=SPEC, **kw):
    return P.run_sweep(profiles, n=spec.n, seed=spec.seed, backend="torch",
                       device="cpu", beta=spec.beta, **kw)


def assert_sweep_equal(a, b):
    assert a.apps == b.apps
    assert a.machines.names == b.machines.names
    np.testing.assert_array_equal(a.beta, b.beta)
    np.testing.assert_array_equal(a.gamma, b.gamma)
    np.testing.assert_array_equal(a.aggregate, b.aggregate)
    for key in b.scores:
        np.testing.assert_array_equal(a.scores[key], b.scores[key])
    for key in b.alphas:
        np.testing.assert_array_equal(a.alphas[key], b.alphas[key])


def assert_sweep_close(mine, ref):
    """The port's sweep against the JAX package's NumPy one: values at
    1e-9, fronts and best fits by name."""
    assert mine.apps == ref.apps
    assert mine.machines.names == ref.machines.names
    for f in ("beta", "gamma", "aggregate"):
        np.testing.assert_allclose(getattr(mine, f), getattr(ref, f),
                                   rtol=RTOL, err_msg=f)
    for key in ref.scores:
        np.testing.assert_allclose(mine.scores[key], ref.scores[key],
                                   rtol=RTOL, atol=1e-12)
    names = lambda r, idx: [r.machines.names[i] for i in idx]
    assert names(mine, mine.pareto_front()) == names(ref, ref.pareto_front())
    assert (names(mine, mine.pareto_front_3d())
            == names(ref, ref.pareto_front_3d()))
    assert ([mine.best_fit(a) for a in mine.apps]
            == [ref.best_fit(a) for a in ref.apps])


# --------------------------------------------------------------------------- #
# Micro-batching
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sizes", [(3, 5), (1, 2, 4)])
def test_batched_slices_equal_each_request_alone(sizes):
    """Suites of different sizes ride one pass; each caller's slice is the
    request run alone, bit for bit."""
    svc = service()
    suites = [gen(n, offset=10 * i) for i, n in enumerate(sizes)]
    jids = [svc.submit(sweep_req(s)) for s in suites]
    svc.drain()
    assert svc.stats["batched_groups"] == 1
    assert svc.stats["batched_requests"] == len(sizes)
    for s, jid in zip(suites, jids):
        assert_sweep_equal(svc.result(jid, timeout=5), direct_sweep(s))


def test_batched_sweeps_resolve_beta_per_request():
    svc = service()
    a, b = gen(2), gen(3, offset=5)
    j1 = svc.submit(sweep_req(a, P.CodesignSpec(n=48, beta=0.5)))
    j2 = svc.submit(sweep_req(b, P.CodesignSpec(n=48, beta=2.0)))
    svc.drain()
    assert svc.stats["batched_requests"] == 2
    assert_sweep_equal(svc.result(j1, timeout=5),
                       direct_sweep(a, P.CodesignSpec(n=48, seed=0, beta=0.5)))
    assert_sweep_equal(svc.result(j2, timeout=5),
                       direct_sweep(b, P.CodesignSpec(n=48, seed=0, beta=2.0)))


def test_incompatible_sweeps_do_not_batch():
    svc = service()
    svc.submit(sweep_req(gen(2)))
    svc.submit(sweep_req(gen(2, offset=4), P.CodesignSpec(n=64)))
    svc.drain()
    assert svc.stats["batched_groups"] == 0
    assert svc.stats["pop_misses"] == 2


@pytest.mark.parametrize("sizes", [(3,), (2, 4)])
def test_sweeps_match_the_reference_service(sizes):
    """The same requests through the JAX package's service (NumPy float64)
    and the port's (torch float64 on the host)."""
    suites = [gen(n, offset=10 * i) for i, n in enumerate(sizes)]
    mine, theirs = service(), RS.CodesignService(auto_start=False)
    ref_spec = RefSpec(n=48, seed=0, backend="numpy")
    m_jids = [mine.submit(sweep_req(s)) for s in suites]
    r_jids = [theirs.submit(RS.CodesignRequest(
        kind="sweep", profiles=ref_profiles(s), spec=ref_spec))
        for s in suites]
    mine.drain()
    theirs.drain()
    for mj, rj in zip(m_jids, r_jids):
        assert_sweep_close(mine.result(mj, timeout=5),
                           theirs.result(rj, timeout=5))
    for key in ("batched_groups", "batched_requests", "pop_misses"):
        assert mine.stats[key] == theirs.stats[key], key


@pytest.mark.parametrize("stream", [False, True])
def test_mega_sweep_matches_the_reference_service(stream):
    apps = gen(4)
    mine, theirs = service(), RS.CodesignService(auto_start=False)
    m_jid = mine.submit(CodesignRequest(
        kind="mega_sweep", profiles=apps, num_shards=4, stream=stream,
        spec=P.CodesignSpec(n=200, seed=1, backend="torch")))
    r_jid = theirs.submit(RS.CodesignRequest(
        kind="mega_sweep", profiles=ref_profiles(apps), num_shards=4,
        stream=stream, spec=RefSpec(n=200, seed=1, backend="numpy")))
    mine.drain()
    theirs.drain()
    got, want = mine.result(m_jid, timeout=5), theirs.result(r_jid, timeout=5)
    assert got.pareto_names() == want.pareto_names()
    assert got.best_fit_map == want.best_fit_map
    np.testing.assert_array_equal(got.candidate_indices,
                                  want.candidate_indices)
    np.testing.assert_allclose(got.result.aggregate, want.result.aggregate,
                               rtol=RTOL)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "jid"}
                         for e in evs]
    assert strip(mine.stream(m_jid)) == strip(theirs.stream(r_jid))
    assert got.mesh_axis == "cpu"


# --------------------------------------------------------------------------- #
# Caches: memo, populations, frontier continuation, artifacts
# --------------------------------------------------------------------------- #


def test_repeat_request_is_a_memo_hit_with_the_same_result():
    svc = service()
    j1 = svc.submit(sweep_req(gen(3)))
    svc.drain()
    j2 = svc.submit(sweep_req(gen(3)))
    svc.drain()
    assert svc.poll(j2)["cache"] == "memo"
    assert svc.result(j2, timeout=5) is svc.result(j1, timeout=5)
    assert svc.stats["memo_hits"] == 1 and svc.stats["pop_misses"] == 1


def test_population_cache_hits_and_lru_eviction():
    svc = service(pop_cache_bytes=12_000)
    for i, n in enumerate((48, 64, 48)):    # the third: another suite
        svc.submit(sweep_req(gen(2, offset=3 * i), P.CodesignSpec(n=n)))
        svc.drain()
    assert svc.stats["pop_misses"] == 2 and svc.stats["pop_hits"] == 1
    for n in (96, 128):
        svc.submit(sweep_req(gen(2), P.CodesignSpec(n=n)))
        svc.drain()
    assert svc.stats["pop_evictions"] >= 1
    assert svc._pop_bytes <= svc.pop_cache_bytes


FRONTIER_SPEC = P.CodesignSpec(budgets=[0.6, 1.2], steps=4, refine_steps=2)
TIGHT_SPEC = P.CodesignSpec(budgets=[0.2, 0.4], steps=4, refine_steps=2)


def frontier_req(spec, **kw):
    return CodesignRequest(kind="frontier", profiles=gen(2), spec=spec, **kw)


def test_frontier_cold_then_warm_hit_equal_the_direct_calls():
    """The first request equals ``frontier_codesign`` on the named seeds;
    a tighter schedule is a warm hit, equal to the direct call resumed from
    the first one's continuation at the budget the cache picks."""
    svc = service()
    j1 = svc.submit(frontier_req(FRONTIER_SPEC))
    svc.drain()
    seeds = MachineBatch.from_models(P.VARIANTS)
    cold = P.frontier_codesign(gen(2), seeds, spec=FRONTIER_SPEC,
                               keep_state=True, device="cpu")
    first = svc.result(j1, timeout=5)
    np.testing.assert_array_equal(first.objective, cold.objective)
    assert first.best_names == cold.best_names
    assert svc.stats["frontier_warm_misses"] == 1

    j2 = svc.submit(frontier_req(TIGHT_SPEC))
    svc.drain()
    assert svc.stats["frontier_warm_hits"] == 1
    assert svc.poll(j2)["cache"] == "warm"
    pick = resume_pick(cold.continuation, TIGHT_SPEC.budgets)
    direct = P.frontier_codesign(gen(2), seeds, spec=TIGHT_SPEC,
                                 warm_theta=cold.continuation[pick],
                                 warm_lr=cold.final_lr, keep_state=True,
                                 device="cpu")
    warm = svc.result(j2, timeout=5)
    np.testing.assert_array_equal(warm.objective, direct.objective)
    np.testing.assert_array_equal(params_array(warm.best_params),
                                  params_array(direct.best_params))
    # opting out runs cold and skips the cache
    j3 = svc.submit(frontier_req(TIGHT_SPEC, warm=False))
    svc.drain()
    plain = P.frontier_codesign(gen(2), seeds, spec=TIGHT_SPEC, device="cpu")
    np.testing.assert_array_equal(svc.result(j3, timeout=5).objective,
                                  plain.objective)


def test_repeat_frontier_is_a_memo_hit():
    svc = service()
    j1 = svc.submit(frontier_req(FRONTIER_SPEC))
    svc.drain()
    j2 = svc.submit(frontier_req(FRONTIER_SPEC))
    svc.drain()
    assert svc.result(j2, timeout=5) is svc.result(j1, timeout=5)
    assert svc.stats["memo_hits"] == 1


def test_artifacts_record_the_backend_actually_used():
    """Repeat shapes count as artifact hits, keyed by the port's backend
    names: ``torch`` for a sweep on the host (``cuda`` on a card) and for
    every descent."""
    svc = service()
    svc.submit(sweep_req(gen(2)))
    svc.drain()
    svc.submit(sweep_req(gen(2, offset=3)))
    svc.drain()
    assert svc.stats["artifact_misses"] == 1
    assert svc.stats["artifact_hits"] == 1
    assert svc._backend_name(None) == "torch"
    assert svc._backend_name("torch") == "torch"
    assert CodesignService.DESCENT_BACKEND == "torch"
    seen = []
    svc._note_artifact = lambda kind, shape, backend, sig: seen.append(
        (kind, backend))
    svc.submit(CodesignRequest(kind="constrained", profiles=gen(1),
                               spec=P.CodesignSpec(area_budget=1.0, steps=1)))
    svc.submit(CodesignRequest(kind="mega_sweep", profiles=gen(1),
                               spec=P.CodesignSpec(n=16), num_shards=2))
    svc.drain()
    assert seen == [("constrained", "torch"), ("mega_sweep", "torch")]


# --------------------------------------------------------------------------- #
# Every co-design kind equals its direct call
# --------------------------------------------------------------------------- #

#: kind -> (profiles, spec, direct call)
KINDS = {
    "constrained": (lambda: gen(3), P.CodesignSpec(area_budget=1.0, steps=5),
                    lambda p, s, m: P.constrained_codesign(p, m, spec=s,
                                                           device="cpu")),
    "joint": (lambda: [gen(2), gen(2, offset=3)],
              P.CodesignSpec(mode="alternate", steps=6),
              lambda p, s, m: P.joint_codesign(p, m, spec=s, device="cpu")),
    "pack": (lambda: gen(6), P.CodesignSpec(steps=4, num_machines=2,
                                            beta=1.5),
             lambda p, s, m: P.pack_codesign(p, m, spec=s, device="cpu")),
    "bilevel": (lambda: gen(2),
                P.CodesignSpec(total_budget=0.8, outer_steps=1, steps=1,
                               projection="shift"),
                lambda p, s, m: P.bilevel_codesign(p, m, spec=s,
                                                   device="cpu")),
}


@pytest.mark.parametrize("kind", KINDS)
def test_codesign_kinds_equal_their_direct_calls(kind):
    make, spec, direct = KINDS[kind]
    svc = service()
    jid = svc.submit(CodesignRequest(kind=kind, profiles=make(), spec=spec))
    svc.drain()
    got = svc.result(jid, timeout=5)
    want = direct(make(), spec, MachineBatch.from_models(P.VARIANTS))
    assert got.to_json(top_k=4) == want.to_json(top_k=4)
    assert isinstance(render_result(got, top_k=2), str)
    json.dumps(render_result(got, "json", top_k=2))
    again = svc.submit(CodesignRequest(kind=kind, profiles=make(), spec=spec))
    svc.drain()
    assert svc.result(again, timeout=5) is got


def test_bilevel_request_needs_a_total_budget():
    svc = service()
    jid = svc.submit(CodesignRequest(kind="bilevel", profiles=gen(1),
                                     spec=P.CodesignSpec(steps=2)))
    svc.drain()
    with pytest.raises(ValueError, match="total_budget"):
        svc.result(jid, timeout=5)


# --------------------------------------------------------------------------- #
# Threads
# --------------------------------------------------------------------------- #


def test_threaded_service_equals_the_synchronous_one():
    """``workers=2`` runs the same sweep and frontier requests as
    ``workers=0`` and gives the same results."""
    reqs = lambda: ([sweep_req(gen(2, offset=4 * i)) for i in range(4)]
                    + [frontier_req(FRONTIER_SPEC)])
    sync = service()
    s_jids = [sync.submit(r) for r in reqs()]
    sync.drain()
    threaded = CodesignService(workers=2, max_pending=16, device="cpu")
    try:
        t_jids = [threaded.submit(r) for r in reqs()]
        results = {}

        def wait(jid):
            results[jid] = threaded.result(jid, timeout=120)

        waiters = [threading.Thread(target=wait, args=(j,)) for j in t_jids]
        for t in waiters:
            t.start()
        for t in waiters:
            t.join(timeout=120)
    finally:
        threaded.shutdown()
    assert len(results) == len(t_jids)
    for sj, tj in zip(s_jids[:-1], t_jids[:-1]):
        assert_sweep_equal(results[tj], sync.result(sj, timeout=5))
    np.testing.assert_array_equal(results[t_jids[-1]].objective,
                                  sync.result(s_jids[-1], timeout=5).objective)


# --------------------------------------------------------------------------- #
# Queue semantics and the result protocol
# --------------------------------------------------------------------------- #


def test_overload_rejects_429_style():
    svc = service(max_pending=2)
    svc.submit(sweep_req(gen(1)))
    svc.submit(sweep_req(gen(1, offset=2)))
    with pytest.raises(ServiceOverloadError) as ei:
        svc.submit(sweep_req(gen(1, offset=4)))
    assert ei.value.status_code == 429 and svc.stats["rejected"] == 1
    svc.drain()
    svc.submit(sweep_req(gen(1, offset=4)))
    svc.drain()
    assert svc.stats[DONE] == 3


def test_expired_job_times_out_at_dispatch():
    svc = service()
    jid = svc.submit(sweep_req(gen(1), timeout=1e-9))
    time.sleep(0.01)
    svc.drain()
    assert svc.poll(jid)["state"] == TIMEOUT
    with pytest.raises(JobTimeout):
        svc.result(jid, timeout=1)


def test_cancel_pending_job():
    svc = service()
    jid = svc.submit(sweep_req(gen(1)))
    assert svc.cancel(jid)
    svc.drain()
    assert svc.poll(jid)["state"] == CANCELLED and svc.stats[DONE] == 0
    with pytest.raises(JobCancelled):
        svc.result(jid, timeout=1)
    assert not svc.cancel(jid)


def test_cancel_running_mega_sweep_aborts_between_shards():
    svc = service()
    jid = svc.submit(CodesignRequest(kind="mega_sweep", profiles=gen(1),
                                     spec=P.CodesignSpec(n=64),
                                     num_shards=4))
    svc._jobs[jid].cancel_requested = True
    svc.drain()
    assert svc.poll(jid)["state"] == CANCELLED
    events = list(svc.stream(jid))
    assert events[-1]["event"] == CANCELLED
    assert sum(e["event"] == "shard" for e in events) <= 1


def test_mega_sweep_streams_shard_progress_in_order():
    svc = service()
    jid = svc.submit(CodesignRequest(kind="mega_sweep", profiles=gen(2),
                                     spec=P.CodesignSpec(n=64, seed=1),
                                     num_shards=4))
    svc.drain()
    events = list(svc.stream(jid))
    shards = [e for e in events if e["event"] == "shard"]
    assert [s["shard"] for s in shards] == [0, 1, 2, 3]
    assert shards[-1]["hi"] == 64 and events[-1]["event"] == DONE
    md = svc.render(jid, fmt="markdown", top_k=3, timeout=5)
    assert "sharded sweep" in md
    json.dumps(svc.render(jid, fmt="json", top_k=3, timeout=5))


def test_render_rejects_non_protocol_results():
    with pytest.raises(TypeError, match="result protocol"):
        render_result(object(), "markdown")
    with pytest.raises(ValueError, match="unknown render format"):
        render_result(direct_sweep(gen(1)), "yaml")


@pytest.mark.parametrize("kw,match", [
    (dict(kind="bogus", profiles=[]), "unknown request kind"),
    (dict(kind="sweep", profiles=[], spec=P.CodesignSpec(backend="numpy")),
     "unknown backend"),
    (dict(kind="sweep", profiles=None), "profiles is required"),
])
def test_request_validates_at_construction(kw, match):
    with pytest.raises(ValueError, match=match):
        CodesignRequest(**kw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert CodesignService(auto_start=False).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CodesignService(auto_start=False)


def test_launcher_smoke_on_the_cpu(capsys):
    from repro_torch.launch import serve_codesign

    assert serve_codesign.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mega-sweep shard 4/4" in out and "frontier+warm (warm)" in out
    assert "'batched_requests': 4" in out


def test_launcher_rejects_a_jax_backend_name():
    from repro_torch.launch import serve_codesign

    with pytest.raises(SystemExit):
        serve_codesign.main(["--smoke", "--device", "cpu", "--backend",
                             "numpy"])


@pytest.mark.cuda
def test_batched_slices_on_card_equal_each_request_alone():
    """On the card the sweep runs K3 and K1; each slice equals the request
    run alone exactly, whatever rows share the pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the service's default device")
    svc = CodesignService(auto_start=False)
    spec = P.CodesignSpec(n=1000, seed=0)
    suites = [gen(3), gen(5, offset=10)]
    jids = [svc.submit(sweep_req(s, spec)) for s in suites]
    svc.drain()
    assert svc.stats["batched_requests"] == 2
    for s, jid in zip(suites, jids):
        alone = P.run_sweep(s, n=1000, seed=0)
        assert alone.backend == "cuda"
        assert_sweep_equal(svc.result(jid, timeout=5), alone)
