"""Co-design service launcher: the micro-batched scoring front door.

  PYTHONPATH=src python -m repro_torch.launch.serve_codesign --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_codesign --smoke --device cpu

Submits a mix of sweep / mega-sweep / frontier requests against one
``CodesignService``, streams mega-sweep shard progress, and prints each
response through the uniform result protocol plus the service's cache
accounting (population hits, memo hits, micro-batched requests, frontier
warm starts).  Validation happens at parse time via the one shared path
(``CodesignSpec.validate`` / ``validate_backend_arg``).  Requests run on
``--device`` (``cuda`` by default: the sweeps through the kernels, the
frontier descents in float64 on the card); ``--device cpu`` runs the
plain version on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core import CodesignSpec, WorkloadProfile
from repro_torch.core.kernels_xp import DEFAULT_DEVICE, validate_backend_arg
from repro_torch.serving.codesign_service import CodesignRequest, CodesignService


def _suites(num_suites: int, apps: int):
    """Deterministic synthetic suites spanning the bottleneck spectrum."""
    out = []
    for s in range(num_suites):
        suite = []
        for a in range(apps):
            k = s * apps + a
            suite.append(WorkloadProfile(
                name=f"suite{s}/app{a}",
                flops=2e14 * (1 + 0.3 * (k % 5)),
                hbm_bytes=1.5e11 * (1 + 0.5 * (k % 3)),
                collective_bytes={"all-reduce": 2e10 * (1 + (k % 4))},
                num_devices=256, model_flops=5e16))
        out.append(suite)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny populations / few steps (CI mode)")
    ap.add_argument("--suites", type=int, default=4,
                    help="concurrent sweep requests (micro-batched)")
    ap.add_argument("--apps", type=int, default=3, help="apps per suite")
    ap.add_argument("--n", type=int, default=None,
                    help="sweep population size (default 256; smoke 32)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--backend", default=None,
                    help="sweep backend: cuda (the kernels) or torch (the "
                         "plain version); default by --device")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where requests run (cuda, or cpu for the plain "
                         "version on the host)")
    ap.add_argument("--budgets", type=float, nargs="*",
                    default=[0.3, 0.6, 1.0], help="frontier area budgets")
    ap.add_argument("--steps", type=int, default=None,
                    help="frontier descent steps (default 40; smoke 4)")
    ap.add_argument("--format", choices=("markdown", "json"),
                    default="markdown")
    ap.add_argument("--top-k", type=int, default=5)
    args = ap.parse_args(argv)
    validate_backend_arg(ap, args.backend)

    n = args.n if args.n is not None else (32 if args.smoke else 256)
    steps = args.steps if args.steps is not None else (4 if args.smoke else 40)
    # Parse-time validation through the one shared path: a bad spec dies
    # here with a usage error, before any service work starts.
    try:
        sweep_spec = CodesignSpec(n=n, seed=0, backend=args.backend).validate()
        frontier_spec = CodesignSpec(
            budgets=args.budgets, steps=steps,
            refine_steps=max(steps // 5, 1)).validate()
    except ValueError as exc:
        ap.error(str(exc))

    svc = CodesignService(workers=args.workers, max_pending=args.max_pending,
                          auto_start=False, device=args.device)
    suites = _suites(args.suites, args.apps)
    t0 = time.perf_counter()

    # Burst of concurrent sweeps: compatible requests ride one SoA pass.
    sweep_jids = [svc.submit(CodesignRequest(kind="sweep", profiles=s,
                                             spec=sweep_spec))
                  for s in suites]
    # A mega-sweep streams shard progress; a frontier seeds the warm cache.
    mega_jid = svc.submit(CodesignRequest(
        kind="mega_sweep", profiles=suites[0], spec=sweep_spec,
        num_shards=4))
    frontier_jid = svc.submit(CodesignRequest(
        kind="frontier", profiles=suites[0][:1], spec=frontier_spec))
    svc.drain()

    for ev in svc.stream(mega_jid):
        if ev["event"] == "shard":
            print(f"mega-sweep shard {ev['shard'] + 1}/{ev['num_shards']} "
                  f"variants [{ev['lo']}, {ev['hi']})")

    # A tighter follow-up schedule warm-starts from the solved frontier.
    warm_jid = svc.submit(CodesignRequest(
        kind="frontier", profiles=suites[0][:1],
        spec=CodesignSpec(budgets=[min(args.budgets) * 0.8], steps=steps,
                          refine_steps=max(steps // 5, 1))))
    svc.drain()
    dt = time.perf_counter() - t0

    for label, jid in ([(f"sweep[{i}]", j)
                        for i, j in enumerate(sweep_jids)][:1]
                       + [("mega_sweep", mega_jid),
                          ("frontier", frontier_jid),
                          ("frontier+warm", warm_jid)]):
        out = svc.render(jid, fmt=args.format, top_k=args.top_k, timeout=5)
        print(f"\n== {label} ({svc.poll(jid)['cache'] or 'cold'}) ==")
        print(out if args.format == "markdown"
              else json.dumps(out, indent=1, default=str)[:2000])

    total = len(sweep_jids) + 3
    print(f"\nserved {total} requests in {dt:.2f}s "
          f"({total / dt:.1f} req/s); stats: {dict(svc.stats)}")
    svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
