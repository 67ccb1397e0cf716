"""Hillclimb launcher: a measured kernel substitution into a dry-run profile,
then co-design on the result (the JAX package's ``repro/launch/hillclimb.py``).

The dry-run profile of one (arch, shape) cell counts the plain attention:
its (S x T) score tensors cross kernel boundaries in every layer.  The
flash-attention kernel K5 keeps score tiles on chip, so with it a layer's
attention traffic collapses to the q/k/v/o streams.  Likewise the plain SSM
scan materialises its (S, B, Din, N) discretised state buffers, which the
selective-scan kernel K8 keeps in registers.

Method (measured, not hand-modelled): attention-score traffic is the only
HBM component quadratic in sequence length.  Three depth-2 probes at S,
S/2 and S/4 are counted and ``h(s) = c + a*s + q*s^2`` is fitted; ``q*S^2``
is the score traffic of two layers, which the substitution removes and
replaces with the kernel's linear q/k/v/o traffic.  For ``--mode scan`` two
probes at state dims N and N/2 isolate the traffic proportional to N.
FLOPs are untouched (the kernel does the same math).

The port counts with ``core.costs.OpCounter`` (``launch.extract.run_cell``)
where the JAX package compiles and reads XLA's cost analysis.  XLA's counts
are approximate, which is why the JAX package fits; the op counter's are
exact polynomials in S, so here the fit is exact (the mask build and the
softmax's decomposition also scale as S^2 and are score traffic too).  The
probes and the baseline run on ``--extract-device`` (``meta`` by default:
the dry run, nothing allocated) with the plain attention and the plain scan
(``attn_impl="xla"``, every registry config's default).  K5-K8 launch
through ``ctypes`` (``core/_build.py``), which the op counter's dispatch
mode does not see: under ``attn_impl="pallas"`` the fitted S^2 term would
vanish and the substitution would only add bytes, so such a config is
refused.

``--mesh pod`` (16 x 16, the default, as in the JAX launcher) or
``multipod`` (2 x 16 x 16), the production meshes, profile the cell per
device with its collectives under ``--variant`` (default
``default_variant``) on ``meta`` in a fake process group
(``launch.mesh.fake_world``), the probes too, and the kernel's q/k/v/o
traffic is divided over the mesh's devices, as there; ``--mesh AxB`` /
``AxBxC`` takes a small mesh of that shape (``("data", "model")`` /
``("pod", "data", "model")``, B x C devices a pod), and ``--mesh 1x1``
profiles the whole model as one device (on any ``--extract-device``).
``--joint`` (with ``--grad``) profiles the cell under the other sharding
variants too and hands the group to the joint (machine, sharding-variant)
descent; it needs a mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch chatglm3-6b \\
      --shape train_4k [--moe-impl capacity] [--out DIR] \\
      [--mesh pod|multipod|1x1] [--variant fsdp] [--joint] \\
      [--sweep N [--backend cuda|torch]] [--grad STEPS] [--device cpu]

Co-design modes (after the kernel substitution), on ``--device`` (the card
unless ``cpu`` is asked for; the descents in float64):
  --sweep N      score N generated machine variants (K3 then K1 on the
                 card) and report best fit + Pareto front.
  --grad STEPS   continuous co-design: autograd of the scalarized
                 (congruence, area, power) objective, descending machine
                 log-rates from the named-variant seeds.
  --area-budget B / --power-budget P
                 constrain --grad to CostModel.area(m) <= B (and/or
                 power <= P) via repro_torch.core.constrained;
                 --constraint-mode picks projected gradient (default) or
                 augmented Lagrangian, --opt-links relaxes ici_links
                 continuously and rounds with repair.
  --budget-sweep LO:HI:N
                 trace the feasibility frontier J*(budget) over N area
                 budgets from LO to HI by warm-started continuation
                 (repro_torch.core.frontier) instead of a single budgeted
                 run.
  --area-envelope K=V[,K=V...]
                 per-subsystem area envelopes (e.g. peak_flops=1.5,
                 hbm_bw=0.8) added as one constraint per entry to --grad
                 descent or to every --budget-sweep point.
  --sensitivities
                 KKT shadow prices at a budgeted --grad optimum.
  --bilevel T    split one total silicon budget T between area and power
                 through the inner constrained optimum.
  --pack M       multi-tenant packing: place the optimized profile plus
                 --pack-gen generated co-tenant workloads across M
                 machine instances (repro_torch.core.packing); scalar
                 budgets read as fleet TOTALS in this mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeSpec, resolve_shape
from repro_torch.core import machine as M
from repro_torch.core import roofline as R
from repro_torch.core.kernels_xp import DEFAULT_DEVICE
from repro_torch.distributed.sharding import SHARDING_VARIANTS
from repro_torch.launch import mesh as MESH
from repro_torch.launch.extract import MESH_LABEL, default_variant, run_cell
from repro_torch.models.config import Family

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "repro_torch", "hillclimb")

#: Where the probes and the baseline run unless told otherwise: the dry run.
EXTRACT_DEVICE = "meta"

#: --mesh's names for the production meshes, and their profile labels.
PRODUCTION_MESHES = {"pod": ("pod16x16", (16, 16)),
                     "multipod": ("pods2x16x16", (2, 16, 16))}


def _probe_cfg(cfg, depth):
    """``cfg`` at ``depth`` layers with every chunking off (the JAX
    package's ``launch/extract.py`` probe config)."""
    c = cfg.replace(n_layers=depth, scan_layers=False, logits_chunk=0,
                    attn_q_chunk=0)
    if cfg.family == Family.AUDIO:
        c = c.replace(n_encoder_layers=depth)
    if cfg.ssm is not None:
        c = c.replace(ssm=dataclasses.replace(cfg.ssm, scan_chunk=1 << 30))
    return c


def cell_mesh(name: str):
    """--mesh ``name`` -> (label, ``DeviceMesh``, multi_pod, devices a pod)
    in the fake world, or None for ``1x1``."""
    if name == MESH_LABEL:
        return None
    label, shape = PRODUCTION_MESHES.get(name, (name, None))
    if shape is None:
        shape = tuple(int(d) for d in name.split("x"))
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh {name!r}: give pod, multipod, AxB or AxBxC")
    multi = len(shape) == 3
    axes = ("pod", "data", "model") if multi else ("data", "model")
    n = int(np.prod(shape))
    MESH.fake_world(n)
    dpp = int(np.prod(shape[1:])) if multi else 0
    return label, MESH.make_mesh(shape, axes), multi, dpp


def _run(cfg, shape, device, where=None, variant=None):
    """``run_cell`` on one device, or on ``where`` (``cell_mesh``'s)."""
    if where is None:
        return run_cell(cfg, shape, device=device)
    label, mesh, multi, dpp = where
    return run_cell(cfg, shape, device=device, mesh=mesh, mesh_label=label,
                    variant=variant, multi_pod=multi, devices_per_pod=dpp)


def _probe_hbm(cfg, shape, seq_len: int, batch: int, state_dim: int = 0, *,
               device=EXTRACT_DEVICE, where=None, variant=None) -> float:
    """``hbm_bytes`` of the depth-2 probe at (``seq_len``, ``batch``) and,
    for the SSM, ``state_dim`` (per device on ``where``).  A config whose
    attention or scan runs as a kernel is refused (module docstring)."""
    if cfg.attn_impl != "xla":
        raise ValueError(
            f"{cfg.name}: attn_impl={cfg.attn_impl!r}; the substitution "
            "probes count the plain attention and scan (attn_impl='xla'): "
            "K5-K8 launch through ctypes, which the op counter does not see, "
            "so their S^2 / N terms would not be measured")
    pshape = ShapeSpec(shape.name, seq_len, batch, shape.kind)
    pcfg = _probe_cfg(cfg, 2)
    if state_dim and pcfg.ssm is not None:
        pcfg = pcfg.replace(
            ssm=dataclasses.replace(pcfg.ssm, state_dim=state_dim))
    return _run(pcfg, pshape, device, where, variant).hbm_bytes


def quadratic_attention_bytes(cfg, shape, *, device=EXTRACT_DEVICE, where=None,
                              variant=None) -> float:
    """q*S^2 for the 2-layer probe: measured score-related HBM traffic."""
    S, B = shape.seq_len, shape.global_batch
    ss = np.array([S, S // 2, S // 4], dtype=np.float64)
    hs = np.array([_probe_hbm(cfg, shape, int(s), B, device=device, where=where,
                              variant=variant)
                   for s in ss])
    coeffs = np.polyfit(ss, hs, 2)  # [q, a, c]
    q = max(coeffs[0], 0.0)
    return float(q * S * S)


def flash_kernel_bytes_per_layer(cfg, shape, n_dev: int = 1) -> float:
    """Linear q/k/v/o HBM traffic of the flash kernel (fwd+bwd), per device."""
    B, S = shape.global_batch, shape.seq_len
    bytes_q = B * S * cfg.q_dim * 2       # bf16
    bytes_kv = 2 * B * S * cfg.kv_dim * 2
    # fwd: read q,k,v write o ; bwd: read q,k,v,o,do write dq,dk,dv (+lse)
    total = 4 * (bytes_q * 2 + bytes_kv) if shape.kind == "train" else (
        bytes_q * 2 + bytes_kv)
    return total / n_dev


def scan_state_bytes(cfg, shape, *, device=EXTRACT_DEVICE, where=None,
                     variant=None) -> float:
    """Measured HBM traffic proportional to the SSM state dim N for the
    2-layer probe: the dA/dBx/h buffers the selective-scan kernel keeps on
    chip, and the B / C projections, which scale with N too."""
    N = cfg.ssm.state_dim
    S, B = shape.seq_len, shape.global_batch
    kw = dict(device=device, where=where, variant=variant)
    h_full = _probe_hbm(cfg, shape, S, B, state_dim=N, **kw)
    h_half = _probe_hbm(cfg, shape, S, B, state_dim=N // 2, **kw)
    per_n = (h_full - h_half) / (N - N // 2)
    return max(per_n * N, 0.0)


def scan_kernel_bytes_per_layer(cfg, shape, n_dev: int = 1) -> float:
    """Linear xi/dt/B/C/y traffic of the scan kernel, per device."""
    B, S = shape.global_batch, shape.seq_len
    d_in = cfg.ssm.expand * cfg.d_model
    n = cfg.ssm.state_dim
    io = B * S * (3 * d_in + 2 * n) * 2  # xi, dt, y (d_in) + B, C (n), bf16
    mult = 3.0 if shape.kind == "train" else 1.0
    return io * mult / n_dev


def machine_candidates(n: int, seed: int = 0):
    """Candidate generator for the co-design step: the paper's three named
    variants plus ``n`` low-discrepancy designs from the default ParamSpace.

    The named variants come first so the batched default-beta reference
    stays the baseline chip (same convention as ``dse.evaluate``)."""
    from repro_torch.core.sweep import MachineBatch, ParamSpace

    return MachineBatch.concat(
        MachineBatch.from_models(M.VARIANTS),
        ParamSpace.default().sample(n, seed=seed))


def _seeds():
    from repro_torch.core.sweep import MachineBatch

    return MachineBatch.from_models(M.VARIANTS)


def codesign_sweep(profile, n: int, seed: int = 0, backend: str = None, *,
                   device=DEFAULT_DEVICE) -> dict:
    """Score one profile against a sweep population and summarize the
    co-design answer: best-fit variant + (area, congruence) Pareto front.
    On the card the default backend is ``cuda`` (K3, then K1)."""
    from repro_torch.core.sweep import batched_congruence

    machines = machine_candidates(n, seed=seed)
    res = batched_congruence([profile], machines, clamp=True,
                             backend=backend, device=device)
    best = int(res.best_fit_indices()[0])
    front = res.pareto_front()
    return {
        "num_variants": len(machines),
        "backend": res.backend,
        "best_variant": machines.names[best],
        "best_aggregate": float(res.aggregate[0, best]),
        "best_params": machines.params_row(best),
        "pareto": [
            {"variant": machines.names[i],
             "area": float(res.area()[i]),
             "aggregate": float(res.aggregate[0, i])}
            for i in front],
    }


def codesign_grad(profile, steps: int, lr: float = 0.1,
                  area_budget: float = None, power_budget: float = None,
                  constraint_mode: str = "projected",
                  opt_links: bool = False, area_envelope: dict = None,
                  sensitivities: bool = False, *,
                  device=DEFAULT_DEVICE) -> dict:
    """Gradient co-design: descend the scalarized (congruence, area, power)
    objective from the named-variant seeds by autograd
    (``repro_torch.core.codesign``); the optimized continuous designs
    answer "where should the machine move?" rather than "which sampled
    point wins?".  With a budget (scalar area/power and/or a
    per-subsystem envelope) the descent is constrained
    (``repro_torch.core.constrained``): projected-gradient or augmented-
    Lagrangian, optionally relaxing ici_links with rounding-and-repair."""
    from repro_torch.core.codesign import grad_codesign
    from repro_torch.core.constrained import constrained_codesign

    seeds = _seeds()
    if area_budget is None and power_budget is None and not area_envelope:
        res = grad_codesign([profile], seeds, steps=steps, lr=lr,
                            device=device)
    else:
        res = constrained_codesign(
            [profile], seeds, steps=steps, lr=lr, area_budget=area_budget,
            power_budget=power_budget, area_envelope=area_envelope,
            mode=constraint_mode, optimize_links=opt_links, device=device)
    out = res.to_json()
    if sensitivities and (area_budget is not None
                          or power_budget is not None or area_envelope):
        # KKT shadow prices at the optimum (repro_torch.core.implicit):
        # which budget is worth relaxing, and by how much per unit.
        from repro_torch.core.implicit import sensitivities_of
        rep = sensitivities_of(res, [profile], device=device)
        out["sensitivities"] = rep.to_json()
    return out


def codesign_bilevel(profile, total_budget: float, steps: int,
                     lr: float = 0.1, area_envelope: dict = None, *,
                     device=DEFAULT_DEVICE):
    """Bilevel budget descent (``repro_torch.core.implicit``): outer descent
    on the area/power split of one total silicon budget, differentiated
    through the inner constrained optimum by the implicit backward."""
    from repro_torch.core.implicit import bilevel_codesign

    return bilevel_codesign(
        [profile], _seeds(), total_budget=total_budget, steps=steps, lr=lr,
        area_envelope=area_envelope, device=device)


def codesign_frontier(profile, budgets, steps: int, lr: float = 0.1,
                      power_budget: float = None,
                      area_envelope: dict = None, *, device=DEFAULT_DEVICE):
    """Feasibility frontier J*(budget) from the named-variant seeds
    (``repro_torch.core.frontier``): one warm-started continuation over the
    budget schedule instead of one cold constrained run per budget."""
    from repro_torch.core.frontier import frontier_codesign

    return frontier_codesign(
        [profile], _seeds(), budgets, steps=steps, lr=lr,
        power_budget=power_budget, area_envelope=area_envelope,
        device=device)


def codesign_joint(profile_group, steps: int, lr: float = 0.1,
                   area_budget: float = None,
                   power_budget: float = None, *,
                   device=DEFAULT_DEVICE) -> dict:
    """Joint (machine, sharding-variant) co-design over one app's group of
    sharding-variant profiles (``repro_torch.core.constrained.joint_codesign``,
    alternation mode), optionally under the same budgets."""
    from repro_torch.core.constrained import joint_codesign

    res = joint_codesign([profile_group], _seeds(), steps=steps, lr=lr,
                         area_budget=area_budget, power_budget=power_budget,
                         device=device)
    return res.to_json()


def codesign_pack(profile, num_machines: int, gen: int = 31,
                  lr: float = None, area_budget: float = None,
                  power_budget: float = None, area_envelope: dict = None, *,
                  device=DEFAULT_DEVICE):
    """Multi-tenant packing: place the optimized profile plus ``gen``
    generated co-tenant stress workloads across ``num_machines`` machine
    instances (``repro_torch.core.packing.pack_codesign``).  Scalar budgets
    read as fleet TOTALS here, not per-machine caps -- the question is
    "how should a shared fleet split its silicon across tenants?"."""
    from repro_torch.core.packing import pack_codesign
    from repro_torch.core.suites import resolve_suite

    apps = [profile] + (resolve_suite(f"gen:{gen}") if gen > 0 else [])
    return pack_codesign(apps, _seeds(), num_machines=num_machines, lr=lr,
                         area_budget=area_budget, power_budget=power_budget,
                         area_envelope=area_envelope, device=device)


def attention_layers(cfg) -> int:
    """Layers whose attention the flash substitution credits (the JAX
    package's count: the AUDIO family's encoder and cross-attention layers
    and every VLM layer included, although K5 is gated off there)."""
    if cfg.family == Family.HYBRID:
        from repro_torch.models.transformer import hybrid_layout
        n_groups, _ = hybrid_layout(cfg)
        return n_groups
    if cfg.family == Family.AUDIO:
        return cfg.n_layers * 2 + cfg.n_encoder_layers  # self+cross / enc
    if cfg.family == Family.SSM:
        return 0
    return cfg.n_layers


def parse_budget_sweep(parser, spec):
    """``LO:HI:N`` -> N evenly spaced area budgets, validated at parse
    time (like ``--backend``) so a bogus schedule fails before any
    compile work."""
    if spec is None:
        return None
    parts = spec.split(":")
    if len(parts) != 3:
        parser.error(f"--budget-sweep expects LO:HI:N, got {spec!r}")
    try:
        lo, hi, n = float(parts[0]), float(parts[1]), int(parts[2])
    except ValueError:
        parser.error(f"--budget-sweep expects numeric LO:HI:N, got {spec!r}")
    if not 0.0 < lo < hi:
        parser.error(f"--budget-sweep needs 0 < LO < HI, got {spec!r}")
    if n < 2:
        parser.error(f"--budget-sweep needs N >= 2 budgets, got {n}")
    return [float(b) for b in np.linspace(lo, hi, n)]


def parse_area_envelope(parser, spec):
    """``K=V[,K=V...]`` -> validated envelope dict (keys checked against
    the cost model's rate fields at parse time)."""
    if spec is None:
        return None
    from repro_torch.core.constrained import validate_area_envelope

    env = {}
    for item in spec.split(","):
        key, sep, value = item.partition("=")
        if not sep:
            parser.error(f"--area-envelope expects K=V[,K=V...], "
                         f"got {item!r}")
        try:
            env[key.strip()] = float(value)
        except ValueError:
            parser.error(f"--area-envelope value for {key.strip()!r} must "
                         f"be a number, got {value!r}")
    try:
        return validate_area_envelope(env)
    except ValueError as exc:
        parser.error(str(exc))


def validate_codesign_args(parser, args) -> None:
    """Reject inconsistent co-design flags at parse time (like --backend):
    budgets must be positive, and every constrained/joint flag needs the
    --grad mode it modifies -- not an error minutes into compile work."""
    for name, value in (("--area-budget", args.area_budget),
                        ("--power-budget", args.power_budget)):
        if value is not None and not value > 0.0:
            parser.error(f"{name} must be positive, got {value}")
    budget_sweep = getattr(args, "budget_sweep", None)
    envelope = getattr(args, "area_envelope", None)
    pack = getattr(args, "pack", 0) or 0
    if pack < 0 or getattr(args, "pack_gen", 0) < 0:
        parser.error("--pack/--pack-gen must be non-negative")
    has_budget = (args.area_budget is not None
                  or args.power_budget is not None or envelope is not None)
    if (args.joint or args.opt_links
            or args.constraint_mode or budget_sweep is not None) \
            and not args.grad:
        parser.error("--constraint-mode/--opt-links/--joint/--budget-sweep "
                     "require --grad STEPS")
    if has_budget and not args.grad and not pack:
        parser.error("--area-budget/--power-budget/--area-envelope "
                     "require --grad STEPS or --pack M")
    if pack and (args.grad or args.joint or budget_sweep is not None
                 or args.opt_links or args.constraint_mode):
        parser.error("--pack is its own co-design mode (fleet-total "
                     "budgets); drop --grad/--joint/--budget-sweep/"
                     "--opt-links/--constraint-mode")
    if (args.constraint_mode or args.opt_links) \
            and not has_budget and budget_sweep is None:
        parser.error("--constraint-mode/--opt-links require "
                     "--area-budget and/or --power-budget")
    if args.joint and (args.constraint_mode or args.opt_links):
        parser.error("--joint supports budgets only through the projected "
                     "retraction; drop --constraint-mode/--opt-links")
    if budget_sweep is not None:
        if args.area_budget is not None:
            parser.error("--budget-sweep IS the area-budget axis; "
                         "drop --area-budget")
        if args.joint or args.opt_links or args.constraint_mode:
            parser.error("--budget-sweep traces the frontier by projected "
                         "continuation; drop --joint/--opt-links/"
                         "--constraint-mode")
    if args.joint and envelope is not None:
        parser.error("--joint does not support --area-envelope; use scalar "
                     "--area-budget/--power-budget")
    bilevel = getattr(args, "bilevel", None)
    if bilevel is not None:
        if not bilevel > 0.0:
            parser.error(f"--bilevel must be positive, got {bilevel}")
        if not args.grad:
            parser.error("--bilevel requires --grad STEPS (inner solves)")
        if args.area_budget is not None or args.power_budget is not None:
            parser.error("--bilevel derives the area/power budgets from "
                         "the learned split; drop --area-budget/"
                         "--power-budget")
        if args.joint or args.opt_links or args.constraint_mode \
                or budget_sweep is not None or pack:
            parser.error("--bilevel is its own co-design mode; drop "
                         "--joint/--opt-links/--constraint-mode/"
                         "--budget-sweep/--pack")
    if getattr(args, "sensitivities", False):
        if not args.grad:
            parser.error("--sensitivities requires --grad STEPS")
        if args.joint:
            parser.error("--sensitivities does not support --joint "
                         "(per-variant selection has no single optimum "
                         "to differentiate through)")
        if not has_budget and budget_sweep is None and bilevel is None:
            parser.error("--sensitivities needs a constraint to price; "
                         "add --area-budget/--power-budget/"
                         "--area-envelope")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mode", choices=("flash", "scan"), default="flash")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--mesh", default="pod",
                    help="pod (default) | multipod | AxB | AxBxC: profile per "
                         "device on that mesh (meta); 1x1: one device")
    ap.add_argument("--variant", choices=SHARDING_VARIANTS, default=None,
                    help="sharding variant on a mesh (default per arch)")
    ap.add_argument("--extract-device", default=EXTRACT_DEVICE,
                    help="device the baseline and the probes run on: meta "
                         "(the dry run, default) | cuda | cpu")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of the co-design (default cuda: the sweep "
                         "through the kernels, the descents in float64 on "
                         "the card; cpu runs the plain version)")
    ap.add_argument("--sweep", type=int, default=0, metavar="N",
                    help="after substitution, sweep N generated machine "
                         "variants and report the best fit + Pareto front")
    ap.add_argument("--sweep-seed", type=int, default=0)
    ap.add_argument("--backend", default=None,
                    help="kernel backend for the co-design sweep (cuda: "
                         "the kernels, torch: the plain version; default by "
                         "--device)")
    ap.add_argument("--grad", type=int, default=0, metavar="STEPS",
                    help="after substitution, gradient co-design: optimize "
                         "machine log-rates from the named-variant seeds by "
                         "autograd of the scalarized (congruence, area, "
                         "power) objective for STEPS steps")
    ap.add_argument("--grad-lr", type=float, default=0.1,
                    help="initial log-rate step size for --grad")
    ap.add_argument("--area-budget", type=float, default=None, metavar="B",
                    help="constrain --grad descent to CostModel.area <= B "
                         "(repro_torch.core.constrained)")
    ap.add_argument("--power-budget", type=float, default=None, metavar="P",
                    help="constrain --grad descent to CostModel.power <= P")
    ap.add_argument("--constraint-mode", default=None,
                    choices=("projected", "lagrangian"),
                    help="budgeted-descent algorithm (default: projected); "
                         "requires --area-budget/--power-budget")
    ap.add_argument("--opt-links", action="store_true",
                    help="relax ici_links continuously during --grad and "
                         "round with repair (requires a budget)")
    ap.add_argument("--joint", action="store_true",
                    help="joint (machine, sharding-variant) descent: "
                         "profile every sharding variant on --mesh and let "
                         "--grad choose per machine variant")
    ap.add_argument("--budget-sweep", default=None, metavar="LO:HI:N",
                    help="trace the feasibility frontier J*(budget) over N "
                         "area budgets from LO to HI (warm-started "
                         "continuation; requires --grad, replaces "
                         "--area-budget)")
    ap.add_argument("--area-envelope", default=None, metavar="K=V[,K=V...]",
                    help="per-subsystem area envelopes for --grad / "
                         "--budget-sweep, e.g. peak_flops=1.5,hbm_bw=0.8 "
                         "(keys from repro_torch.core.costmodel.RATE_FIELDS)")
    ap.add_argument("--sensitivities", action="store_true",
                    help="after a budgeted --grad run, report KKT shadow "
                         "prices and dJ*/d(budget) at the optimum "
                         "(repro_torch.core.implicit); with --budget-sweep "
                         "the frontier rows carry them automatically")
    ap.add_argument("--bilevel", type=float, default=None, metavar="T",
                    help="bilevel budget descent: split one total silicon "
                         "budget T between area and power by outer "
                         "descent through the inner constrained optimum "
                         "(implicit gradient; requires --grad STEPS for "
                         "the inner solves)")
    ap.add_argument("--pack", type=int, default=0, metavar="M",
                    help="multi-tenant packing: place the optimized "
                         "profile plus --pack-gen generated co-tenants "
                         "across M machine instances "
                         "(repro_torch.core.packing); --area-budget/"
                         "--power-budget read as fleet TOTALS")
    ap.add_argument("--pack-gen", type=int, default=31, metavar="N",
                    help="generated co-tenant workloads for --pack "
                         "(AppSpace.default Halton suite gen:N; 0 packs "
                         "the substituted profile alone)")
    args = ap.parse_args(argv)
    # Fail at parse time with the registry's current contents, not deep
    # inside get_backend() after minutes of extraction.
    from repro_torch.core.kernels_xp import validate_backend_arg
    validate_backend_arg(ap, args.backend)
    if args.joint and args.mesh == MESH_LABEL:
        ap.error("--joint profiles the cell under every sharding variant; "
                 "give it a mesh (--mesh pod|multipod|AxB|AxBxC)")
    if args.mesh == MESH_LABEL and args.variant:
        ap.error("--variant shards the cell over a mesh; give one "
                 "(--mesh pod|multipod|AxB|AxBxC)")
    if args.mesh != MESH_LABEL and args.extract_device != "meta":
        ap.error("a mesh's placeholder devices exist on meta only "
                 "(--extract-device meta, or --mesh 1x1)")
    budgets = parse_budget_sweep(ap, args.budget_sweep)
    envelope = parse_area_envelope(ap, args.area_envelope)
    validate_codesign_args(ap, args)

    cfg = C.get_config(args.arch, smoke=args.smoke)
    if args.moe_impl and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=args.moe_impl))
    shape = resolve_shape(args.shape)  # assigned SHAPES or a zoo-grid shape
    tag = args.tag or args.mode
    if args.mode == "flash" and attention_layers(cfg) == 0:
        print("arch is attention-free; flash substitution not applicable")
        return 1
    if args.mode == "scan" and cfg.ssm is None:
        print("arch has no SSM; scan substitution not applicable")
        return 1
    try:
        where = cell_mesh(args.mesh)
    except ValueError as exc:
        ap.error(str(exc))
    variant = (args.variant or default_variant(cfg)) if where else None
    n_dev = where[1].size() if where else 1

    # 1. baseline cell -- the pre-substitution profile
    profile = _run(cfg, shape, args.extract_device, where, variant)
    before = R.analyze(profile, M.TPU_V5E)
    print("before:", before.one_liner())

    # 2. measured traffic isolation + kernel substitution
    t0 = time.time()
    if args.mode == "flash":
        quad2 = quadratic_attention_bytes(cfg, shape, device=args.extract_device,
                                          where=where, variant=variant)
        L_att = attention_layers(cfg)
        per_layer = quad2 / 2.0
        removed = per_layer * L_att
        added = flash_kernel_bytes_per_layer(cfg, shape, n_dev) * L_att
        n_layers = L_att
    else:
        per2 = scan_state_bytes(cfg, shape, device=args.extract_device,
                                where=where, variant=variant)
        per_layer = per2 / 2.0
        removed = per_layer * cfg.n_layers
        added = scan_kernel_bytes_per_layer(cfg, shape, n_dev) * cfg.n_layers
        n_layers = cfg.n_layers
    new_hbm = max(profile.hbm_bytes - removed + added, added)
    print(f"measured fit: {time.time()-t0:.1f}s  kernel-replaced "
          f"traffic/layer {per_layer/1e9:.2f} GB -> kernel "
          f"{added/max(n_layers,1)/1e9:.3f} GB")

    profile.hbm_bytes = new_hbm
    profile.meta[f"{args.mode}_substitution"] = {
        "removed_bytes": removed, "added_bytes": added, "layers": n_layers,
    }
    profile.name += f"+{args.mode}"
    after = R.analyze(profile, M.TPU_V5E)
    print("after: ", after.one_liner())

    if args.sweep > 0:
        # Co-design: which machine design fits the OPTIMIZED workload best?
        cd = codesign_sweep(profile, args.sweep, seed=args.sweep_seed,
                            backend=args.backend, device=args.device)
        profile.meta["codesign_sweep"] = cd
        print(f"codesign sweep over {cd['num_variants']} variants "
              f"({cd['backend']} backend): best={cd['best_variant']} "
              f"aggregate={cd['best_aggregate']:.4f} "
              f"pareto={len(cd['pareto'])} points")

    if args.grad > 0:
        if args.bilevel is not None:
            # Bilevel co-design: how should one silicon budget be SPLIT
            # between area and power?  Outer descent through the inner
            # optimum via the implicit-function-theorem gradient.
            bl = codesign_bilevel(profile, args.bilevel, args.grad,
                                  lr=args.grad_lr, area_envelope=envelope,
                                  device=args.device)
            profile.meta["bilevel_codesign"] = bl.to_json()
            print(f"bilevel codesign (total={args.bilevel:.4g}, "
                  f"{bl.outer_steps} outer steps): split "
                  f"{bl.split_trajectory[0]:.3f} -> {bl.split_final:.3f}, "
                  f"J* {bl.objective_trajectory[0]:.4f} -> "
                  f"{bl.objective_final:.4f} "
                  f"(+{bl.improvement_over_uniform:.4f} vs uniform split)")
        elif args.joint:
            # Joint co-design: which (machine, sharding) pair wins?  The
            # primary cell keeps its kernel substitution; the remaining
            # sharding variants enter as baseline profiles.
            group = [profile]
            for sv in SHARDING_VARIANTS:
                if sv == variant:
                    continue
                alt = _run(cfg, shape, args.extract_device, where, sv)
                alt.name += f"@{sv}"
                group.append(alt)
            gd = codesign_joint(group, args.grad, lr=args.grad_lr,
                                area_budget=args.area_budget,
                                power_budget=args.power_budget,
                                device=args.device)
            profile.meta["joint_codesign"] = gd
            profile.meta["joint_profiles"] = [alt.to_json() for alt in group[1:]]
            print(f"joint codesign over {len(group)} shardings: "
                  f"best={gd['best_variant']} picks="
                  f"{gd['selection'][gd['best_variant']]}")
        elif budgets is not None:
            # Feasibility frontier: how much fabric does this workload
            # actually need?  One continuation over the budget schedule.
            fr = codesign_frontier(profile, budgets, args.grad,
                                   lr=args.grad_lr,
                                   power_budget=args.power_budget,
                                   area_envelope=envelope,
                                   device=args.device)
            profile.meta["frontier_codesign"] = fr.to_json()
            n_feas = int(fr.feasible.sum())
            knee = f"{fr.knee():.4g}" if n_feas else "n/a"
            print(f"frontier over {len(fr)} budgets "
                  f"[{fr.budgets[0]:.4g}, {fr.budgets[-1]:.4g}]: "
                  f"J* {fr.objective[-1]:.4f} (loosest) .. "
                  f"{fr.objective[0]:.4f} (tightest), "
                  f"feasible {n_feas}/{len(fr)}, knee={knee}")
            if args.sensitivities and fr.shadow_prices is not None:
                pts = ", ".join(
                    f"{b:.4g}->{p:.4f}"
                    for b, p in zip(fr.budgets, fr.shadow_prices[:, 0])
                    if np.isfinite(p))
                print(f"area shadow prices (budget -> -dJ*/db): {pts}")
        else:
            # Continuous co-design: in which direction should the machine
            # move (optionally under an area/power budget)?
            gd = codesign_grad(
                profile, args.grad, lr=args.grad_lr,
                area_budget=args.area_budget,
                power_budget=args.power_budget,
                constraint_mode=args.constraint_mode or "projected",
                opt_links=args.opt_links, area_envelope=envelope,
                sensitivities=args.sensitivities, device=args.device)
            profile.meta["grad_codesign"] = gd
            lines = ", ".join(
                f"{v['name']}: {v['objective_seed']:.4f}->"
                f"{v['objective_final']:.4f}" for v in gd["variants"])
            print(f"grad codesign ({gd['steps']} steps, {gd['mode']}): "
                  f"{lines}; best={gd['best_variant']}")
            if "feasibility" in gd:
                feas = gd["feasibility"]
                print(f"feasibility ({feas['mode']}): "
                      f"area_budget={feas['area_budget']} "
                      f"power_budget={feas['power_budget']} "
                      f"all_feasible={feas['all_feasible']}")
            if "sensitivities" in gd:
                sens = gd["sensitivities"]
                lines = "; ".join(
                    f"{v['name']}: " + ", ".join(
                        f"{c}={v['shadow_prices'][c]:.4f}"
                        for c in sens["constraints"])
                    + (f" (relax {v['best_relaxation']} first)"
                       if v["best_relaxation"] else "")
                    for v in sens["variants"])
                print(f"shadow prices (dJ*/d(budget), sign flipped): "
                      f"{lines}")

    if args.pack > 0:
        # Multi-tenant packing: how should a shared fleet split its
        # silicon across this workload and a generated stress population?
        pk = codesign_pack(profile, args.pack, gen=args.pack_gen,
                           lr=args.grad_lr, area_budget=args.area_budget,
                           power_budget=args.power_budget,
                           area_envelope=envelope, device=args.device)
        profile.meta["pack_codesign"] = pk.to_json(top_k=8)
        feas = ("" if pk.feasible is None
                else f", feasible={bool(pk.feasible)}")
        print(f"pack codesign: {len(pk.app_names)} apps across "
              f"{len(pk.machine_names)} machines ({pk.mode}): objective "
              f"{pk.objective_seed:.4f} -> {pk.objective_final:.4f}, "
              f"fleet area {pk.area_total:.3f}{feas}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        stem = (f"{cfg.name}__{shape.name}__{where[0]}__{variant}" if where
                else f"{cfg.name}__{shape.name}__{MESH_LABEL}")
        fname = f"{stem}__{tag}.json"
        profile.save(os.path.join(args.out, fname))
    return 0


if __name__ == "__main__":
    sys.exit(main())
