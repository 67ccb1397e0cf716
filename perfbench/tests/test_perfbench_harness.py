"""CPU tests of the benchmark harness (``perfbench/``), at the port's smoke
sizes.  Run from the root of the checkout:

    PYTHONPATH=src python -m pytest -q perfbench/tests

Tests marked ``cuda`` need the card and skip elsewhere."""

from __future__ import annotations

import copy
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import check, spec
from perfbench.control import control_readings
from perfbench.run import Program, forbidden_modules, main, run
from perfbench.tests.smoke_tree import cells, smoke_tree
from perfbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[2]
CELLS = cells()
SEED = 2 ** 31 + 12345
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return smoke_tree(tmp_path_factory.mktemp("checkout"))


def _run(tree, name, trace=False, program=None, seconds=0.2):
    return run(spec.load_cell(name, tree), SEED, seconds, trace, "cpu", program=program)


# --------------------------------------------------------------------------- #
# BENCHMARK.json and discovery by name
# --------------------------------------------------------------------------- #


def test_benchmark_json_keeps_the_contract_format():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and bench["command"][1] == "perfbench/run.py"
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4), four
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert {m["name"] for m in cell.per_layer} and "setup_s" in \
            {m["name"] for m in cell.end_to_end}


#: what ``_add_by_files`` adds: a family (a copy of the SSM reference), a
#: configuration of it, a mix, a cell of the two and a per-layer metric
NEW_CONFIG, NEW_MIX = "falcon-mamba-7b-copy", "prefill_pair"
NEW_CELL = f"{NEW_CONFIG}.{NEW_MIX}"


def _checkout(dst: Path) -> Path:
    """A checkout of the benchmark alone: ``BENCHMARK.json`` and
    ``perfbench/``, its tests' smoke files included."""
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    return dst


def _add_by_files(root: Path, without_smoke: str = "") -> None:
    """Add to the checkout ``root`` a family, a configuration, a mix, a cell
    and a metric as new files and appended entries, with the smoke files
    of the configuration and the mix but the one of ``without_smoke``
    (``configs`` or ``traffic``)."""
    pb, smoke = root / "perfbench", root / "perfbench" / "tests" / "smoke"
    shutil.copy(pb / "reference" / "ssm.py", pb / "reference" / "ssm_copy.py")
    cfg = json.loads((pb / "configs" / "falcon-mamba-7b.json").read_text())
    cfg.update(name=NEW_CONFIG, family="ssm_copy")
    (pb / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(cfg))
    (pb / "traffic" / f"{NEW_MIX}.json").write_text(json.dumps(
        {"lengths": [256, 512], "batch": 2, "trace_slice": {"skip": 2, "requests": 4}}))
    if without_smoke != "configs":
        shutil.copy(smoke / "configs" / "falcon-mamba-7b.json",
                    smoke / "configs" / f"{NEW_CONFIG}.json")
    if without_smoke != "traffic":
        (smoke / "traffic" / f"{NEW_MIX}.json").write_text(json.dumps(
            {"lengths": [4, 8], "trace_slice": {"skip": 1, "requests": 2}}))
    shutil.copy(pb / "limits" / "falcon-mamba-7b.prefill_8k.json",
                pb / "limits" / f"{NEW_CELL}.json")
    (pb / "metrics" / "requests_traced.py").write_text(
        "def read(slc):\n    return float(len(slc.requests))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "falcon-mamba-7b")
    bench["configs"].append(dict(entry, name=NEW_CONFIG,
                                 file=f"perfbench/configs/{NEW_CONFIG}.json"))
    bench["workloads"].append({"name": NEW_CELL, "config": NEW_CONFIG, "traffic": NEW_MIX,
                               "chips": 1, "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "prefill_tokens_per_s",
                               "workloads": [NEW_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _files(root: Path) -> dict:
    """Every file under ``root`` but bytecode and run outputs (``out/``)."""
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and {"__pycache__", "out"}.isdisjoint(p.relative_to(root).parts)}


def test_a_config_mix_and_metric_added_as_files_are_found(tmp_path):
    """A family, a configuration, a mix, a cell and a metric, added as new
    files and appended entries of ``BENCHMARK.json`` alone, are found,
    built at smoke size and run ``correct``; no file that was there
    changes, byte for byte."""
    root = _checkout(tmp_path / "checkout")
    before, repo = _files(root), _files(ROOT / "perfbench")
    _add_by_files(root)
    (tmp_path / "smoke").mkdir()
    cell = spec.load_cell(NEW_CELL, smoke_tree(tmp_path / "smoke", root))
    small = json.loads((root / "perfbench" / "tests" / "smoke" / "configs"
                        / f"{NEW_CONFIG}.json").read_text())
    assert cell.config.items() >= small["config"].items()
    assert Path(cell.reference.__file__).name == "ssm_copy.py"
    result = run(cell, SEED, 0.2, True, "cpu")
    assert result["correct"] and result["metrics"]["requests_traced"]["value"] == 2.0
    after = {p: p.read_bytes() for p in before}
    old, new = (json.loads(d.pop(root / "BENCHMARK.json")) for d in (before, after))
    assert after == before and set(new) == set(old)
    for key, value in old.items():
        assert (new[key][:len(value)] if isinstance(value, list) else new[key]) == value
    assert _files(ROOT / "perfbench") == repo


@pytest.mark.parametrize("kind,name", (("configs", NEW_CONFIG), ("traffic", NEW_MIX)))
def test_a_config_or_mix_without_smoke_sizes_names_the_file_to_add(tmp_path, kind, name):
    root = _checkout(tmp_path / "checkout")
    _add_by_files(root, without_smoke=kind)
    (tmp_path / "smoke").mkdir()
    want = re.escape(f"add perfbench/tests/smoke/{kind}/{name}.json")
    with pytest.raises(FileNotFoundError, match=want):
        smoke_tree(tmp_path / "smoke", root)


def test_an_unknown_cell_is_refused(tree):
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell", tree)


# --------------------------------------------------------------------------- #
# the frozen work counts against PERF.md's hand counts
# --------------------------------------------------------------------------- #


def test_k5_bound_at_chatglm3_shape():
    cell = spec.load_cell("qwen1.5-4b.prefill_32k")
    k5 = next(k for k in cell.kernels if k.GROUP == "K5")
    ms, by = k5.attention_bound(4, 32, 2, 2048, 2048, 128, True, None, "bfloat16")
    assert by == "operations" and round(ms, 3) == 0.139


def test_k8_bound_at_falcon_mamba_shape():
    cell = spec.load_cell("falcon-mamba-7b.prefill_8k")
    k8 = next(k for k in cell.kernels if k.GROUP == "K8")
    ms, by = k8.scan_bound(4, 2048, 8192, 16, 2, 4, 4, True)
    assert by == "operations" and round(ms, 3) == 0.289


def test_model_flops_of_the_long_cells():
    dense = spec.load_cell("qwen1.5-4b.prefill_32k")
    assert dense.reference.model_flops(dense.config, 1, 32768) == pytest.approx(4.28e14, rel=5e-3)
    ssm = spec.load_cell("falcon-mamba-7b.prefill_8k")
    assert ssm.reference.model_flops(ssm.config, 1, 8192) == pytest.approx(1.10e14, rel=5e-3)


# --------------------------------------------------------------------------- #
# the reference against the port, and the control
# --------------------------------------------------------------------------- #


def _served(tree, name, compute_dtype):
    """The port's prefill of one request on the CPU (the kernels' plain
    versions) with the benchmark's weights -> (cell, weights, served)."""
    cell = spec.load_cell(name, tree)
    prog = Program()
    port = copy.deepcopy(cell.config["port"])
    port["replace"]["compute_dtype"] = compute_dtype
    cfg = prog.config(port)
    weights = cell.reference.make_weights(cell.config, 7, "cpu")
    traffic = Traffic(cell.traffic, SEED, cell.reference.sizes(cell.config)["vocab"])
    tokens = traffic.tokens(0, "cpu")
    cache = prog.cache(cfg, *tokens.shape, "cpu")
    _, logits = prog.prefill(prog.model(cfg, weights), cfg, {"tokens": tokens}, cache)
    served = {"tokens": tokens, "logits": logits[:, -1], "cache": cache}
    return cell, weights, served


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_in_float32(tree, name):
    cell, weights, served = _served(tree, name, "float32")
    numbers = check.compare(cell.reference, weights, cell.config, served)
    assert set(numbers) == set(cell.limits["limits"])
    assert all(v < 1e-4 for v in numbers.values()), numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_port_in_bf16_is_within_the_cells_limits(tree, name):
    cell, weights, served = _served(tree, name, "bfloat16")
    numbers = check.compare(cell.reference, weights, cell.config, served)
    assert check.judge(numbers, cell.limits["limits"]), numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_fails_the_cells_limits(tree, name):
    """The control (``perfbench/control.py``): the reference in float8 e4m3
    put in the program's place, held to the float32 reference, fails a
    limit for every shape of the cell."""
    cell = spec.load_cell(name, tree)
    for numbers in control_readings(cell, SEED, "cpu"):
        numbers.pop("shape")
        assert not check.judge(numbers, cell.limits["limits"]), numbers


# --------------------------------------------------------------------------- #
# a whole run, and faults in the timed path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("trace", (False, True))
@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_the_contract_keys(tree, name, trace):
    result = _run(tree, name, trace=trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(result) == want
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # a cell that asks for four cards is run, and reported, on four
    assert result["device"]["count"] == spec.load_cell(name, tree).workload["chips"]
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        cell = spec.load_cell(name, tree)
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["checks"]) == set(spec.load_cell(name, tree).limits["limits"])
    json.dumps(result)


class _StateUnchanged(Program):
    """The prefill writes its cache into a throwaway one."""

    def prefill(self, model, cfg, batch, cache):
        other = {k: torch.zeros_like(v) for k, v in cache.items()}
        _, logits = super().prefill(model, cfg, batch, other)
        return cache, logits


class _HalfBatch(Program):
    """Half the batch served, the other rows the mean of the first."""

    def prefill(self, model, cfg, batch, cache):
        B = batch["tokens"].shape[0]
        half = {k: v[:, : max(1, B // 2)] for k, v in cache.items()}
        _, logits = super().prefill(model, cfg, {"tokens": batch["tokens"][: max(1, B // 2)]},
                                    half)
        rest = logits.float().mean(0, keepdim=True).expand(B - logits.shape[0], *logits.shape[1:])
        return cache, torch.cat([logits, rest.to(logits.dtype)])


class _AlteredAnswer(Program):
    """Each row's best logit lowered below its worst where it is produced."""

    def prefill(self, model, cfg, batch, cache):
        _, logits = super().prefill(model, cfg, batch, cache)
        logits = logits.clone()
        top = logits.argmax(-1, keepdim=True)
        logits.scatter_(-1, top, logits.amin(-1, keepdim=True) - 1)
        return cache, logits


def _batched(name):
    """Whether a request of the cell's mix holds more than one prompt."""
    return any(B > 1 for B, _ in Traffic(spec.load_cell(name).traffic, 0, 1).shapes())


#: the faults each cell can have: one card, so no exchange between chips to
#: leave out; a cell of B 1 requests has no half of a batch to leave out
FAULTS = [(name, fault) for name in CELLS
          for fault in (_StateUnchanged, _AlteredAnswer)] \
    + [(name, _HalfBatch) for name in CELLS if _batched(name)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(tree, name, fault):
    result = _run(tree, name, program=fault())
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


# --------------------------------------------------------------------------- #
# the trace reduction
# --------------------------------------------------------------------------- #


def test_the_trace_reduction_on_a_synthetic_slice():
    """Device operations grouped by ``device_split``'s rule, host events
    left out, idle gaps named by the operation that ends them, and each
    reader's arithmetic."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from perfbench import peaks, trace as tr

    cell = spec.load_cell("falcon-mamba-7b.prefill_8k")
    cpu, dev = DeviceType.CPU, DeviceType.CUDA

    def ev(name, kind, a, b):
        return NS(name=name, device_type=kind, time_range=NS(start=a, end=b))

    events = [ev("aten::mm", cpu, 3, 4), ev("distribution_random_from_to", dev, 0, 5),
              ev("void selective_scan_k<4>(...)", dev, 10, 40),
              ev("nvjet_tst_192x192", dev, 40, 60), ev("elementwise_kernel<128>", dev, 70, 80),
              ev("Memcpy DtoH (Device -> Pageable)", dev, 85, 90)]
    ops = tr.from_profiler(NS(events=lambda: events), cell.kernels)
    assert [o.group for o in ops] == ["other", "K8", "matmul", "other", "copy"]
    slc = tr.Slice(ops=ops, wall_s=100e-6, requests=[(1, 8192)],
                   enqueue_ms_outside=[1.0, 3.0], config=cell.config,
                   reference=cell.reference, kernels=cell.kernels)
    assert slc.busy_s() == pytest.approx(70e-6)
    assert slc.idle_gaps() == [("prefill", pytest.approx(5e-6)),
                               ("prefill", pytest.approx(10e-6)),
                               ("sync", pytest.approx(5e-6))]
    got = {k: v["value"] for k, v in tr.read_metrics(slc, cell.per_layer, cell.readers).items()}
    k8 = slc.kernel("K8").scan_bound(1, 8192, 8192, 16, 2, 4, 4, True)[0]
    flops = cell.reference.model_flops(cell.config, 1, 8192)
    assert got == pytest.approx({
        "device_idle_share": 30.0, "stack_other_ms": 0.02,
        "k8_roofline": 100 * k8 / 0.030,
        "prefill_mfu": 100 * flops / (100e-6 * peaks.BF16_OPS_PER_S)})
    assert spec.load_cell("qwen1.5-4b.prefill_chat").readers["host_enqueue_ms"].read(slc) == 2.0
    assert slc.breakdown()["device_ops"][0] == ["K8: void selective_scan_k<4>(...)",
                                                pytest.approx(30e-6)]
    between = tr.Slice(ops=ops[1:] + [tr.DeviceOp("random_from_to", "other", 95, 96)],
                       wall_s=1.0, requests=[], enqueue_ms_outside=[], config={},
                       reference=None, kernels=[])
    assert between.idle_gaps()[-1] == ("between requests", pytest.approx(5e-6))


# --------------------------------------------------------------------------- #
# traffic
# --------------------------------------------------------------------------- #


def test_traffic_is_the_seeds_and_every_seed_sends_the_same_mix():
    mix = json.loads((ROOT / "perfbench" / "traffic" / "prefill_chat.json").read_text())
    a, b, c = Traffic(mix, SEED, 1000), Traffic(mix, SEED, 1000), Traffic(mix, 3, 1000)
    assert [a.shape(i) for i in range(30)] == [b.shape(i) for i in range(30)]
    assert torch.equal(a.tokens(5, "cpu"), b.tokens(5, "cpu"))
    assert not torch.equal(a.tokens(5, "cpu"), c.tokens(5, "cpu"))
    for t in (a, c):
        shapes = [t.shape(i) for i in range(30)]
        assert sorted(shapes) == sorted(t.shapes() * 10)
        assert all(B * S == 4096 for B, S in shapes)


# --------------------------------------------------------------------------- #
# refusals and isolation
# --------------------------------------------------------------------------- #


def test_the_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main(["--workload", "qwen1.5-4b.prefill_chat", "--seed", str(SEED),
                 "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_run_refuses_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``perfbench/``."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "qwen1.5-4b.prefill_chat", "--seed", "1", "--seconds", "1",
                           "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_run_and_the_references_load_nothing_of_jax_or_the_jax_package(tree):
    """The top-level name of every module a whole run loaded is compared
    whole (``repro_torch`` begins with ``repro``); the references load
    nothing of the port either."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from perfbench import spec\n"
        "from perfbench.run import run, forbidden_modules\n"
        "run(spec.load_cell({cell!r}, {tree!r}), 5, 0.1, True, 'cpu')\n"
        "print(','.join(forbidden_modules()) or 'none')\n")
    for cell in CELLS:
        proc = subprocess.run([sys.executable, "-c", code.format(
            root=str(ROOT), src=str(ROOT / "src"), cell=cell, tree=str(tree))],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip().splitlines()[-1] == "none"
    code = (
        "import sys; sys.path[:0] = [{root!r}]\n"
        "import importlib, pathlib\n"
        "for p in sorted(pathlib.Path({ref!r}).glob('*.py')):\n"
        "    importlib.import_module('perfbench.reference.' + p.stem)\n"
        "print(sorted({{n.split('.')[0] for n in sys.modules}} & "
        "{{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}}))\n")
    proc = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), ref=str(ROOT / "perfbench" / "reference"))],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in forbidden_modules()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name,
                           "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
