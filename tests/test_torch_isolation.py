"""The port stands alone: it imports nothing of JAX or of the JAX package,
its docstring examples run, its kernels build only where nvcc is (and a
cached build keeps its ptxas report), and ``chip_smoke.py`` refuses to
report a result without a card or outside a checkout."""

import ast
import doctest
import importlib
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(PORT) for f in files if f.endswith(".py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, repro_torch, repro_torch.launch.sweep, "
            "repro_torch.core.kernels_cuda, repro_torch.core._build, "
            "repro_torch.models.transformer, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.selective_scan, "
            "repro_torch.carry, repro_torch.configs, "
            "repro_torch.core.codesign, repro_torch.core.constrained, "
            "repro_torch.core.spec, repro_torch.core.frontier, "
            "repro_torch.core.implicit, repro_torch.core.packing, "
            "repro_torch.serving.codesign_service, "
            "repro_torch.launch.serve_codesign\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                             "benchmarks"), (path, mod)


@pytest.mark.parametrize("module", [
    "repro_torch.core.sweep", "repro_torch.core.costmodel",
    "repro_torch.core.genload", "repro_torch.core.dse",
    "repro_torch.core.codesign", "repro_torch.core.constrained",
    "repro_torch.core.spec", "repro_torch.core.frontier",
    "repro_torch.core.implicit", "repro_torch.core.packing",
    "repro_torch.serving.codesign_service"])
def test_docstring_examples_run(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0


def test_kernel_build_is_keyed_on_the_source_and_needs_nvcc():
    from repro_torch.core import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("librepro_torch_") and path.suffix == ".so"
    assert {s.name for s in _build.SOURCES} == {"congruence.cu",
                                                "flash_attention.cu",
                                                "flash_attention_sm90.cu",
                                                "rmsnorm.cu",
                                                "selective_scan.cu"}
    assert all(s.exists() for s in _build.SOURCES)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the missing-compiler error is not "
                    "reachable here")
    if not path.exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()


def test_a_cached_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """chip_smoke.py's spill check reads ptxas's report; a library built
    earlier in the same checkout reports it from the file beside it."""
    from repro_torch.core import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = _build.library_path()
    path.write_bytes(b"")
    path.with_suffix(".ptxas.txt").write_text("ptxas info    : Used 241 registers\n")
    assert _build.build() == path
    assert _build.build_info["cached"] is True
    assert _build.build_info["log"] == "ptxas info    : Used 241 registers\n"


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_attention_kIfLi128EEEvPKT_S3_S3_PS1_iiiiiNS_7StridesES5_S5_S5_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_attention_kIfLi128EEEvPKT_S3_S3_PS1_iiiiiNS_7StridesES5_S5_S5_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 241 registers, used 1 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_attention_kI13__nv_bfloat16Li256EEEvPKT_S4_S4_PS2_iiiiiNS_7StridesES6_S6_S6_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_attention_kI13__nv_bfloat16Li256EEEvPKT_S4_S4_PS2_iiiiiNS_7StridesES6_S6_S6_iiif
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_attention_sm90_kILi128EEEvv' for 'sm_90a'
ptxas info    : Used 168 registers
"""


def test_chip_smoke_reads_the_fma_kernels_registers_and_spills_from_ptxas():
    sys.path.insert(0, ROOT)
    import chip_smoke

    found = chip_smoke.fma_instantiations(chip_smoke.ptxas_report(PTXAS_LOG))
    assert found == {
        ("float32", 128): {"registers": 241, "stack": 0, "spill_stores": 0,
                           "spill_loads": 0},
        ("bfloat16", 256): {"registers": 255, "stack": 8, "spill_stores": 12,
                            "spill_loads": 16}}


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_prints_no_result_without_card_or_checkout(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py would run for real")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
