"""The port stands alone, and its kernels are never silently replaced.

- every spartan_tpu_torch module imports in a fresh interpreter without
  pulling in jax or any module of the JAX package spartan_tpu;
- no source of the port and no line of chip_smoke.py or prove_ab.py
  imports spartan_tpu;
- the kernel loader raises (and returns no None) where nvcc is absent;
- on a CUDA card, each kernel matches its plain version (skipped here).
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import spartan_tpu_torch
from spartan_tpu_torch import kernels

REPO = Path(__file__).resolve().parent.parent


def _all_modules():
    names = ["spartan_tpu_torch"]
    for info in pkgutil.walk_packages(spartan_tpu_torch.__path__, "spartan_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    mods = _all_modules()
    assert {"spartan_tpu_torch.ops.field", "spartan_tpu_torch.protocol.argument",
            "spartan_tpu_torch.kernels"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'spartan_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_port_source_imports_the_jax_package():
    files = sorted((REPO / "spartan_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                  REPO / "prove_ab.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}" for f in files
           for line, root in _imported_roots(f) if root in ("jax", "spartan_tpu")]
    assert not bad, bad


def test_kernel_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.load()


def test_kernel_table_names_sources():
    for name, (n_in, src, rep) in kernels.KERNELS.items():
        assert n_in in (1, 2)
        assert (kernels.CSRC / src).exists(), src
        # the replaced function's def line; every row a Pallas kernel but
        # fp_inv, the Fermat chain (field.inv) over the Pallas mont_mul
        path, line = rep.split(":")
        assert (REPO / path).read_text().splitlines()[int(line) - 1].startswith("def "), rep
        assert path.startswith("spartan_tpu/ops/pallas_") or (name, path) == (
            "fp_inv", "spartan_tpu/ops/field.py"), rep
        assert f"spk_{name}(" in (kernels.CSRC / src).read_text()
    sources = "".join(p.read_text() for p in kernels.CSRC.glob("*.cu"))
    assert set(kernels.INT_ARGS) <= set(kernels.KERNELS)
    assert all(f"spk_{name}(" in sources for name in kernels.YARDSTICKS)


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on one: python -m pytest --noconftest tests/test_torch_imports.py -m gpu")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    old = chip_smoke.TIMED_LANES, chip_smoke.G1_WIDTHS, chip_smoke.G2_WIDTHS
    chip_smoke.TIMED_LANES, chip_smoke.G2_WIDTHS = 1 << 10, (8, 1 << 10)
    chip_smoke.G1_WIDTHS = {"add": (1, 1 << 10), "double": (1, 1 << 10)}
    try:
        rows = chip_smoke.phase_kernels(torch.device("cuda", 0), chip_smoke.Card())
    finally:
        chip_smoke.TIMED_LANES, chip_smoke.G1_WIDTHS, chip_smoke.G2_WIDTHS = old
    assert {r["name"] for r in rows} == set(kernels.KERNELS)
    assert all(r["max_abs_err"] == 0 for r in rows)
