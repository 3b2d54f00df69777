"""The port stands alone: no file of ``src/repro_torch/`` (the analysis
tools under ``roofline/`` and ``launch/`` included), not
``chip_smoke.py``, not ``sweep_kernels.py``, not the card-only tools
(``tools/f32_routes.py``, ``tools/flash_bwd_ds_ablation.py``,
``tools/train_mesh_phases.py``) and no card
test file (``tests/test_torch_*_gpu.py``, which run where there is no
JAX) imports JAX or anything of the reference package ``repro``, even a
module of it that does not import JAX."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "sweep_kernels.py"),
           os.path.join(ROOT, "tools", "f32_routes.py"),
           os.path.join(ROOT, "tools", "flash_bwd_ds_ablation.py"),
           os.path.join(ROOT, "tools", "train_mesh_phases.py")]
    for d, _, names in os.walk(PORT):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    tests = os.path.join(ROOT, "tests")
    out += [os.path.join(tests, n) for n in os.listdir(tests)
            if n.startswith("test_torch_") and n.endswith("_gpu.py")]
    return sorted(out)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_finds_forbidden_imports(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import jax.numpy as jnp\nfrom repro.configs import base\n"
                    "import repro_torch\nfrom . import x\nimport importlib\n"
                    "importlib.import_module('repro.core')\n")
    assert [m for m in _imported(str(path)) if _forbidden(m)] == \
        ["jax.numpy", "repro.configs", "repro.core"]


@pytest.mark.parametrize("module", [
    "roofline/analysis.py", "roofline/op_cost.py", "launch/input_specs.py",
    "launch/dryrun.py"])
def test_analysis_tools_are_under_the_rule(module):
    """The dry-run and the roofline, whose reference twins are JAX
    through and through (abstract specs, HLO text), stand alone too."""
    path = os.path.join(PORT, *module.split("/"))
    assert path in _files()
    assert not [m for m in _imported(path) if _forbidden(m)]
