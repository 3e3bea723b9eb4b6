"""The port (zhilight_tpu_torch) stands alone: importing it and every module
of the slices (found by a glob, so new modules such as ``utils/calibrate.py``
and ``ops/cuda/fp8_matmul.py`` are covered) loads neither JAX, the JAX
package nor ``ml_dtypes``, no file of it imports any of them, and its entry
point runs on the GPU unless told otherwise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

FOREIGN = ("jax", "jaxlib", "zhilight_tpu", "ml_dtypes")
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "zhilight_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("module", MODULES)
def test_no_file_imports_jax(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    bad = [m for m in _imports(path) if m.split(".")[0] in FOREIGN]
    assert not bad, f"{path}: imports {bad}"


def test_new_modules_are_covered():
    assert {"zhilight_tpu_torch.utils.calibrate", "zhilight_tpu_torch.ops.cuda.fp8_matmul"} <= set(MODULES)


def test_llm_without_device_raises_without_gpu(monkeypatch):
    """No silent move to the CPU: LLM's default device is the GPU."""
    import torch

    from zhilight_tpu_torch.config import ModelConfig
    from zhilight_tpu_torch.llm import LLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM(model_config=ModelConfig(num_layers=1, dim_model=64, num_heads=1, dim_head=64,
                                     dim_ff=64, vocab_size=8, dtype="float32"), params={})
