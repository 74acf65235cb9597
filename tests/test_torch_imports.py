"""The port stands alone: no module of byol_tpu_torch/, and not
chip_smoke.py or train_torch.py, imports JAX, flax, optax, orbax,
tensorstore, zstandard, TensorFlow or the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "byol_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "train_torch.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "zstandard", "tensorflow", "byol_tpu"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_scan_sees_the_package():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


def test_the_scan_sees_the_parallel_modules():
    parallel = ROOT / "byol_tpu_torch" / "parallel"
    for name in ("mesh", "collectives", "lockstep", "zero1", "flat_state",
                 "compile_plan", "ring_attention", "partitioning"):
        assert parallel / f"{name}.py" in FILES, name


def test_the_scan_sees_the_remat_module():
    assert ROOT / "byol_tpu_torch" / "core" / "remat.py" in FILES


def test_the_scan_sees_the_checkpoint_reader():
    checkpoint = ROOT / "byol_tpu_torch" / "checkpoint"
    for name in ("zstd", "ocdbt", "orbax", "orbax_fixture"):
        assert checkpoint / f"{name}.py" in FILES, name


def test_the_scan_sees_the_utils_and_the_launcher():
    assert ROOT / "byol_tpu_torch" / "utils" / "__init__.py" in FILES
    assert (ROOT / "train_torch.py").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, (
        f"{path.relative_to(ROOT)} imports {sorted(roots & FORBIDDEN)}")
