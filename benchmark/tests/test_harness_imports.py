"""A run loads no module of JAX or of the JAX package, and the reference
loads nothing of the system under test.  Top-level module names are
compared whole: the system under test, byol_tpu_torch, begins with the
JAX package's name."""
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "byol_tpu")


def _loaded(code: str):
    """Top-level module names after ``code`` runs in a fresh interpreter."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]\n"
            + code + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_drivers_import_graph_loads_no_jax():
    """The run's modules and every module of the port the drivers call."""
    names = _loaded(
        "import run\n"
        "from harness import checks, registry, report, roofline, trace\n"
        "import drivers.train, drivers.serve\n"
        "from byol_tpu_torch import cli\n"
        "from byol_tpu_torch.core.config import resolve\n"
        "from byol_tpu_torch.training import build, steps\n"
        "from byol_tpu_torch.data import device_augment\n"
        "from byol_tpu_torch.serving import service\n"
        "from byol_tpu_torch.ops import fused_augment, fused_update, "
        "flash_attention\n"
        "import torch.profiler\n")
    assert "byol_tpu_torch" in names
    assert not set(names) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_system_under_test():
    names = _loaded("from reference import augment, byol, nets, precision")
    assert "byol_tpu_torch" not in names
    assert not set(names) & set(FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    from harness import report
    monkeypatch.setitem(sys.modules, "byol_tpu_torch_probe", sys)
    assert report.forbidden_modules() == [] or all(
        m.split(".")[0] in FORBIDDEN for m in report.forbidden_modules())
    monkeypatch.setitem(sys.modules, "byol_tpu.core", sys)
    assert "byol_tpu.core" in report.forbidden_modules()
    assert report.emit({"correct": True}, {}) != 0
