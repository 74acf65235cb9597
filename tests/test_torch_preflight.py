"""The port's killable preflight (core/preflight.py) and the CLIs' use of
it, against the JAX package's contract: a child that hangs is killed at
the timeout and reported, a child that lands on the CPU is caught, and
``--no-cuda`` runs no probe."""
import time

import pytest
import torch

from byol_tpu_torch.core import preflight


def test_a_hanging_probe_returns_false_within_its_timeout(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(preflight, "PROBE", "import time; time.sleep(60)")
    t = time.perf_counter()
    assert preflight.preflight_backend(timeout_s=1.0) is False
    assert time.perf_counter() - t < 30.0
    assert "failed to initialize within 1s" in capsys.readouterr().err


def test_a_probe_that_lands_on_the_cpu_is_caught(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the probe lands on it")
    assert preflight.preflight_backend(timeout_s=120.0) is False
    assert "landed on 'cpu'" in capsys.readouterr().err


def test_a_failing_probe_is_reported(monkeypatch, capsys):
    monkeypatch.setattr(preflight, "PROBE",
                        "raise SystemExit('no CUDA runtime')")
    assert preflight.preflight_backend(timeout_s=60.0) is False
    assert "no CUDA runtime" in capsys.readouterr().err


def test_a_probe_on_cuda_passes(monkeypatch):
    monkeypatch.setattr(preflight, "PROBE", "print('cuda')")
    assert preflight.preflight_backend(timeout_s=60.0) is True


def _probe_must_not_run(*_, **__):
    raise AssertionError("the preflight ran")


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_no_cuda_skips_the_probe(entry, monkeypatch, capsys):
    """With ``--no-cuda`` both CLIs go on to their config (here to a
    refusal that stops them before anything is built)."""
    from byol_tpu_torch.cli import main
    from byol_tpu_torch.serving.cli import main as serve_main
    monkeypatch.setattr(preflight, "preflight_backend", _probe_must_not_run)
    if entry == "train":
        rc = main(["--no-cuda", "--dcn-data-parallel", "2"])
        assert "ROADMAP.md" in capsys.readouterr().err
    else:
        rc = serve_main(["--no-cuda", "--arch", "resnet18",
                         "--http", "not-an-address"])
        assert "HOST:PORT" in capsys.readouterr().err
    assert rc == 2


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_an_unreachable_card_exits_2_naming_no_cuda(entry, monkeypatch,
                                                     capsys):
    from byol_tpu_torch.cli import main
    from byol_tpu_torch.serving.cli import main as serve_main
    monkeypatch.setattr(preflight, "preflight_backend", lambda: False)
    rc = main([]) if entry == "train" else serve_main([])
    assert rc == 2
    assert "backend unreachable" in capsys.readouterr().err


def test_a_multi_process_launch_skips_the_probe(monkeypatch, capsys):
    """Under torchrun's environment the ranks do not probe the card (JAX
    skips multi-host runs); the run goes on to its own device check."""
    from byol_tpu_torch.cli import main
    monkeypatch.setattr(preflight, "preflight_backend", _probe_must_not_run)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would go to it")
    assert main([]) == 2
    assert "no CUDA device is visible" in capsys.readouterr().err
