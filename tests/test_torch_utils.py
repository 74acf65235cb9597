"""The port's run-metadata helpers and parameter count (utils/), held
against the JAX package's on a monkeypatched environment; no test opens a
connection (the metadata endpoint is monkeypatched in both)."""
import io
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu import utils as jax_utils
from byol_tpu_torch import utils as torch_utils
from tests.torch_ranks import one_torch_thread  # noqa: F401

SLURM = ("SLURM_JOB_ID", "SLURM_ARRAY_TASK_ID")


@pytest.mark.parametrize("env", [{}, {"SLURM_JOB_ID": "77"},
                                 {"SLURM_JOB_ID": "77",
                                  "SLURM_ARRAY_TASK_ID": "3"},
                                 {"SLURM_ARRAY_TASK_ID": "3"}])
def test_slurm_id_is_jax_s(env, monkeypatch):
    for k in SLURM:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert torch_utils.get_slurm_id() == jax_utils.get_slurm_id()


class _Answer(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _refuse(*_, **__):
    raise OSError("no route to host")


def test_aws_instance_id_off_ec2_is_none_and_opens_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda *a, **k: opened.append(a) or _refuse())
    monkeypatch.setattr(torch_utils, "_on_ec2", lambda: False)
    assert torch_utils.get_aws_instance_id() is None
    assert opened == []
    # JAX's asks the endpoint and gets nothing either
    assert jax_utils.get_aws_instance_id() is None


@pytest.mark.parametrize("answer", ["endpoint", "refused"])
def test_aws_instance_id_on_ec2_is_jax_s(answer, monkeypatch):
    seen = []

    def urlopen(url, timeout):
        seen.append((url, timeout))
        if answer == "refused":
            raise OSError("timed out")
        return _Answer(b"i-0123456789abcdef0")
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(torch_utils, "_on_ec2", lambda: True)
    monkeypatch.setattr(torch_utils, "_dmi", lambda field: "")
    assert torch_utils.get_aws_instance_id() == \
        jax_utils.get_aws_instance_id()
    assert seen[0] == seen[1] == (
        "http://169.254.169.254/latest/meta-data/instance-id", 0.25)


def test_aws_instance_id_reads_the_nitro_asset_tag(monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", _refuse)
    tables = {"sys_vendor": "Amazon EC2",
              "board_asset_tag": "i-0123456789abcdef0"}
    monkeypatch.setattr(torch_utils, "_dmi",
                        lambda field: tables.get(field, ""))
    assert torch_utils.get_aws_instance_id() == "i-0123456789abcdef0"


def test_gpu_env_keeps_the_keys_that_are_set(monkeypatch):
    """JAX's ``get_tpu_env`` returns the TPU variables that are set; the
    card counterpart does the same with CUDA's and torchrun's (and the
    card's name where a card is visible)."""
    keys = ("CUDA_VISIBLE_DEVICES", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "TPU_WORKER_ID", "TPU_ACCELERATOR_TYPE", "TPU_PROCESS_BOUNDS",
            "MEGASCALE_SLICE_ID")
    for k in keys:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("TPU_WORKER_ID", "4")
    got = torch_utils.get_gpu_env()
    got.pop("device_name", None)
    assert got == {"CUDA_VISIBLE_DEVICES": "0,1", "LOCAL_RANK": "1"}
    assert jax_utils.get_tpu_env() == {"TPU_WORKER_ID": "4"}


def test_number_of_parameters_is_jax_s():
    from tests.test_torch_train_step import _jax_net
    variables = _jax_net(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
        train=True, method="warmup")
    params = jax.device_get(variables["params"])
    want = jax_utils.number_of_parameters(params)
    assert torch_utils.number_of_parameters(params) == want
    torch_tree = jax.tree_util.tree_map(torch.from_numpy,
                                        jax.tree_util.tree_map(np.asarray,
                                                               params))
    assert torch_utils.number_of_parameters(torch_tree) == want
    # the port's net, unpadded: its flat buffers' padding is not counted
    from tests.torch_ranks import tiny_net
    assert torch_utils.number_of_parameters(
        dict(tiny_net().named_parameters())) == want
