"""The serving slice as a whole, on the CPU, held against the JAX package.

The oracle is JAX ``frozen_representation_fn`` (plain ``net.apply``), not
the JAX ServingEngine: a tiny BYOLNet with a ViT backbone under
``attn_impl='flash'`` is initialised by flax, its variables go through
``convert.from_flax`` into the port's ``build_service``, and the served
embeddings of the same numpy rows must match.  Tolerances as in
test_torch_vit.py: fp32 1e-4, bf16 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.models.vit import ViT as JaxViT
from byol_tpu.training.linear_eval import frozen_representation_fn
from byol_tpu_torch.core.config import (Config, DeviceConfig, ModelConfig,
                                        ParityConfig, TaskConfig)
from byol_tpu_torch.models import registry
from byol_tpu_torch.models.vit import ViT
from byol_tpu_torch.serving.cli import main as serve_main
from byol_tpu_torch.serving.service import ServeConfig, build_service

ARCH = "vit_tiny_test"
TINY = dict(width=64, depth=2, num_heads=2, patch_size=8)
SIZE = 32
TOL = {False: 1e-4, True: 3e-2}


@pytest.fixture(scope="module")
def tiny_arch():
    if ARCH not in registry.available():
        registry.register(ARCH, registry.BackboneSpec(
            factory=lambda dtype, image_size, **kw: ViT(
                **TINY, dtype=dtype, image_size=image_size, **kw),
            feature_dim=64, has_batchnorm=False))
    return ARCH


def _jax_net(half):
    dtype = jnp.bfloat16 if half else jnp.float32
    return JaxBYOLNet(backbone=JaxViT(**TINY, dtype=dtype, attn_impl="flash"),
                      num_classes=10, head_latent_size=32, projection_size=16,
                      dtype=dtype)


@pytest.fixture(scope="module")
def variables():
    v = _jax_net(False).init({"params": jax.random.PRNGKey(3)},
                             jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                             method="warmup")
    return jax.device_get(v)


def _cfg(half, normalize):
    return Config(task=TaskConfig(image_size_override=SIZE),
                  model=ModelConfig(arch=ARCH, head_latent_size=32,
                                    projection_size=16, attn_impl="flash"),
                  device=DeviceConfig(half=half),
                  parity=ParityConfig(normalize_inputs=normalize))


def _service(variables, half, normalize, pipeline="on"):
    return build_service(
        _cfg(half, normalize),
        ServeConfig(min_bucket=8, max_bucket=8, pipeline=pipeline),
        params=variables["params"], batch_stats=variables["batch_stats"],
        device="cpu")


def _rows(n, seed):
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(
        np.float32)


@pytest.mark.parametrize("half,normalize", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_served_embeddings_match_jax_frozen_representation(
        tiny_arch, variables, half, normalize):
    want_fn = frozen_representation_fn(
        _jax_net(half), variables["params"], variables["batch_stats"],
        half=half, normalize=normalize)
    with _service(variables, half, normalize) as svc:
        for n, seed in ((5, 0), (8, 1)):        # 5 rows pad to bucket 8
            rows = _rows(n, seed)
            got = svc.embed(rows, timeout=120)
            want = np.asarray(want_fn(jnp.asarray(rows)))
            assert got.shape == (n, 64) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=TOL[half],
                                       atol=TOL[half])


def test_pipeline_on_and_off_match_bitwise(tiny_arch, variables):
    outs = {}
    for pipeline in ("off", "on"):
        with _service(variables, False, False, pipeline) as svc:
            reqs = [svc.submit(_rows(n, seed), timeout=60)
                    for n, seed in ((1, 2), (3, 3), (4, 4), (2, 5))]
            outs[pipeline] = [r.result(120) for r in reqs]
    for a, b in zip(outs["off"], outs["on"]):
        np.testing.assert_array_equal(a, b)


def test_compile_count_stays_after_warmup(tiny_arch, variables):
    svc = build_service(_cfg(False, False),
                        ServeConfig(min_bucket=8, max_bucket=16),
                        params=variables["params"],
                        batch_stats=variables["batch_stats"], device="cpu")
    with svc:
        warm = svc.engine.compile_count
        assert warm == 2
        for n in (1, 8, 9, 16, 3):
            assert svc.embed(_rows(n, n), timeout=120).shape == (n, 64)
        assert svc.engine.compile_count == warm
    assert svc.meter.total_requests == 5


def test_cli_smoke_on_cpu(tmp_path):
    assert serve_main(["--no-cuda", "--arch", "vit_s16", "--attn-impl",
                       "flash", "--image-size-override", "32", "--no-half",
                       "--smoke", "8", "--smoke-streams", "2",
                       "--max-batch", "8", "--log-dir", str(tmp_path)]) == 0


def test_cli_without_a_card_fails_loudly(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go to it")
    rc = serve_main(["--arch", "vit_s16", "--attn-impl", "flash",
                     "--image-size-override", "32", "--smoke", "2"])
    assert rc != 0
    assert "--no-cuda" in capsys.readouterr().err


def test_cli_refuses_unported_arch(capsys, tmp_path):
    # every arch of the JAX registry is ported now; one outside it is not
    assert serve_main(["--no-cuda", "--smoke", "1", "--arch",
                       "alexnet", "--log-dir", str(tmp_path)]) != 0
    assert "unknown arch" in capsys.readouterr().err
