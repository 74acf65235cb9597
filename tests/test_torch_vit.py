"""The port's ViT held against the flax ViT on converted weights.

A tiny ViT (width 64, depth 2, 2 heads, patch 8, 32 px) is initialised by
flax; its parameters go through ``convert.from_flax`` into the port's
module, and both run the same numpy batch.  Tolerances: fp32 1e-4 (another
summation order in every product and LayerNorm); bf16 3e-2 (bf16 rounds at
other points in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models.vit import ViT as JaxViT
from byol_tpu_torch.convert import from_flax
from byol_tpu_torch.models.layers import init_params
from byol_tpu_torch.models.registry import get_backbone, get_spec
from byol_tpu_torch.models.vit import ViT

TINY = dict(width=64, depth=2, num_heads=2, patch_size=8)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _images(n=3, size=32, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _flax_params(pooling, attn_impl="dense"):
    net = JaxViT(**TINY, pooling=pooling, attn_impl=attn_impl)
    return jax.device_get(net.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 32, 32, 3)))["params"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("pooling", ["cls", "gap"])
def test_features_match_flax(pooling, attn_impl, dtype):
    params = _flax_params(pooling)
    x = _images()
    want = JaxViT(**TINY, pooling=pooling, attn_impl=attn_impl,
                  dtype=getattr(jnp, dtype)).apply({"params": params},
                                                   jnp.asarray(x))
    net = ViT(**TINY, pooling=pooling, attn_impl=attn_impl,
              dtype=getattr(torch, dtype), image_size=32)
    net.load_state_dict(from_flax(params, like=net.state_dict()),
                        strict=True)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_from_flax_raises_on_missing_and_unconsumed_leaves():
    params = _flax_params("cls")
    net = ViT(**TINY, image_size=32)
    sd = from_flax(params, like=net.state_dict())
    assert sd["patch_embed.weight"].shape == (64, 3, 8, 8)      # OIHW
    assert sd["block0.attn.qkv.weight"].shape == (192, 64)      # (out, in)
    broken = {k: v for k, v in params.items() if k != "ln_final"}
    with pytest.raises(ValueError, match="missing"):
        from_flax(broken, like=net.state_dict())
    extra = dict(params, stray={"kernel": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        from_flax(extra, like=net.state_dict())
    with pytest.raises(ValueError, match="rank"):
        from_flax({"odd": {"kernel": np.zeros((2, 3, 4), np.float32)}})
    with pytest.raises(ValueError, match="batch_stats"):
        from_flax(params, {"ghost": {"mean": np.zeros(2, np.float32),
                                     "var": np.ones(2, np.float32)}})


def test_init_follows_flax_distributions():
    net = ViT(**TINY, image_size=32)
    init_params(net, torch.Generator().manual_seed(0))
    w = net.block0.mlp.fc1.weight                   # fan_in 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.01
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.8796256610342398 + 1e-6
    assert torch.count_nonzero(net.block0.mlp.fc1.bias) == 0
    assert torch.count_nonzero(net.cls_token) == 0
    assert abs(net.pos_embedding.std().item() - 0.02) < 0.003
    assert torch.equal(net.ln_final.weight, torch.ones(64))
    again = ViT(**TINY, image_size=32)
    init_params(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.block1.attn.qkv.weight,
                       net.block1.attn.qkv.weight)


def test_registry_specs_and_unported_archs():
    for name, (width, depth, heads) in {"vit_b16": (768, 12, 12),
                                        "vit_l16": (1024, 24, 16),
                                        "vit_s16": (384, 12, 6)}.items():
        spec = get_spec(name)
        assert spec.feature_dim == width and not spec.has_batchnorm
    vit, dim = get_backbone("vit_s16", image_size=32, attn_impl="flash")
    assert (vit.depth, vit.num_heads, vit.patch_size, dim) == (12, 6, 16, 384)
    for name, dim in {"resnet18": 512, "resnet50": 2048,
                      "resnet50w2": 4096, "wide_resnet50_2": 2048}.items():
        assert get_spec(name).feature_dim == dim and \
            get_spec(name).has_batchnorm
    with pytest.raises(ValueError, match="unknown arch"):
        get_spec("alexnet")
