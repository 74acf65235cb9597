"""The port's ResNet held against the flax ResNet on converted weights.

Tiny ResNets (width 8, two stages of one block, Bottleneck and BasicBlock)
with each of the three stems run one numpy batch in both frameworks.  The
flax parameters and statistics are perturbed with numpy noise first, so
that no BatchNorm scale is zero and no statistic is trivial.
Tolerances: features fp32 1e-4 (another summation order in every conv and
reduction); running statistics after one train forward 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models import resnet as jax_resnet
from byol_tpu_torch.convert import from_flax
from byol_tpu_torch.models import resnet as torch_resnet
from byol_tpu_torch.models.layers import BatchNorm, init_params

STEMS = {"small": dict(small_inputs=True),
         "conv": dict(stem="conv"),
         "space_to_depth": dict(stem="space_to_depth")}
BLOCKS = ("Bottleneck", "BasicBlock")


def _perturb(tree, rng, kind):
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if kind == "stats":
            return (rng.uniform(0.5, 1.5, x.shape) if name == "var"
                    else 0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return (x + 0.05 * rng.randn(*x.shape) * x.std()).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(block, stem, seed=0):
    kw = dict(stage_sizes=[1, 1], width=8, **STEMS[stem])
    jnet = jax_resnet.ResNet(block_cls=getattr(jax_resnet, block), **kw)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                          train=False)
    rng = np.random.RandomState(seed)
    params = _perturb(jax.device_get(variables["params"]), rng, "params")
    stats = _perturb(jax.device_get(variables["batch_stats"]), rng, "stats")
    tnet = torch_resnet.ResNet(block_cls=getattr(torch_resnet, block), **kw)
    tnet.load_state_dict(from_flax(params, stats, like=tnet.state_dict()),
                         strict=True)
    return jnet, params, stats, tnet


def _images(n=4, seed=1):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("stem", sorted(STEMS))
@pytest.mark.parametrize("block", BLOCKS)
def test_features_and_running_stats_match_flax(block, stem, train):
    jnet, params, stats, tnet = _pair(block, stem)
    x = _images()
    if train:
        want, upd = jnet.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jnet.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
    tnet.train(train)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.shape == (4, tnet.feature_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # eval mode and the target network's mode leave the stats untouched
    want_stats = (jax.device_get(upd["batch_stats"]) if train else stats)
    sd = from_flax(params, want_stats)
    for name, buf in tnet.named_buffers():
        np.testing.assert_allclose(buf.numpy(), sd[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_bn_without_update_normalises_on_batch_stats():
    """The target forward: batch statistics, running statistics kept."""
    bn = BatchNorm(3)
    bn.train()
    x = torch.randn(5, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    bn.update_stats = False
    y = bn(x.to(torch.bfloat16))
    assert y.dtype == torch.float32
    assert torch.equal(bn.running_mean, torch.zeros(3))
    assert torch.equal(bn.running_var, torch.ones(3))
    xb = x.to(torch.bfloat16).float()
    want = (xb - xb.mean((0, 2, 3), keepdim=True)) / torch.sqrt(
        xb.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    bn.update_stats = True
    bn(x)
    torch.testing.assert_close(                 # biased variance, flax's 0.9
        bn.running_var, 0.9 + 0.1 * x.var((0, 2, 3), unbiased=False))


def test_from_flax_round_trip_on_a_resnet_tree():
    jnet, params, stats, tnet = _pair("Bottleneck", "conv")
    sd = from_flax(params, stats, like=tnet.state_dict())
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    assert "stem_conv.bias" not in sd                      # convs: no bias
    np.testing.assert_array_equal(                         # OIHW -> HWIO
        sd["stem_conv.weight"].permute(2, 3, 1, 0).numpy(),
        params["stem_conv"]["kernel"])
    np.testing.assert_array_equal(sd["stage2_block1.bn3.weight"].numpy(),
                                  params["stage2_block1"]["bn3"]["scale"])
    np.testing.assert_array_equal(
        sd["stage2_block1.downsample_bn.running_var"].numpy(),
        stats["stage2_block1"]["downsample_bn"]["var"])
    for key, value in tnet.state_dict().items():
        torch.testing.assert_close(value, sd[key], rtol=0, atol=0)


def test_init_he_normal_and_zero_init_residual():
    net = torch_resnet.make_resnet("resnet18")
    init_params(net, torch.Generator().manual_seed(0))
    w = net.stage3_block1.conv1.weight                   # fan_in 3*3*128
    assert abs(w.std().item() - (2.0 / 1152) ** 0.5) < 0.002
    assert torch.count_nonzero(net.stage3_block1.bn2.weight) == 0
    assert torch.equal(net.stage3_block1.bn1.weight, torch.ones(256))
    assert net.stage1_block1.has_downsample is False
    assert net.stage2_block1.has_downsample is True
    s2d = torch_resnet.make_resnet("resnet50", stem="space_to_depth")
    init_params(s2d, torch.Generator().manual_seed(0))
    assert s2d.stem_conv.weight.shape == (64, 3, 7, 7)
    assert abs(s2d.stem_conv.weight.std().item() - (2.0 / 147) ** 0.5) < 0.01
