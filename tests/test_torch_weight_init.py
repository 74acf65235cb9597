"""``--weight-initialization`` in the port (byol_tpu_torch/models/init.py)
held against the JAX package's registry (byol_tpu/models/init.py).

The draws cannot be JAX's bits, so the tests hold what can be held: the
same leaves change (the JAX tree's rank >= 2 ``kernel`` leaves, mapped to
torch names through ``convert.from_flax``), each scheme's spread matches
flax's for the JAX-shaped fans (within 10 %), ``orthogonal`` is orthogonal
in flax's (fan, out) layout, the draws are a function of the seed, and an
unknown name raises JAX's error."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models import init as jax_init
from byol_tpu_torch.convert import from_flax
from byol_tpu_torch.core.rng import split_named
from byol_tpu_torch.models import init as torch_init
from tests.test_torch_train_step import _jax_net

NAMES = ("xavier_uniform", "xavier_normal", "kaiming_uniform",
         "kaiming_normal", "orthogonal", "truncated_normal", "lecun_normal")
# flax shapes of the net's kernel kinds, large enough for a spread within
# a few percent: a 3x3 conv, a 1x1 conv, a Dense
SHAPES = ((3, 3, 64, 128), (1, 1, 256, 64), (512, 256))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, restored after (see tests/test_torch_accum.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_registry_names_match_jax():
    assert torch_init.available() == jax_init.available() == tuple(
        sorted(NAMES))


def _jax_variables():
    return jax.device_get(_jax_net(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
        train=True, method="warmup"))


@pytest.mark.parametrize("name", NAMES)
def test_same_leaves_change_as_in_jax(name):
    variables = _jax_variables()
    before = from_flax(variables["params"], variables["batch_stats"])
    after_jax = from_flax(jax.device_get(jax_init.apply_weight_init(
        variables["params"], jax.random.PRNGKey(1), name)),
        variables["batch_stats"])
    jax_changed = {k for k in before
                   if not np.array_equal(before[k], after_jax[k])}
    from byol_tpu_torch.models import resnet as torch_resnet
    from byol_tpu_torch.models.byol_net import BYOLNet
    net = BYOLNet(torch_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=torch_resnet.Bottleneck, width=8,
        small_inputs=True, zero_init_residual=False), num_classes=10,
        head_latent_size=32, projection_size=16)
    net.load_state_dict(before)
    torch_init.apply_weight_init(net, torch.Generator().manual_seed(1), name)
    after = net.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed == jax_changed
    assert changed and all(k.endswith(".weight") and after[k].ndim >= 2
                           for k in changed)


def _target_std(name, shape):
    """The std of flax's distribution for ``shape`` (flax layout)."""
    fan_in, fan_out = torch_init._fans(shape)
    fan_avg = (fan_in + fan_out) / 2
    # a unit normal cut at +-2 has std 0.8796; flax's variance_scaling
    # rescales it away, truncated_normal(0.02) keeps it
    return {"xavier_uniform": math.sqrt(1 / fan_avg),
            "xavier_normal": math.sqrt(1 / fan_avg),
            "kaiming_uniform": math.sqrt(2 / fan_in),
            "kaiming_normal": math.sqrt(2 / fan_in),
            "lecun_normal": math.sqrt(1 / fan_in),
            "truncated_normal": 0.02 * 0.87962566103423978,
            "orthogonal": math.sqrt(1 / max(
                shape[-1], math.prod(shape) // shape[-1]))}[name]


@pytest.mark.parametrize("name", NAMES)
def test_spread_matches_flax_for_jax_shaped_fans(name):
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        got = float(torch_init.REGISTRY[name](shape, gen).std())
        want = float(jnp.std(jax_init.REGISTRY[name](
            jax.random.PRNGKey(0), shape, jnp.float32)))
        target = _target_std(name, shape)
        assert abs(got - target) <= 0.1 * target, (shape, got, target)
        assert abs(want - target) <= 0.1 * target, (shape, want, target)


@pytest.mark.parametrize("shape", SHAPES + ((3, 3, 4, 64),))
def test_orthogonal_is_orthogonal_in_the_flax_layout(shape):
    w = torch_init.orthogonal(shape, torch.Generator().manual_seed(0))
    m = w.reshape(-1, shape[-1]).double()       # (fan, out)
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    torch.testing.assert_close(gram, torch.eye(gram.shape[0],
                                               dtype=torch.float64),
                               rtol=0, atol=1e-5)


def test_kernels_map_to_the_torch_layout():
    conv = torch.empty(128, 64, 3, 3)
    assert torch_init.flax_shape(conv) == (3, 3, 64, 128)
    assert torch_init.flax_shape(torch.empty(256, 512)) == (512, 256)
    k = torch.randn(3, 3, 64, 128)
    np.testing.assert_array_equal(
        torch_init.to_torch_layout(k).numpy(),
        from_flax({"c": {"kernel": k.numpy()}})["c.weight"].numpy())


def test_draws_are_deterministic_per_seed_and_keep_the_rest():
    def net_after(seed):
        from byol_tpu_torch.models import resnet as torch_resnet
        from byol_tpu_torch.models.byol_net import BYOLNet
        from byol_tpu_torch.models.layers import init_params
        net = BYOLNet(torch_resnet.ResNet(
            stage_sizes=[1, 1], block_cls=torch_resnet.Bottleneck, width=8,
            small_inputs=True), num_classes=10, head_latent_size=32,
            projection_size=16)
        init_params(net, torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in net.state_dict().items()}
        torch_init.apply_weight_init(
            net, split_named(seed, ("weight_init",))["weight_init"],
            "kaiming_uniform")
        return before, net.state_dict()
    before, a = net_after(7)
    _, b = net_after(7)
    _, c = net_after(8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    for k in a:
        if not (k.endswith(".weight") and a[k].ndim >= 2):
            assert torch.equal(a[k], before[k]), k    # biases, BN, stats
    assert torch_init.apply_weight_init(None, None, None) is None


def test_unknown_name_raises_jax_error():
    with pytest.raises(ValueError) as theirs:
        jax_init.apply_weight_init({}, jax.random.PRNGKey(0), "glorot")
    with pytest.raises(ValueError) as ours:
        torch_init.apply_weight_init(torch.nn.Linear(2, 2),
                                     torch.Generator(), "glorot")
    assert str(ours.value) == str(theirs.value)


def test_setup_training_draws_then_copies_the_target():
    """--weight-initialization through setup_training: the kernels are drawn
    from the weight_init stream, and the target (and the Polyak average)
    start as copies of the FINAL params."""
    from byol_tpu_torch.core.config import (Config, ModelConfig, OptimConfig,
                                            RegularizerConfig, TaskConfig,
                                            resolve)
    from byol_tpu_torch.training.build import setup_training

    def state_of(method):
        cfg = Config(task=TaskConfig(batch_size=8, epochs=1),
                     model=ModelConfig(arch="resnet18", head_latent_size=32,
                                       projection_size=16,
                                       weight_initialization=method),
                     regularizer=RegularizerConfig(polyak_ema=0.99),
                     optim=OptimConfig(fused_update="on"))
        rcfg = resolve(cfg, num_train_samples=16, num_test_samples=8,
                       output_size=10, input_shape=(16, 16, 3))
        return setup_training(rcfg, "cpu")[1]
    plain, drawn = state_of(None), state_of("orthogonal")
    assert not torch.equal(plain.params, drawn.params)
    assert torch.equal(drawn.target, drawn.params)
    assert torch.equal(drawn.polyak, drawn.params)
    kernels = [n for n, leaf in zip(drawn.names, drawn.shapes)
               if len(leaf) >= 2]
    for name, got in drawn.tree(drawn.params).items():
        want = plain.tree(plain.params)[name]
        assert torch.equal(got, want) == (name not in kernels), name
