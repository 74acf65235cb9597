"""The port's offline linear evaluation held against the JAX package's.

- ``normalize_images``: the constants are made once per device and dtype
  (a host copy inside the forward cannot be captured in a CUDA graph);
  the output is bitwise what the per-call construction gave, and within
  fp32 1e-6 of JAX ``normalize_images``.
- ``train_linear_probe``: the same feature matrix through both packages,
  3 epochs: ``W`` and ``b`` at rtol = atol = 1e-4 (fp32, another summation
  order in each matmul).  ``fit_and_score``: top-1, top-5 and train
  accuracy equal on well-separated Gaussian blobs.
- ``extract_features`` pads the remainder batch as JAX's does: equal
  features and labels for one apply function.
- ``linear_eval`` end to end with a tiny BYOL ResNet on flax weights
  (``convert.from_flax``, perturbed statistics) over the same numpy
  batches: features at fp32 1e-4 of JAX's, the same top-1 and top-5.
- The training CLI with ``--linear-eval`` on ``synth`` prints JAX's line,
  with a top-1 above chance.

Fits run on one torch thread (the ``one_thread`` fixture).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models import resnet as jax_resnet
from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.training import linear_eval as jax_le
from byol_tpu.training.steps import normalize_images as jax_normalize
from byol_tpu_torch.cli import main as train_main
from byol_tpu_torch.convert import from_flax
from byol_tpu_torch.data import readers
from byol_tpu_torch.models import resnet as torch_resnet
from byol_tpu_torch.models.byol_net import BYOLNet
from byol_tpu_torch.training import linear_eval as torch_le
from byol_tpu_torch.training.state import create_train_state
from tests.test_torch_loader import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE, CLASSES, HEAD, PROJ = 32, 10, 32, 16


# ---------------------------------------------------------------------------
# normalize_images (the constants made once)
# ---------------------------------------------------------------------------

def _normalize_per_call(x):
    """The construction before the constants were cached: a host tensor
    copied to x's device on every call."""
    mean = torch.tensor(torch_le.IMAGENET_MEAN, dtype=x.dtype,
                        device=x.device)
    std = torch.tensor(torch_le.IMAGENET_STD, dtype=x.dtype, device=x.device)
    if x.shape[-1] != len(torch_le.IMAGENET_MEAN):
        mean, std = mean.mean(), std.mean()
    return (x - mean) / std


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_normalize_images_bitwise_as_before(channels, dtype):
    x = torch.from_numpy(np.random.RandomState(0).rand(
        2, 5, 5, channels).astype(np.float32)).to(dtype)
    got = torch_le.normalize_images(x)
    assert torch.equal(got, _normalize_per_call(x))
    assert got.dtype == dtype


@pytest.mark.parametrize("channels", [3, 1])
def test_normalize_images_matches_jax(channels):
    x = np.random.RandomState(1).rand(3, 4, 4, channels).astype(np.float32)
    got = torch_le.normalize_images(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_normalize_constants_made_once_and_usable_under_autograd():
    x = torch.rand(2, 3, 3, 3)
    with torch.inference_mode():          # first made where serving is
        torch_le.normalize_images(x)
    hits = torch_le._imagenet_stats.cache_info().hits
    mean, std = torch_le._imagenet_stats(x.device, x.dtype, True)
    assert torch_le._imagenet_stats.cache_info().hits == hits + 1
    assert not mean.is_inference() and not std.is_inference()
    # the training step normalises under autograd with the same constants
    w = torch.ones(3, requires_grad=True)
    torch_le.normalize_images(x * w).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


# ---------------------------------------------------------------------------
# the probe on features
# ---------------------------------------------------------------------------

def _blobs(n, d=16, classes=4, seed=0, spread=4.0):
    """tests/test_linear_eval.py's blobs: fixed centers, seeded samples."""
    centers = np.random.RandomState(42).randn(classes, d) * spread
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=(n,))
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int64)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
@pytest.mark.parametrize("batch_size", [128, 1024])
def test_probe_weights_match_jax(one_thread, weight_decay,  # noqa: F811
                                 batch_size):
    x, y = _blobs(800, spread=1.0)
    kw = dict(num_classes=4, epochs=3, batch_size=batch_size, lr=0.1,
              weight_decay=weight_decay, seed=5)
    w_jax, b_jax = jax_le.train_linear_probe(x, y, **kw)
    w, b = torch_le.train_linear_probe(x, y, **kw, device="cpu")
    assert w.shape == (16, 4) and b.shape == (4,)
    assert w.dtype == np.float32 and b.dtype == np.float32
    np.testing.assert_allclose(w, w_jax, **TOL)
    np.testing.assert_allclose(b, b_jax, **TOL)


def test_fit_and_score_equals_jax(one_thread):  # noqa: F811
    x, y = _blobs(600, classes=8, spread=1.2)
    xt, yt = _blobs(200, classes=8, seed=1, spread=1.2)
    want = jax_le.fit_and_score(x, y, xt, yt, 8, epochs=5, lr=0.5, seed=2)
    got = torch_le.fit_and_score(x, y, xt, yt, 8, epochs=5, lr=0.5, seed=2,
                                 device="cpu")
    # the blobs overlap enough that neither score is trivially 100
    assert 50.0 < want.top1 < 100.0 and want.top5 > want.top1
    # equal hit counts (one hit is 0.5 or 0.17 here), the float32
    # percents to within their rounding
    for field in ("top1", "top5", "train_acc"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    abs=1e-4), field
    assert (got.num_train, got.num_test) == (600, 200)


def test_extract_features_pads_the_remainder_as_jax():
    calls = []

    def apply_fn(x):
        calls.append(x.shape)
        return x.reshape(len(x), -1)[:, :4] * 2.0

    def batches():
        rng = np.random.RandomState(0)
        for n in (8, 8, 3):                       # 19 samples, remainder 3
            yield {"view1": rng.rand(n, 2, 2, 3).astype(np.float32),
                   "view2": None, "label": np.arange(n).astype(np.int32)}

    feats, labels = torch_le.extract_features(apply_fn, batches())
    assert feats.shape == (19, 4) and labels.shape == (19,)
    assert [s[0] for s in calls] == [8, 8, 8]     # one batch shape
    want_f, want_l = jax_le.extract_features(apply_fn, batches())
    np.testing.assert_array_equal(feats, want_f)
    np.testing.assert_array_equal(labels, want_l)


def test_mesh_is_refused_until_multi_gpu(one_thread):  # noqa: F811
    """Multi-GPU extraction is ported: a mesh of the world's data axis is
    accepted (the lockstep extraction of extract_features_spmd, here one
    rank) and scores as mesh=None does; a mesh the world cannot hold is
    refused."""
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel.mesh import MeshSpec
    from byol_tpu_torch.training.build import setup_training
    cfg = config_from_args(build_parser().parse_args([
        "--no-cuda", "--task", "fake", "--arch", "resnet18",
        "--image-size-override", "16", "--batch-size", "64", "--no-half",
        "--head-latent-size", "32", "--projection-size", "16",
        "--workers-per-replica", "0"]))
    loader = get_loader(cfg)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape)
    _, state, _, _, _ = setup_training(rcfg, "cpu")
    results = [torch_le.run_linear_eval_from_cfg(cfg, state, loader=loader,
                                                 mesh=mesh, epochs=2)
               for mesh in (None, MeshSpec())]
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="world size"):
        torch_le.run_linear_eval_from_cfg(cfg, state, loader=loader,
                                          mesh=MeshSpec(data=2), epochs=2)


# ---------------------------------------------------------------------------
# the whole protocol on a tiny BYOL ResNet
# ---------------------------------------------------------------------------

def _perturb_stats(tree, rng):
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        return (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                else 0.1 * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _torch_net():
    backbone = torch_resnet.ResNet(stage_sizes=[1, 1],
                                   block_cls=torch_resnet.Bottleneck,
                                   width=8, small_inputs=True,
                                   zero_init_residual=False)
    return BYOLNet(backbone, num_classes=CLASSES, head_latent_size=HEAD,
                   projection_size=PROJ)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX apply fn, the port's TrainState) on the same flax weights."""
    jnet = JaxBYOLNet(
        backbone=jax_resnet.ResNet(stage_sizes=[1, 1],
                                   block_cls=jax_resnet.Bottleneck, width=8,
                                   small_inputs=True,
                                   zero_init_residual=False),
        num_classes=CLASSES, head_latent_size=HEAD, projection_size=PROJ)
    variables = jax.device_get(jnet.init(
        {"params": jax.random.PRNGKey(4)}, jnp.zeros((2, SIZE, SIZE, 3)),
        train=True, method="warmup"))
    params = variables["params"]
    stats = _perturb_stats(variables["batch_stats"],
                           np.random.RandomState(4))
    jax_apply = jax.jit(jax_le.frozen_representation_fn(jnet, params, stats))
    net = _torch_net()
    net.load_state_dict(from_flax(params, stats, like=net.state_dict()),
                        strict=True)
    return jax_apply, create_train_state(net)


def _batches(n, batch, train):
    x, y = readers.load_synth(n, SIZE, seed=3, train=train)
    x = x.astype(np.float32) / np.float32(255.0)

    def make():
        for lo in range(0, n, batch):
            yield {"view1": x[lo:lo + batch], "view2": x[lo:lo + batch],
                   "label": y[lo:lo + batch].astype(np.int32)}
    return make


def test_linear_eval_end_to_end_matches_jax(one_thread,  # noqa: F811
                                            tiny_pair):
    jax_apply, state = tiny_pair
    apply_fn = torch_le.encoder_apply_fn(_torch_net(), state)
    train, test = _batches(200, 32, True), _batches(60, 32, False)
    feats, labels = torch_le.extract_features(apply_fn, train())
    want_f, want_l = jax_le.extract_features(jax_apply, train())
    assert feats.shape == (200, 64)               # remainder 8 padded
    np.testing.assert_allclose(feats, want_f, **TOL)
    np.testing.assert_array_equal(labels, want_l)

    kw = dict(epochs=10, lr=0.1, seed=1)
    want = jax_le.linear_eval(jax_apply, train(), test(), CLASSES, **kw)
    got = torch_le.linear_eval(apply_fn, train(), test(), CLASSES, **kw,
                               device="cpu")
    assert want.top1 > 30.0                       # chance is 10
    # equal hit counts; the float32 percent rounds in other places in the
    # two packages (one ulp at 87 is 7.6e-6; one hit here is 1.67)
    assert got.top1 == pytest.approx(want.top1, abs=1e-4)
    assert got.top5 == pytest.approx(want.top5, abs=1e-4)
    assert (got.num_train, got.num_test) == (200, 60)


def test_encoder_takes_the_state_not_the_net_it_is_given(tiny_pair):
    _, state = tiny_pair
    rows = np.random.RandomState(9).rand(4, SIZE, SIZE, 3).astype(
        np.float32)
    got = torch_le.encoder_apply_fn(_torch_net(), state)(rows)
    want = torch_le.frozen_representation_fn(state.net)(
        torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


LINE = re.compile(r"^linear_eval\(offline\): top1 (\d+\.\d\d) top5 "
                  r"(\d+\.\d\d) \(train acc (\d+\.\d\d), 256 train / 32 "
                  r"test\)$", re.M)


def test_cli_linear_eval_prints_jax_line(one_thread, tmp_path,  # noqa: F811
                                         capsys):
    rc = train_main([
        "--no-cuda", "--task", "synth", "--num-synth-samples", "256",
        "--arch", "resnet18", "--image-size-override", "32",
        "--batch-size", "32", "--epochs", "1", "--debug-step", "--no-half",
        "--warmup", "0",
        "--head-latent-size", "32", "--projection-size", "16",
        "--grapher", "null", "--spans", "off", "--workers-per-replica", "0",
        "--model-dir", str(tmp_path / "m"), "--log-dir", str(tmp_path / "l"),
        "--linear-eval"])
    assert rc == 0
    match = LINE.search(capsys.readouterr().out)
    assert match, "no linear_eval(offline) line in JAX's format"
    top1, top5, train_acc = map(float, match.groups())
    assert top1 > 10.0 and top5 >= top1 and train_acc > 10.0
