"""The port's image_folder task (byol_tpu_torch/data/imagefolder.py) on a
tree written here with PIL: 2 classes x 6 JPEGs in train/ (plus one PNG),
2 x 2 in test/.  Both routes give views of the right shape in [0, 1]; the
native route's batches equal the JAX package's native route's bit for bit;
an on-disk valid/ root wins over valid_fraction."""
import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from byol_tpu.core import config as jax_config
from byol_tpu.data import loader as jax_loader
from byol_tpu.data import native_aug as jax_native
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.data import loader as torch_loader
from byol_tpu_torch.data import native_aug

SIZE, BATCH = 32, 4


def _write_tree(root, splits=(("train", 6), ("test", 2))):
    rng = np.random.RandomState(0)
    for split, n in splits:
        for cls in ("cat", "dog"):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(n):
                h, w = rng.randint(36, 60, size=2)
                img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{i}.jpg"),
                                          quality=90)
    img = rng.randint(0, 256, (40, 44, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(root, "train", "cat", "z.png"))


@pytest.fixture(scope="module", autouse=True)
def _private_jax_library(tmp_path_factory):
    """The JAX package's native library from a private build (see
    tests/test_torch_native_aug.py)."""
    from tests.test_torch_native_aug import private_jax_native
    with private_jax_native(tmp_path_factory):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    _write_tree(root)
    return root


def _cfgs(root, backend, task="image_folder", **more):
    out = []
    for lib in (jax_config, torch_config):
        out.append(lib.Config(
            task=lib.TaskConfig(task=task, data_dir=root, batch_size=BATCH,
                                image_size_override=SIZE,
                                data_backend=backend, **more),
            device=lib.DeviceConfig(num_replicas=1, seed=3,
                                    workers_per_replica=0)))
    return out


def _check_views(batches, n_batches):
    assert len(batches) == n_batches
    for b in batches:
        v1, v2 = np.asarray(b["view1"]), np.asarray(b["view2"])
        assert v1.shape == v2.shape == (BATCH, SIZE, SIZE, 3)
        assert v1.dtype == np.float32
        assert 0.0 <= min(v1.min(), v2.min())
        assert max(v1.max(), v2.max()) <= 1.0


@pytest.mark.parametrize("backend", ["tf", "native"])
def test_both_routes_make_views(tree, backend, capsys):
    _, cfg = _cfgs(tree, backend, task="multi_augment_image_folder")
    bundle = torch_loader.get_loader(cfg)
    assert (bundle.num_train_samples, bundle.num_test_samples,
            bundle.output_size) == (13, 4, 2)
    train = list(bundle.make_train_iter(0))
    _check_views(train, 3)
    assert all(not np.array_equal(a, b) for t in train
               for a, b in zip(t["view1"], t["view2"]))
    test = list(bundle.make_test_iter(0))
    _check_views(test, 1)
    assert np.array_equal(test[0]["label"], [0, 0, 1, 1])
    if backend == "native" and not native_aug.has_jpeg():
        assert "falls back" in capsys.readouterr().out


def test_native_route_bitwise_equal_jax(tree):
    if not (native_aug.has_jpeg() and jax_native.has_jpeg()):
        pytest.skip("a native library here was built without libjpeg")
    jcfg, cfg = _cfgs(tree, "native")
    theirs = jax_loader.get_loader(jcfg)
    ours = torch_loader.get_loader(cfg)
    for epoch in (0, 1):
        for make in ("make_train_iter", "make_test_iter"):
            a = list(getattr(ours, make)(epoch))
            b = list(getattr(theirs, make)(epoch))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                for k in ("view1", "view2", "label"):
                    assert np.array_equal(np.asarray(x[k]), y[k]), (make, k)


def test_valid_root_wins_over_valid_fraction(tmp_path):
    root = str(tmp_path)
    _write_tree(root, (("train", 6), ("test", 2), ("valid", 3)))
    for fraction in (0.0, 0.5):
        jcfg, cfg = _cfgs(root, "tf", valid_fraction=fraction)
        ours = torch_loader.get_loader(cfg)
        assert ours.num_valid_samples == 6 and ours.num_train_samples == 13
        valid = list(ours.valid_loader)
        assert [len(b["label"]) for b in valid] == [4, 2]
    os.rename(os.path.join(root, "valid"), os.path.join(root, "held"))
    jcfg, cfg = _cfgs(root, "tf", valid_fraction=0.5)
    ours = torch_loader.get_loader(cfg)
    theirs = jax_loader.get_loader(jcfg)
    assert (ours.num_valid_samples, ours.num_train_samples) == (
        theirs.num_valid_samples, theirs.num_train_samples) == (6, 7)


def test_refusals(tree, monkeypatch):
    _, cfg = _cfgs(tree, "device")
    with pytest.raises(ValueError, match="does not serve image_folder"):
        torch_loader.get_loader(cfg)
    _, cfg = _cfgs(tree, "tf")
    with pytest.raises(ValueError, match="does not serve image_folder"):
        torch_loader.get_loader(cfg.replace(task=dataclasses.replace(
            cfg.task, augment_placement="step")))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        torch_loader.get_loader(cfg)
