"""The reference's encoders are found by family name, one file a family
(reference/families/), and the move of ResNet and ViT into their files
kept the reference's arithmetic: the shapes' digests and the values below
were taken from the reference as one file (reference/nets.py with both
encoders in it), with one CPU thread."""
import hashlib
import json
import shutil
import sys

import pytest
import torch

from conftest import REPO

TOY = '''
import torch

from reference.layers import linear


def param_shapes(arch, image_size):
    return {"backbone.embed.weight": (arch["width"], 3),
            "backbone.embed.bias": (arch["width"],)}


def feature_dim(arch):
    return arch["width"]


def represent(w, images, arch, cast):
    return linear(images.mean(dim=(1, 2)), w, "backbone.embed", cast)
'''

# (leaves, sha256 of the sorted (name, shape) list at 224 px, feature
# width, the test's image size) and, of two images there with heads
# 64 -> 16 and 10 classes, four values spread over each of the
# representation, projection, prediction and probe logits, flattened, and
# that tensor's mean |x|
PINNED = {
    "rn50.train.b4096": ((173, "6c16d7ee2e6962dd", 2048, 64), [
        [0.652813017, 0.27079314, 0.381099939, 0.213486925, 0.45376755],
        [-0.115255073, -0.594534576, 1.10711002, -0.898054361, 0.469784695],
        [-0.552038789, -0.635556519, -1.62837672, 0.311501861, 0.673831572],
        [-0.524043858, 0.082727313, 0.213256359, 0.315718234, 0.344513464],
    ]),
    "vit_b16.train.b256": ((164, "23f3fa0335543aba", 768, 32), [
        [-0.46957472, 0.181091711, -0.344022483, -0.491226524, 0.809681716],
        [0.876210511, -0.459489197, -0.283751965, -0.72048831, 0.469457374],
        [0.125196591, -0.917679608, 0.0472954921, -1.56818712, 0.714444235],
        [1.23034811, 0.251549423, -1.11232507, 0.584597945, 0.964239909],
    ]),
}
# Another order of the float32 sums (4 threads against 1) moves these by
# at most 3.7e-5 (the heads' BatchNorm over two rows amplifies it); a
# LayerNorm eps of 1e-5 in place of the ViT's 1e-6, or a BatchNorm eps of
# 1e-4 in place of 1e-5, moves some of them by 3e-3 or more.
TOL = 1e-4


def _conf(cell, **over):
    from harness import registry
    return dict(registry.spec(REPO, cell), **over)


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_encoders_compute_what_they_computed_before_the_move(
        cell, one_thread):
    from harness import weights
    from reference import nets
    from reference.precision import FP32, strict_fp32
    (leaves, shapes_sha, feat, size), pinned = PINNED[cell]
    shapes = nets.param_shapes(_conf(cell))
    assert len(shapes) == leaves
    assert _digest(json.dumps(sorted(shapes.items())).encode()) == shapes_sha
    conf = _conf(cell, image_size=size, num_classes=10,
                 heads={"head_latent_size": 64, "projection_size": 16})
    assert nets.feature_dim(conf["arch"]) == feat
    w = weights.make(5, nets.param_shapes(conf), conf["init"],
                     torch.device("cpu"))
    images = torch.rand(2, size, size, 3,
                        generator=torch.Generator().manual_seed(9))
    with strict_fp32():
        rep = nets.represent(w, images, conf, FP32)
        proj = nets.head(w, rep, "projector", FP32)
        pred = nets.head(w, proj, "predictor", FP32)
        logits = nets.probe(w, rep, FP32)
    assert rep.shape == (2, feat)
    got = []
    for x in (rep, proj, pred, logits):
        f = x.detach().double().flatten()
        idx = torch.linspace(0, f.numel() - 1, 4).long()
        got.append(f[idx].tolist() + [f.abs().mean().item()])
    torch.testing.assert_close(torch.tensor(got, dtype=torch.float64),
                               torch.tensor(pinned, dtype=torch.float64),
                               rtol=TOL, atol=TOL)


def test_a_family_is_a_file_found_by_its_name(tmp_path, monkeypatch):
    """A family file dropped into a copy of families/ is found through
    nets' public functions, with no other file edited."""
    from reference import families, nets
    from reference.precision import FP32
    copy = tmp_path / "families"
    shutil.copytree(families.__path__[0], copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "toy.py").write_text(TOY)
    monkeypatch.setattr(families, "__path__", [str(copy)])
    loaded = set(sys.modules)
    try:
        conf = _conf("vit_b16.train.b256", arch={"family": "toy", "width": 16},
                     num_classes=10)
        shapes = nets.param_shapes(conf)
        assert shapes["backbone.embed.weight"] == (16, 3)
        assert shapes["projector.dense1.weight"] == (4096, 16)
        assert shapes["probe.classifier.weight"] == (10, 16)
        assert nets.feature_dim(conf["arch"]) == 16
        w = {"backbone.embed.weight": torch.ones(16, 3),
             "backbone.embed.bias": torch.zeros(16)}
        rep = nets.represent(w, torch.full((2, 4, 4, 3), 0.5), conf, FP32)
        assert torch.equal(rep, torch.full((2, 16), 1.5))
        # the copied families still serve the cells' configurations
        assert nets.feature_dim(_conf("rn50.train.b4096")["arch"]) == 2048
    finally:
        for name in set(sys.modules) - loaded:
            if name.startswith("reference.families."):
                del sys.modules[name]


def test_an_unknown_family_names_the_file_it_looked_for():
    from reference import nets
    arch = {"family": "swin", "width": 128}
    with pytest.raises(ValueError, match=r"families/swin\.py"):
        nets.feature_dim(arch)
    with pytest.raises(ValueError, match=r"families/swin\.py"):
        nets.param_shapes(_conf("vit_b16.train.b256", arch=arch))
