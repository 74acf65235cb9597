"""The port's sequence axis and ring attention, held against the JAX
package's ``ring_attention`` and against the port's own one-rank dense
step.

Ranks are OS processes over gloo (tests/torch_ranks.py): one world of 2
(sequence 2) and one of 4 (data 2 x sequence 2, rank = 2 d + s), each
running its parts in one spawn, once per test session.  The JAX ring runs on the 8-device CPU
mesh of 4 data x 2 sequence (``mesh_dp_sp``): its data axis splits the
batch of 4 finer than the port's, which changes no row's arithmetic.

- Forward and ``grad`` of ``sum(out * w)`` against JAX's at 1e-5 (fp32;
  another summation order in the ring's matmuls); in float64 against the
  port's ``dense_attention`` at 1e-10.
- Two ViT BYOL steps (the tiny ViT, ``gap`` pooling, S = 16, the unfused
  chain, reference loss, float64) at data 2 x sequence 2 against the same
  global batches at one rank with ``dense``: rtol 1e-9, atol 1e-13 for
  the elements whose gradient is 0 in exact arithmetic (the Dense biases
  that feed a BatchNorm, and the key's bias, to which the softmax is
  invariant); the largest difference past rtol 1e-9 measured 7.7e-16.
  The ranks of a sequence group end bitwise equal, as do the states with
  ``--remat-policy dots``; ``--zero1 on`` equals off at 1e-5.
- The loader's rows and the step's augmentation draws are identical
  within a sequence group and differ across the data axis.
- JAX's refusals, with JAX's text: ``cls`` pooling's S = 17 at sequence 2,
  and ``--fused-augment on`` with sequence 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu_torch.ops.attention import dense_attention
from tests.torch_ranks import run_ranks_once, tiny_vit_net
from tests.torch_ranks import one_torch_thread  # noqa: F401
from tests.torch_ranks import train as train_job

B, H, S, D = 4, 2, 16, 8
VIT = dict(pooling="gap", attn_impl="ring")
SCFG = dict(norm_mode="reference", fused_update=False)


def _qkv(dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(dtype) for _ in range(4)]


def _jax_ring(mesh, q, k, v, w):
    from byol_tpu.parallel.ring_attention import ring_attention

    def loss(q, k, v):
        return (ring_attention(q, k, v, mesh=mesh) * w).sum()
    with mesh:
        out = ring_attention(q, k, v, mesh=mesh)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_ring_rows(results, want_out, want_grads, rows_of, **tol):
    for r, got in enumerate(results):
        rows = rows_of(r)
        np.testing.assert_allclose(got["out"].numpy(), want_out[rows],
                                   err_msg=f"rank {r} out", **tol)
        for name, g, want in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), want[rows],
                                       err_msg=f"rank {r} d{name}", **tol)


def _vit_tree(seed=0):
    from byol_tpu_torch.models.layers import init_params
    from byol_tpu_torch.training.state import (canonical_state,
                                               create_train_state)
    net = tiny_vit_net(torch.float64, pooling="gap")
    init_params(net, torch.Generator().manual_seed(seed))
    return canonical_state(create_train_state(
        net.double(), ema_init_mode="reference"))


def _views(n=2, rows=8, seed=3):
    rng = np.random.RandomState(seed)
    return [{"view1": rng.rand(rows, 32, 32, 3),
             "view2": rng.rand(rows, 32, 32, 3),
             "label": rng.randint(0, 10, rows).astype(np.int64)}
            for _ in range(n)]


def _train_spec(tree, batches, **extra):
    return dict(dict(canonical=tree, batches=batches, scfg=SCFG,
                     dtype=torch.float64, vit=VIT, sequence=2), **extra)


def _assert_trees(got, want, err, **tol):
    for key in ("params", "target", "momentum"):
        for name, w in want[key].items():
            np.testing.assert_allclose(got[key][name].numpy(), w.numpy(),
                                       err_msg=f"{err} {key} {name}", **tol)


def _assert_bitwise(got, want, err):
    for key in ("params", "target", "momentum"):
        for name, w in want[key].items():
            assert torch.equal(got[key][name], w), f"{err} {key} {name}"
    for name, w in want["batch_stats"].items():
        assert torch.equal(got["batch_stats"][name], w), f"{err} {name}"


@pytest.fixture(scope="module")
def jax_ring(mesh_dp_sp):
    """JAX's ring on the fp32 inputs: (out, grads), computed once."""
    q, k, v, w = _qkv()
    return _jax_ring(mesh_dp_sp, q, k, v, w)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    q, k, v, w = _qkv()
    q64, k64, v64, w64 = _qkv(np.float64, seed=1)
    spec = {"sequence": 2, "parts": [
        ("ring", {"sequence": 2, "qkv": [q, k, v], "w": w}),
        ("ring", {"sequence": 2, "qkv": [q64, k64, v64], "w": w64})]}
    return run_ranks_once("ring2", "multi", spec, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    q, k, v, w = _qkv()
    tree = _vit_tree()
    batches = _views()
    rng = np.random.RandomState(11)
    raw = [{"images": rng.randint(0, 256, (8, 40, 40, 3)).astype(np.uint8),
            "label": rng.randint(0, 10, 8).astype(np.int64)}
           for _ in range(1)]
    argv = ["--no-cuda", "--task", "fake", "--arch", "vit_s16",
            "--image-size-override", "32", "--batch-size", "8",
            "--sequence-parallel", "2", "--workers-per-replica", "0"]
    aug = dict(SCFG, augment_in_step=True, image_size=32, aug_seed=13)
    spec = {"sequence": 2, "parts": [
        ("ring", {"sequence": 2, "qkv": [q, k, v], "w": w}),
        ("train", _train_spec(tree, batches)),
        ("train", _train_spec(tree, batches, remat_policy="dots")),
        ("train", _train_spec(tree, batches, plan=dict(zero1=True))),
        ("ring_error", {"sequence": 2, "pooling": "cls"}),
        ("step_inputs", dict(canonical=_vit_tree(1), batches=raw, scfg=aug,
                             dtype=torch.float64, vit=VIT, sequence=2,
                             argv=argv))]}
    return {"tree": tree, "batches": batches,
            "results": run_ranks_once("ring4", "multi", spec, 4,
                                      tmp_path_factory, timeout=240.0)}


def test_ring_matches_jax_at_sequence_2(world2, jax_ring):
    out, grads = jax_ring
    _assert_ring_rows([r[0] for r in world2], out, grads,
                      lambda r: slice(None), rtol=1e-5, atol=1e-5)


def test_ring_matches_jax_at_data_2_by_sequence_2(world4, jax_ring):
    out, grads = jax_ring
    # rank 2 d + s holds rows [2 d, 2 d + 2)
    _assert_ring_rows([r[0] for r in world4["results"]], out, grads,
                      lambda r: slice(2 * (r // 2), 2 * (r // 2) + 2),
                      rtol=1e-5, atol=1e-5)


def test_ring_matches_dense_float64(world2):
    q, k, v, w = (torch.from_numpy(a) for a in _qkv(np.float64, seed=1))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = dense_attention(*qkv)
    (want * w).sum().backward()
    _assert_ring_rows([r[1] for r in world2], want.detach().numpy(),
                      [t.grad.numpy() for t in qkv], lambda r: slice(None),
                      rtol=1e-10, atol=1e-10)


def test_sequence_parallel_vit_step_equals_one_rank_dense_float64(world4):
    want = train_job(dict(_train_spec(world4["tree"], world4["batches"]),
                          vit=dict(pooling="gap", attn_impl="dense")))
    results = world4["results"]
    for r in range(4):
        got = results[r][1]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for key in ("loss_mean", "byol_loss_mean", "linear_loss_mean"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-9,
                                           err_msg=f"rank {r} step {i} {key}")
        _assert_trees(got["state"], want["state"], f"rank {r}", rtol=1e-9,
                      atol=1e-13)


def test_sequence_ranks_stay_bitwise_equal_and_remat_changes_nothing(world4):
    results = world4["results"]
    for d in range(2):
        _assert_bitwise(results[2 * d + 1][1]["state"],
                        results[2 * d][1]["state"], f"data {d} sequence 1")
    for r in range(4):
        _assert_bitwise(results[r][2]["state"], results[r][1]["state"],
                        f"rank {r} dots")


def test_zero1_at_data_2_by_sequence_2_equals_off(world4):
    for r, res in enumerate(world4["results"]):
        _assert_trees(res[3]["state"], res[1]["state"], f"rank {r} zero1",
                      rtol=1e-5, atol=1e-5)


def test_loader_rows_and_draws_are_shared_within_a_sequence_group(world4):
    got = [r[5] for r in world4["results"]]
    for d in range(2):
        a, b = got[2 * d], got[2 * d + 1]
        assert set(a["loader"]) == {"view1", "view2", "label"}
        for key in a["loader"]:
            assert np.array_equal(a["loader"][key], b["loader"][key])
        for x, y in zip(a["images"], b["images"]):
            assert np.array_equal(x, y)
        assert len(a["draws"]) == 1
        for sa, sb in zip(a["draws"], b["draws"]):
            for va, vb in zip(sa, sb):
                for fa, fb in zip(va, vb):
                    assert torch.equal(fa, fb)
    # the data axis splits the rows and the draws
    assert not np.array_equal(got[0]["loader"]["view1"],
                              got[2]["loader"]["view1"])
    assert not torch.equal(got[0]["draws"][0][0][0], got[2]["draws"][0][0][0])


def test_cls_pooling_at_sequence_2_raises_jax_error(world4, mesh_dp_sp):
    from byol_tpu.parallel.ring_attention import ring_attention
    q = jnp.zeros((4, 4, 17, 8))
    with pytest.raises(ValueError) as want:
        with mesh_dp_sp:
            ring_attention(q, q, q, mesh=mesh_dp_sp)
    for r in world4["results"]:
        assert r[4] == str(want.value)


def test_fused_augment_with_sequence_parallel_is_refused_with_jax_text():
    from byol_tpu.core import config as jax_config
    from byol_tpu_torch.core import config as torch_config

    def cfg(mod):
        c = mod.Config()
        return c.replace(
            task=dataclasses.replace(c.task, augment_placement="step",
                                     fused_augment="on"),
            device=dataclasses.replace(c.device, sequence_parallel=2))
    kw = dict(num_train_samples=8192, num_test_samples=10, output_size=10,
              input_shape=(224, 224, 3))
    with pytest.raises(ValueError) as want:
        jax_config.resolve(cfg(jax_config), **kw)
    with pytest.raises(ValueError) as got:
        torch_config.resolve(cfg(torch_config), **kw)
    assert str(got.value) == str(want.value)
    assert "sequence" in str(got.value)
