"""Writes this directory's JAX-written orbax checkpoint and its digests.

    JAX_PLATFORMS=cpu python tests/fixtures/orbax_jax_tiny/make_fixture.py
    JAX_PLATFORMS=cpu python tests/fixtures/orbax_jax_tiny/make_fixture.py \
        --resnet50 DIR


The JAX package's tiny BYOL net (ResNet of two Bottleneck stages at width
8 on small inputs, heads 32/16, 10 classes: the port's
``tests/torch_ranks.py::tiny_net``), initialised from seed 0, its
lars_momentum chain updated once on random gradients (step 1, a non-zero
momentum trace), every leaf whose first axis 8 divides sharded over 8 host
devices (several zarr chunks each), saved by ``byol_tpu``'s own
``CheckpointStore`` (orbax, OCDBT, zstd level-1 chunks) as epoch 0 of
``run/``.  ``leaf_sha256.json`` holds the SHA-256, dtype and shape of
every array leaf as orbax's own restore gives it, keyed by the leaf's
orbax name (its key path joined with ``.``).

With ``--resnet50 DIR`` it writes nothing here: DIR/ckpt-0 becomes a
full-width ResNet-50 TrainState of the default config (heads 4096/256, 10
classes, lars_momentum; every leaf random from seed 0) saved by the same
store, the checkpoint ``scripts/orbax_read_rate.py`` times the port's
reader on.
"""
import hashlib
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from byol_tpu import checkpoint as jax_ckpt  # noqa: E402
from byol_tpu.models import resnet as jax_resnet  # noqa: E402
from byol_tpu.models.byol_net import BYOLNet  # noqa: E402
from byol_tpu.optim.factory import build_optimizer  # noqa: E402
from byol_tpu.training.state import create_train_state  # noqa: E402

WIDTH, CLASSES, HEAD, PROJ, SIZE = 8, 10, 32, 16, 16
WD, BASE_LR, LR_BATCH, TOTAL = 1e-3, 2.0, 8, 24
EPOCH = 0


def jax_state():
    backbone = jax_resnet.ResNet(stage_sizes=[1, 1],
                                 block_cls=jax_resnet.Bottleneck,
                                 width=WIDTH, small_inputs=True,
                                 zero_init_residual=False,
                                 dtype=jnp.float32)
    net = BYOLNet(backbone=backbone, num_classes=CLASSES,
                  head_latent_size=HEAD, projection_size=PROJ)
    tx, _ = build_optimizer("lars_momentum", base_lr=BASE_LR,
                            global_batch_size=LR_BATCH, weight_decay=WD,
                            total_units=TOTAL, warmup_units=0)
    variables = net.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                         method="warmup")
    state = create_train_state(variables, tx)
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 0.01), state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return state.replace(params=optax.apply_updates(state.params, updates),
                         opt_state=opt_state, step=jnp.int32(1),
                         ema_step=jnp.int32(1))


def shard(state):
    mesh = Mesh(np.array(jax.devices()), ("x",))

    def place(x):
        if x.ndim and x.shape[0] % 8 == 0:
            return jax.device_put(x, NamedSharding(mesh, PartitionSpec("x")))
        return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
    return jax.tree_util.tree_map(place, state)


def digests(ckpt_dir):
    restored = ocp.StandardCheckpointer().restore(ckpt_dir)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        arr = np.asarray(leaf)
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                     "dtype": arr.dtype.str, "shape": list(arr.shape)}
    return dict(sorted(out.items()))


def write_resnet50(directory):
    from byol_tpu.cli import build_parser, config_from_args
    from byol_tpu.core import config as jax_config
    from byol_tpu.training import build as jax_build
    cfg = config_from_args(build_parser().parse_args(
        ["--arch", "resnet50", "--num-replicas", "1"]))
    rcfg = jax_config.resolve(cfg, num_train_samples=8192,
                              num_test_samples=4096, output_size=10,
                              input_shape=(224, 224, 3))
    net = jax_build.build_net(rcfg)
    tx, _ = jax_build.build_tx(rcfg)

    def make():
        return create_train_state(jax_build.init_variables(
            net, rcfg, jax.random.PRNGKey(0)), tx)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape, np.float32) * 0.05)
        if jnp.issubdtype(s.dtype, jnp.floating) else jnp.zeros(s.shape,
                                                               s.dtype),
        jax.eval_shape(make))
    store = jax_ckpt.CheckpointStore(str(directory))
    store.save(0, state.replace(step=jnp.int32(8), ema_step=jnp.int32(8)),
               metric=1.0, is_best=True)
    store.close()
    print(f"wrote {directory}/ckpt-0")


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--resnet50":
        return write_resnet50(Path(sys.argv[2]))
    run = HERE / "run"
    shutil.rmtree(run, ignore_errors=True)
    store = jax_ckpt.CheckpointStore(str(run))
    store.save(EPOCH, shard(jax_state()), metric=1.25, is_best=True)
    store.close()
    with open(HERE / "leaf_sha256.json", "w") as f:
        json.dump(digests(str(run / f"ckpt-{EPOCH}")), f, indent=1)
    size = sum(p.stat().st_size for p in HERE.rglob("*") if p.is_file())
    print(f"wrote {run} ({size} bytes in {HERE.name}/)")


if __name__ == "__main__":
    main()
