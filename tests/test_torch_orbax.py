"""The port's reader of the JAX package's orbax checkpoints
(checkpoint/ocdbt.py, checkpoint/orbax.py), held against orbax and
tensorstore on checkpoints ``byol_tpu``'s own ``CheckpointStore`` writes
here:

- the OCDBT reader's keys and values equal tensorstore's ``KvStore``, and
  its manifest, B+tree and version-tree nodes equal
  ``tensorstore.ocdbt.dump``, on orbax checkpoints and on stores
  tensorstore writes with interior nodes, indirect values and version-tree
  nodes;
- ``read_tree`` is bit for bit orbax's restore for the tiny ResNet
  TrainState replicated, sharded over the 8 host devices (several zarr
  chunks a leaf), with Polyak params, with the lamb and lbfgs chains, and
  for bf16 and scalar leaves; the zarr features orbax does not write here
  (edge chunks, order F, fill values, missing chunks, no compressor)
  against tensorstore's zarr driver;
- ``read_train_state -> train_state_from_flax -> load_converted`` equals
  the same path with orbax's restore in the reader's place;
- tensorstore and orbax read back what ``orbax_fixture.py`` writes;
- the committed JAX-written fixture reads to the digests orbax's restore
  gave;
- an uncommitted write, a chain of another optimizer, a leaf that cannot
  be placed and a corrupted node are refused.
"""
import hashlib
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from byol_tpu import checkpoint as jax_ckpt
from byol_tpu.models import resnet as jax_resnet
from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu_torch.checkpoint import ocdbt, orbax, orbax_fixture
from byol_tpu_torch.convert import train_state_from_flax
from tests.test_torch_ddp_step import assert_trees_equal
from tests.test_torch_optim_step import jax_opt_state
from tests.torch_ranks import CLASSES, HEAD, PROJ, WIDTH, tiny_state

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "orbax_jax_tiny"
SIZE = 16


# --------------------------------------------------------------------------
# JAX-written checkpoints
# --------------------------------------------------------------------------

def jax_tiny_net():
    """The JAX counterpart of tests/torch_ranks.py::tiny_net."""
    backbone = jax_resnet.ResNet(stage_sizes=[1, 1],
                                 block_cls=jax_resnet.Bottleneck,
                                 width=WIDTH, small_inputs=True,
                                 zero_init_residual=False,
                                 dtype=jnp.float32)
    return JaxBYOLNet(backbone=backbone, num_classes=CLASSES,
                      head_latent_size=HEAD, projection_size=PROJ)


def jax_tiny_state(optimizer="lars_momentum", polyak_ema=0.0, seed=0,
                   net=None, step=37, ema_step=41):
    """A JAX TrainState of ``net`` (the tiny net) with every leaf random
    (BatchNorm variances positive), as a state after some steps has them,
    traced with eval_shape (no compile)."""
    net = net or jax_tiny_net()
    tx, _ = jax_build_optimizer(optimizer, base_lr=0.2, global_batch_size=8,
                                weight_decay=1e-6, total_units=10,
                                warmup_units=0)

    def make():
        variables = net.init({"params": jax.random.PRNGKey(3)},
                             jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                             method="warmup")
        return jax_create_state(variables, tx, polyak_ema=polyak_ema)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if not jnp.issubdtype(s.dtype, jnp.floating):
            return jnp.asarray(np.full(s.shape, rng.randint(1, 50), s.dtype))
        x = rng.standard_normal(s.shape).astype(s.dtype) * 0.1
        if any(getattr(k, "key", None) == "var" for k in path):
            x = np.abs(x) + 0.5
        return jnp.asarray(x)
    state = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(make))
    return state.replace(step=jnp.int32(step), ema_step=jnp.int32(ema_step))


def sharded8(state):
    """Leaves whose first axis 8 divides sharded over the 8 host devices."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))

    def place(x):
        spec = PartitionSpec("x") if x.ndim and x.shape[0] % 8 == 0 \
            else PartitionSpec()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(place, state)


def save_jax(directory, state, epoch=0):
    store = jax_ckpt.CheckpointStore(str(directory))
    store.save(epoch, state, metric=1.0, is_best=True)
    store.close()
    return os.path.join(str(directory), f"ckpt-{epoch}")


CASES = {
    "replicated": lambda: jax_tiny_state(),
    "sharded8": lambda: sharded8(jax_tiny_state(seed=1)),
    "polyak": lambda: jax_tiny_state(polyak_ema=0.99, seed=2),
    "lamb": lambda: jax_tiny_state("lamb", seed=3),
    "lbfgs": lambda: jax_tiny_state("lbfgs", seed=4),
    "bf16_scalars": lambda: {
        "w": jnp.asarray(np.random.RandomState(5).standard_normal(
            (24, 16)), jnp.bfloat16),
        "s": jnp.int32(7), "f": jnp.float32(2.5),
        "l": [jnp.arange(5, dtype=jnp.float32), None, {"u": jnp.uint8(9)}]},
}
OPTIMIZERS = {"replicated": "lars_momentum", "sharded8": "lars_momentum",
              "polyak": "lars_momentum", "lamb": "lamb", "lbfgs": "lbfgs"}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{case: (state, ckpt dir)} written by byol_tpu's CheckpointStore."""
    root = tmp_path_factory.mktemp("jax_written")
    out = {}
    for case, make in CASES.items():
        state = make()
        out[case] = (state, save_jax(root / case, state))
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _bits(x):
    if isinstance(x, torch.Tensor):        # bf16: its uint16 bits
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy(
        ).tobytes()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return "bfloat16", a.shape, a.view(np.int16).tobytes()
    return a.dtype.str, a.shape, a.tobytes()


def assert_bitwise_restore(ours, restored):
    got, want = dict(_flat(ours)), dict(_flat(restored))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
        else:
            assert _bits(got[key]) == _bits(value), key


# --------------------------------------------------------------------------
# OCDBT against tensorstore
# --------------------------------------------------------------------------

def _loc(kind, ref):
    return (f"{kind}:{ref.file.base_path}:{ref.file.relative_path}:"
            f"{ref.offset}:{ref.length}")


def _stats(s):
    return {"num_indirect_value_bytes": s.num_indirect_value_bytes,
            "num_keys": s.num_keys, "num_tree_bytes": s.num_tree_bytes}


def manifest_as_dump(m):
    c = m.config
    compression = None if c.compression is None else {"id": "zstd"}
    if c.zstd_level:
        compression["level"] = c.zstd_level
    versions = []
    for v in m.versions:
        root = {"statistics": _stats(v.statistics)}
        if not v.root.missing:
            root["location"] = _loc("btreenode", v.root)
        versions.append({"commit_time": v.commit_time,
                         "generation_number": v.generation_number,
                         "root": root, "root_height": v.root_height})
    nodes = [{"commit_time": n.commit_time,
              "generation_number": n.generation_number,
              "height": n.height,
              "location": _loc("versionnode", n.location),
              "num_generations": n.num_generations}
             for n in m.version_tree_nodes]
    return {"config": {"compression": compression,
                       "max_decoded_node_bytes": c.max_decoded_node_bytes,
                       "max_inline_value_bytes": c.max_inline_value_bytes,
                       "uuid": c.uuid.hex(),
                       "version_tree_arity_log2": c.version_tree_arity_log2},
            "version_tree_nodes": nodes, "versions": versions}


def btree_as_dump(node):
    entries = []
    for e in node.entries:
        if node.height == 0:
            if isinstance(e.value, ocdbt.Ref):
                entries.append({"indirect_value": _loc("value", e.value),
                                "key": e.key})
            else:
                entries.append({"inline_value": e.value, "key": e.key})
        else:
            entries.append({
                "key": e.key, "location": _loc("btreenode", e.location),
                "statistics": _stats(e.statistics),
                "subtree_common_prefix":
                    e.key[:e.subtree_common_prefix_length]})
    return {"entries": entries, "height": node.height}


def version_node_as_dump(node):
    entries = []
    for e in node.entries:
        if node.height == 0:
            root = {"statistics": _stats(e.statistics)}
            if not e.root.missing:
                root["location"] = _loc("btreenode", e.root)
            entries.append({"commit_time": e.commit_time,
                            "generation_number": e.generation_number,
                            "root": root, "root_height": e.root_height})
        else:
            entries.append({"commit_time": e.commit_time,
                            "generation_number": e.generation_number,
                            "height": e.height,
                            "location": _loc("versionnode", e.location),
                            "num_generations": e.num_generations})
    return {"entries": entries, "height": node.height,
            "version_tree_arity_log2": node.version_tree_arity_log2}


def _normalise(dump):
    """The dump with the empty-config compression spelt as ours."""
    cfg = dump.get("config", {})
    if "compression" in cfg and not cfg["compression"]:
        cfg["compression"] = None
    cfg.setdefault("compression", None)
    return dump


def _tensorstore_written(root, kind):
    """An OCDBT store tensorstore writes: 'btree' with interior nodes,
    inline and indirect values and a zstd level; 'versions' with enough
    generations for out-of-line version-tree nodes."""
    base = f"file://{root}/"
    if kind == "btree":
        kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
            "compression": {"id": "zstd", "level": 5},
            "max_inline_value_bytes": 10,
            "max_decoded_node_bytes": 600}}).result()
        with ts.Transaction() as txn:
            for i in range(300):
                kv.with_transaction(txn)[f"key{i:04d}/x"] = (
                    b"v%d" % i) * (1 + i % 7)
    else:
        kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
            "version_tree_arity_log2": 2}}).result()
        for i in range(40):
            kv[f"k{i}"] = b"x" * i


@pytest.fixture(scope="module")
def stores(tmp_path_factory, written):
    root = tmp_path_factory.mktemp("ocdbt")
    out = {"orbax_replicated": written["replicated"][1],
           "orbax_sharded8": written["sharded8"][1],
           "fixture": str(FIXTURE / "run" / "ckpt-0")}
    for kind in ("btree", "versions"):
        _tensorstore_written(root / kind, kind)
        out[f"tensorstore_{kind}"] = str(root / kind)
    return out


@pytest.mark.parametrize("name", ["orbax_replicated", "orbax_sharded8",
                                  "fixture", "tensorstore_btree",
                                  "tensorstore_versions"])
def test_ocdbt_reader_equals_tensorstore(stores, name):
    root = stores[name]
    ours = ocdbt.OcdbtStore(root)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    keys = sorted(kv.list().result())
    assert ours.keys() == keys and keys
    many = ours.read_many(keys)
    for key in keys:
        want = kv.read(key).result().value
        assert ours.read(key) == want and many[key] == want, key
    base = ts.KvStore.open(f"file://{root}/").result()
    assert manifest_as_dump(ours.manifest) == _normalise(
        ts.ocdbt.dump(base).result())
    # every B+tree node on the path to every key, and every version node
    pending = [(ours.version.root, ours.version.root_height)]
    seen = 0
    while pending:
        ref, height = pending.pop()
        node = ours.node(ref)
        assert node.height == height
        assert btree_as_dump(node) == ts.ocdbt.dump(
            base, _loc("btreenode", ref)).result()
        seen += 1
        if height:
            pending += [(e.location, height - 1) for e in node.entries]
    assert seen >= (2 if name == "tensorstore_btree" else 1)
    vnodes = list(ours.manifest.version_tree_nodes)
    if name == "tensorstore_versions":
        assert vnodes
    while vnodes:
        ref = vnodes.pop()
        node = ours.version_node(ref.location)
        assert version_node_as_dump(node) == ts.ocdbt.dump(
            base, _loc("versionnode", ref.location)).result()
        if node.height:
            vnodes += list(node.entries)


# --------------------------------------------------------------------------
# orbax's tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_read_tree_is_bitwise_orbax_restore(written, case):
    state, path = written[case]
    restored = ocp.StandardCheckpointer().restore(path)
    assert_bitwise_restore(orbax.read_tree(path), restored)
    if case == "sharded8":
        keys = ocdbt.OcdbtStore(path).keys()
        assert sum(k.endswith(b"/1") or k.endswith(b"/1.0") for k in keys) \
            > 20


def test_read_tree_reads_only_the_given_prefixes(written):
    state, path = written["polyak"]
    stats = {}
    tree = orbax.read_tree(path, ("params", ("batch_stats",)), stats=stats)
    assert set(tree) == {"params", "batch_stats"}
    store = ocdbt.OcdbtStore(path)
    wanted = [k for k in store.keys()
              if k.startswith(b"params.") or k.startswith(b"batch_stats.")]
    assert stats["keys_read"] == len(wanted) < stats["keys_total"] == len(
        store.keys())
    want = jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats})
    assert_bitwise_restore(tree, want)


def _converted_through_orbax(state, path, optimizer):
    """The oracle path: orbax restores the TrainState (typed optax nodes),
    unpacked as the optimizer-parity tests unpack a live state."""
    restored = ocp.StandardCheckpointer().restore(
        path, jax_ckpt.abstract_like(state))
    fields, count = jax_opt_state(restored.opt_state)
    get = jax.device_get
    return train_state_from_flax({
        "params": get(restored.params),
        "batch_stats": get(restored.batch_stats),
        "target_params": get(restored.target_params),
        "polyak_params": get(restored.polyak_params),
        "optimizer": optimizer, "opt_state": fields, "count": count,
        "step": int(restored.step), "ema_step": int(restored.ema_step)})


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_read_train_state_path_equals_the_orbax_path(written, case):
    state, path = written[case]
    optimizer = OPTIMIZERS[case]
    polyak = 0.99 if case == "polyak" else 0.0
    ours = train_state_from_flax(orbax.read_train_state(path, optimizer))
    theirs = _converted_through_orbax(state, path, optimizer)
    a = tiny_state(ours, optimizer=optimizer, polyak_ema=polyak)[0]
    b = tiny_state(theirs, optimizer=optimizer, polyak_ema=polyak)[0]
    from byol_tpu_torch.training.state import canonical_state
    ca, cb = canonical_state(a), canonical_state(b)
    assert_trees_equal(ca, cb)
    assert (ca["step"], ca["ema_step"], ca["count"]) == (
        cb["step"], cb["ema_step"], cb["count"]) == (37, 41, ca["count"])
    assert ("polyak" in ca) == (case == "polyak")


# --------------------------------------------------------------------------
# the fixture writer and the committed fixture
# --------------------------------------------------------------------------

def test_tensorstore_and_orbax_read_back_the_fixture_writer(tmp_path):
    rng = np.random.RandomState(7)
    params = {"dense": {"kernel": rng.rand(300, 40).astype(np.float32),
                        "bias": rng.rand(40).astype(np.float32)},
              "bn": {"scale": np.ones(40, np.float32)}}
    tree = orbax_fixture.train_state_tree(
        params, {"bn": {"mean": rng.rand(40).astype(np.float32),
                        "var": rng.rand(40).astype(np.float32)}},
        jax.tree_util.tree_map(lambda x: x * 2, params),
        jax.tree_util.tree_map(lambda x: x * 3, params),
        step=11, ema_step=12, count=13)
    info = orbax_fixture.write_run(str(tmp_path), 2, tree, metric=0.25)
    path = str(tmp_path / "ckpt-2")
    assert info["array_bytes"] == 4 * (3 * (300 * 40 + 80) + 80) + 12
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    keys = sorted(kv.list().result())
    ours = ocdbt.OcdbtStore(path)
    assert ours.keys() == keys
    assert all(ours.read(k) == kv.read(k).result().value for k in keys)
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{path}/",
        "path": "target_params.dense.kernel/"}}).result().read().result()
    assert np.array_equal(arr, params["dense"]["kernel"] * 2)
    restored = ocp.StandardCheckpointer().restore(path)
    assert_bitwise_restore(orbax.read_tree(path), restored)
    assert_bitwise_restore(tree, restored)
    converted = train_state_from_flax(orbax.read_train_state(path))
    assert (converted["step"], converted["ema_step"], converted["count"]) \
        == (11, 12, 13)
    assert json.loads((tmp_path / "meta.json").read_text())["last_epoch"] \
        == 2


def test_to_flax_inverts_from_flax():
    from byol_tpu_torch.convert import from_flax
    from tests.torch_ranks import seeded_net
    sd = {k: v.detach() for k, v in seeded_net().state_dict().items()}
    params, stats = orbax_fixture.to_flax(sd)
    back = from_flax(params, stats)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_committed_fixture_reads_to_orbax_digests():
    want = json.loads((FIXTURE / "leaf_sha256.json").read_text())
    tree = orbax.read_tree(str(FIXTURE / "run" / "ckpt-0"))
    got = {".".join(p): v for p, v in _flat(tree) if v is not None}
    assert set(got) == set(want)
    for name, leaf in got.items():
        arr = np.asarray(leaf)
        assert [arr.dtype.str, list(arr.shape)] == [
            want[name]["dtype"], want[name]["shape"]], name
        assert hashlib.sha256(arr.tobytes()).hexdigest() == \
            want[name]["sha256"], name
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 1 << 20
    keys = ocdbt.OcdbtStore(str(FIXTURE / "run" / "ckpt-0")).keys()
    assert any(k.endswith(b"/1") for k in keys)       # several chunks


# --------------------------------------------------------------------------
# zarr features orbax does not write here
# --------------------------------------------------------------------------

def test_zarr_edge_chunks_order_fill_and_missing_chunks(tmp_path):
    """Arrays tensorstore writes into an OCDBT store with edge chunks,
    Fortran order, a fill value, missing chunks, no compressor and bf16,
    under a hand-made orbax _METADATA: read_tree equals tensorstore's
    zarr driver."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.RandomState(0)
    specs = {
        "a": dict(dtype="<f4", shape=[10, 7], chunks=[4, 3], order="F",
                  fill_value=1.5, compressor={"id": "zstd", "level": 3}),
        "b": dict(dtype="<i4", shape=[9], chunks=[4], order="C",
                  fill_value=-2, compressor=None),
        "c": dict(dtype="bfloat16", shape=[5, 6], chunks=[2, 6],
                  order="C", fill_value="NaN",
                  compressor={"id": "zstd", "level": 1}),
        "d": dict(dtype="<f8", shape=[4, 4], chunks=[3, 3], order="C",
                  fill_value=None, compressor={"id": "zstd", "level": 19}),
    }
    want = {}
    for name, spec in specs.items():
        arr = ts.open({"driver": "zarr", "kvstore": dict(base, path=f"{name}/"),
                       "metadata": spec}, create=True).result()
        if name == "c":
            value = rng.standard_normal((2, 6)).astype(np.float32)
            arr[0:2, :].write(value.astype(arr.dtype.numpy_dtype)).result()
        elif name == "b":
            arr[0:4].write(np.arange(4, dtype=np.int32)).result()
        else:
            rows = spec["shape"][0] // 2      # the last chunk row missing
            value = rng.standard_normal(spec["shape"]) * 10
            arr[:rows].write(value[:rows].astype(
                arr.dtype.numpy_dtype)).result()
        want[name] = arr.read().result()
    (tmp_path / orbax.TREE_METADATA).write_text(json.dumps({
        "tree_metadata": {str((n,)): {
            "key_metadata": [{"key": n, "key_type": 2}],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False}}
            for n in specs},
        "use_ocdbt": True, "use_zarr3": False}))
    (tmp_path / orbax.COMMIT_MARKER).write_text("{}")
    got = orbax.read_tree(str(tmp_path))
    for name in specs:
        assert _bits(got[name]) == _bits(want[name]), name


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_refusals_name_what_they_refuse(written, tmp_path):
    _, lamb = written["lamb"]
    with pytest.raises(ValueError, match="'lars_momentum' keeps.*trace"):
        orbax.read_train_state(lamb, "lars_momentum")
    uncommitted = tmp_path / "ckpt-0"
    shutil.copytree(written["replicated"][1], uncommitted)
    (uncommitted / orbax.COMMIT_MARKER).unlink()
    assert orbax.looks_like_orbax(str(uncommitted))
    with pytest.raises(ValueError, match="uncommitted"):
        orbax.read_tree(str(uncommitted))
    _, other = written["bf16_scalars"]
    with pytest.raises(ValueError, match=r"\('f',\).*cannot be placed"):
        orbax.read_train_state(other)
    corrupt = tmp_path / "corrupt"
    shutil.copytree(written["replicated"][1], corrupt)
    root = ocdbt.OcdbtStore(str(corrupt)).version.root
    node = corrupt / root.file.path
    data = bytearray(node.read_bytes())
    data[root.offset + 20] ^= 0x40
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax.read_tree(str(corrupt))
