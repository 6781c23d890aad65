"""The port's sharding rules against the JAX package's: every spec of every
architecture's train state, serving cache and inputs equals the reference's
``PartitionSpec`` entry for entry, on both production meshes and in both
modes; the mirrors of ``tests/test_sharding.py`` (divisibility, the kv-head
rule, the fsdp experts regression, per-shard fault schedules); and the
placements of a spec (``tests/test_torch_distributed.py`` distributes them
over gloo ranks)."""
import hashlib

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.distributed import sharding as jax_sharding
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import serve as jax_serve
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.step import abstract_train_state as jax_abstract_state
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.core.tree import leaves_with_path, path_str
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import serve as serve_mod
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.step import abstract_train_state

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
MESH = make_abstract_mesh(*MESHES["1pod"])
MESH_MP = make_abstract_mesh(*MESHES["2pod"])


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax_sharding._path_str(p): leaf for p, leaf in flat}


def _flat(tree, is_leaf=None) -> dict:
    return {path_str(p): leaf
            for p, leaf in leaves_with_path(tree, is_leaf=is_leaf)}


def _same_specs(jax_tree, port_tree):
    want = {k: tuple(v) for k, v in _jax_flat(jax_tree).items()}
    got = _flat(port_tree, sharding.is_spec)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_reference(arch, mode, mesh):
    shape, names = MESHES[mesh]
    jp, _ = jax_abstract_state(jax_get_config(arch), JaxAdamWConfig())
    tp, _ = abstract_train_state(get_config(arch), AdamWConfig())
    _same_specs(jax_sharding.param_specs(jp, jax_abstract_mesh(shape, names),
                                         mode=mode),
                sharding.param_specs(tp, make_abstract_mesh(shape, names),
                                     mode=mode))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    """The port reads ``serve.cache_spec``'s (shape, dtype) records as they
    are, and meta tensors alike."""
    want = jax_sharding.cache_specs_tree(
        jax_serve.cache_spec(jax_get_config(arch), 128, 4096 + 256),
        jax_abstract_mesh(*MESHES["1pod"]))
    records = serve_mod.cache_spec(get_config(arch), 128, 4096 + 256)
    _same_specs(want, sharding.cache_specs_tree(records, MESH))
    meta = input_specs(get_config(arch), SHAPES["decode_32k"])["cache"]
    assert sorted(meta) == sorted(records)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_tree_equal_the_reference(shape_name):
    for arch in ARCH_IDS:
        for mode in ("tp", "fsdp"):
            jmesh = jax_abstract_mesh(*MESHES["1pod"])
            want = jax_sharding.input_specs_tree(
                jax_input_specs(jax_get_config(arch), SHAPES[shape_name]),
                jmesh, mode=mode)
            got = sharding.input_specs_tree(
                input_specs(get_config(arch), SHAPES[shape_name]), MESH,
                mode=mode)
            _same_specs(want, got)


# ------------------------------------------------ mirrors of test_sharding.py
def _axis_size(mesh, entry):
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _check(tree_specs, shapes, mesh):
    specs = list(_flat(tree_specs, sharding.is_spec).values())
    assert len(specs) == len(shapes)
    for spec, shape in zip(specs, shapes):
        assert len(spec) <= len(shape), (spec, shape)
        for dim, entry in zip(shape, spec):
            n = _axis_size(mesh, entry)
            assert dim % n == 0, \
                f"dim {dim} not divisible by {entry} ({n}) in {spec}"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", [MESH, MESH_MP], ids=["1pod", "2pod"])
def test_param_specs_divisible(arch, mode, mesh):
    params_abs, _ = abstract_train_state(get_config(arch), AdamWConfig())
    specs = sharding.param_specs(params_abs, mesh, mode=mode)
    _check(specs, [t.shape for t in _flat(params_abs).values()], mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_divisible(arch):
    cache = serve_mod.cache_spec(get_config(arch), 128, 4096 + 256)
    _check(sharding.cache_specs_tree(cache, MESH),
           [shape for _, (shape, _) in sorted(cache.items())], MESH)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_divisible(shape_name):
    specs_in = input_specs(get_config("llama3-8b"), SHAPES[shape_name])
    tree = sharding.input_specs_tree(specs_in, MESH)
    _check(tree, [t.shape for t in _flat(specs_in).values()], MESH)


def test_kv_head_rule():
    """kv_heads if divisible, else entry dim, else replicate."""
    assert sharding.kv_head_axis_dims(16, 128, MESH) == ("model", None)
    assert sharding.kv_head_axis_dims(8, 128, MESH) == (None, "model")
    assert sharding.kv_head_axis_dims(10, 100, MESH) == (None, None)


def test_fsdp_avoids_contracting_dim_for_experts():
    """Expert weights shard E→model and the OUTPUT dim→data, never the
    contracting d_model dim."""
    params_abs, _ = abstract_train_state(get_config("deepseek-v3-671b"),
                                         AdamWConfig())
    specs = sharding.param_specs(params_abs, MESH, mode="fsdp")
    assert specs["layers"]["moe"]["we_gate"] == (None, "model", None, "data")
    assert specs["layers"]["moe"]["we_down"] == (None, "model", None, "data")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements((None, "model"), MESH) == (Replicate(),
                                                          Shard(1))
    assert sharding.placements((("data", "model"),), MESH) == (Shard(0),
                                                              Shard(0))
    assert sharding.placements((("pod", "data"), None, "model"), MESH_MP) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((), MESH_MP) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("model", "data"),), MESH)
    with pytest.raises(ValueError, match="names axis 'pod'"):
        sharding.placements(("pod",), MESH)


# ---------------------------------------------------------------------------
# Engine sharding: per-shard fault schedules (ShardedTideDB.shard_ios), the
# mirror of tests/test_sharding.py::TestPerShardFaultSchedules.
# ---------------------------------------------------------------------------
class TestPerShardFaultSchedules:
    @staticmethod
    def _cfg():
        from repro_torch.core.tidestore import DbConfig, KeyspaceConfig
        from repro_torch.core.tidestore.wal import WalConfig
        return DbConfig(
            keyspaces=[KeyspaceConfig("default", n_cells=16,
                                      dirty_flush_threshold=64)],
            wal=WalConfig(segment_size=16 * 1024, background=False),
            index_wal=WalConfig(segment_size=1024 * 1024, background=False),
            background_snapshots=False,
            system_stats=False,
            device="cpu",
        )

    @staticmethod
    def _full_disk():
        from repro_torch.core.tidestore import FaultRule
        return [FaultRule(op=op, kind="enospc", after=0, count=None)
                for op in ("pwrite", "pwritev", "fsync", "ftruncate")]

    def test_shard_ios_must_align_with_shards(self, tmp_path):
        from repro_torch.core.tidestore import FaultyIo, ShardedTideDB
        with pytest.raises(ValueError, match="shard_ios"):
            ShardedTideDB(str(tmp_path), self._cfg(), n_shards=3,
                          shard_ios=[FaultyIo([]), None])

    def test_one_shard_degrades_siblings_keep_serving(self, tmp_path):
        """Mid-workload ENOSPC on shard 0 only: exactly that shard
        degrades, scalar writes routed to siblings keep landing, and a
        cross-shard multi_get returns every surviving key."""
        from repro_torch.core.tidestore import (DegradedError, FaultyIo,
                                                ShardedTideDB)
        io0 = FaultyIo([])
        sdb = ShardedTideDB(str(tmp_path), self._cfg(), n_shards=3,
                            shard_ios=[io0, None, None])
        try:
            keys = [hashlib.sha256(b"shard-fault-%d" % i).digest()
                    for i in range(48)]
            survivors = {}
            for k in keys[:16]:
                sdb.put(k, b"pre-" + k[:4])
                survivors[k] = b"pre-" + k[:4]
            io0.rules = self._full_disk()
            for k in keys[16:]:
                try:
                    sdb.put(k, b"mid-" + k[:4])
                    survivors[k] = b"mid-" + k[:4]
                except (OSError, DegradedError):
                    assert sdb.shard_of(k) == 0     # only shard 0 may fail
            st = sdb.stats()
            assert st["degraded_shards"] == 1
            assert sdb.shards[0].degraded
            assert all(not sh.degraded for sh in sdb.shards[1:])
            assert sdb.health == "degraded"
            assert sdb.degraded_reason.startswith("shard 0:")
            routed_healthy = [k for k in keys[16:] if sdb.shard_of(k) != 0]
            assert routed_healthy, "want traffic on healthy shards"
            assert all(k in survivors for k in routed_healthy)
            got = sdb.multi_get(keys)
            for k, v in zip(keys, got):
                assert v == survivors.get(k)
        finally:
            sdb.close(flush=False)

    def test_healed_shard_rejoins_via_try_recover(self, tmp_path):
        from repro_torch.core.tidestore import FaultyIo, ShardedTideDB
        io0 = FaultyIo([])
        sdb = ShardedTideDB(str(tmp_path), self._cfg(), n_shards=2,
                            shard_ios=[io0, None])
        try:
            keys = [hashlib.sha256(b"rejoin-%d" % i).digest()
                    for i in range(32)]
            on0 = [k for k in keys if sdb.shard_of(k) == 0]
            io0.rules = self._full_disk()
            with pytest.raises(OSError):
                for k in on0:
                    sdb.shards[0].put(k, b"x" * 200)
            assert sdb.stats()["degraded_shards"] == 1
            assert sdb.try_recover(min_retry_interval_s=0.0) is False
            io0.rules = []                          # space freed
            assert sdb.try_recover(min_retry_interval_s=0.0) is True
            assert sdb.stats()["degraded_shards"] == 0
            sdb.put(on0[0], b"post-heal")           # write surface reopened
            assert sdb.get(on0[0]) == b"post-heal"
        finally:
            sdb.close(flush=False)
