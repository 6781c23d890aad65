"""Shape records without allocation against the JAX package's: the exact
parameter count of every full config (``param_count_exact``), the train
state's leaves (``abstract_train_state``), the dry run's inputs
(``input_specs``) and the KV-WAL's cache stand-ins (``kvwal.cache_specs``),
with the mirrors of ``tests/test_models.py::test_param_count_analytic`` and
``TestFullConfigShapes``; building DeepSeek-V3's state allocates nothing."""
import jax
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.core import kvwal as jax_kvwal
from repro.models import transformer as JT
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.step import abstract_train_state as jax_abstract_state
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.core import kvwal
from repro_torch.core.tree import leaves, leaves_with_path, path_str
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.step import abstract_train_state


def _jax_records(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): (tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in flat}


def _records(tree) -> dict:
    out = {}
    for p, t in leaves_with_path(tree):
        assert t.is_meta, path_str(p)
        out[path_str(p)] = (tuple(t.shape), str(t.dtype).removeprefix(
            "torch."))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_exact_equals_the_reference(arch):
    assert T.param_count_exact(get_config(arch)) == \
        JT.param_count_exact(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_analytic(arch):
    """The exact (fake-tensor) count equals the parameters init_params
    allocates."""
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in leaves(params)) == T.param_count_exact(cfg)


class TestFullConfigShapes:
    """FULL configs are exercised abstractly only (no allocation)."""

    @pytest.mark.parametrize("arch,expect_b", [
        ("llama3-8b", 8.0e9), ("qwen3-0.6b", 0.6e9),
        ("phi3-medium-14b", 14e9), ("phi3-mini-3.8b", 3.8e9),
        ("qwen2-vl-72b", 72e9), ("mamba2-1.3b", 1.3e9),
        ("qwen2-moe-a2.7b", 14.3e9), ("deepseek-v3-671b", 671e9),
        ("recurrentgemma-9b", 9e9), ("whisper-large-v3", 1.55e9),
    ])
    def test_full_param_counts(self, arch, expect_b):
        n = T.param_count_exact(get_config(arch))
        assert 0.75 * expect_b < n < 1.35 * expect_b, \
            f"{arch}: {n/1e9:.2f}B vs expected {expect_b/1e9:.2f}B"


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_equals_the_reference(arch, moments):
    jp, jo = jax_abstract_state(jax_get_config(arch),
                                JaxAdamWConfig(moment_dtype=moments))
    tp, to = abstract_train_state(get_config(arch),
                                  AdamWConfig(moment_dtype=moments))
    assert _records(tp) == _jax_records(jp)
    assert _records(to) == _jax_records(jo)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape_name):
    for scale in (1.0, 1 / 64):
        want = _jax_records(jax_input_specs(jax_get_config(arch),
                                            SHAPES[shape_name], scale))
        assert _records(input_specs(get_config(arch), SHAPES[shape_name],
                                    scale)) == want


def test_kvwal_cache_specs_equal_the_reference():
    for dtype in ("float32", "bfloat16"):
        kw = dict(n_layers=3, batch=5, max_seq=100, kv_heads=2,
                  entry_dim=24, block_size=16, dtype=dtype)
        want = _jax_records(jax_kvwal.cache_specs(jax_kvwal.KVWalSpec(**kw)))
        got = kvwal.cache_specs(kvwal.KVWalSpec(**kw))
        assert _records(got) == want
        real = kvwal.init_cache(kvwal.KVWalSpec(**kw), device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in real.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_shape_records_allocate_nothing():
    """DeepSeek-V3's full train state (704 B parameters, 8.4 TB with fp32
    moments) and its decode inputs are built as shape records: the process
    grows by less than 200 MB."""
    cfg = get_config("deepseek-v3-671b")
    abstract_train_state(get_config("qwen3-0.6b"), AdamWConfig())  # warm up
    before = _rss_bytes()
    params, opt = abstract_train_state(cfg, AdamWConfig())
    specs = input_specs(cfg, SHAPES["decode_32k"])
    n = T.param_count_exact(cfg)
    grown = _rss_bytes() - before
    assert n == sum(t.numel() for t in leaves(params)) == 704_131_741_696
    assert sum(t.numel() for t in leaves(opt["m"])) == n
    assert all(t.is_meta for t in leaves([params, opt, specs]))
    assert grown < 200e6, grown
