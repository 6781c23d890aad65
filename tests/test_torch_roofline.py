"""The port's roofline against the JAX package's: ``op_cost`` FLOPs equal
``jaxpr_cost``'s for the SMOKE train, prefill and decode steps of every
architecture (remat on and off), its bytes within a stated ratio of
``jaxpr_cost``'s (a dense decode step's difference computed from shapes),
``model_flops`` for every full config, and ``Roofline``'s keys and formulas
over the H100 constants.

One difference is named and computed from shapes: the SSD's three-operand
einsums (``repro/models/ssm.py``), which ``jnp.einsum`` lowers to
``dot_general``s, some with no contracting dim (elementwise products that
``jaxpr_cost`` counts at 2 FLOPs an output element); the port computes
those products elementwise.  With remat, ``torch.utils.checkpoint`` replays
a layer's forward up to the last tensor its backward needs, where JAX drops
what the backward does not use: the MoE's combine einsum is replayed."""
import dataclasses

import pytest

from repro.configs.registry import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_specs as jax_input_specs
from repro.roofline import analysis as jax_analysis
from repro.roofline import hw as jax_hw
from repro.roofline.jaxpr_cost import jaxpr_cost
from repro.training import step as jax_step
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro_torch.configs.registry import ARCH_IDS, ShapeSpec, get_config, input_specs
from repro_torch.models.ssm import ssm_dims
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.op_cost import Cost, op_cost
from repro_torch.training import step as step_mod
from repro_torch.training.optimizer import AdamWConfig

B, S = 2, 64


def _costs(arch: str, kind: str, remat=None):
    """(jaxpr_cost, op_cost) of the SMOKE step of ``kind`` at B x S."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if remat is not None:
        jcfg = dataclasses.replace(jcfg, remat=remat)
        cfg = dataclasses.replace(cfg, remat=remat)
    jp, jo = jax_step.abstract_train_state(jcfg, JaxAdamWConfig())
    tp, to = step_mod.abstract_train_state(cfg, AdamWConfig())
    ji = jax_input_specs(jcfg, JaxShapeSpec("smoke", S, B, kind))
    ti = input_specs(cfg, ShapeSpec("smoke", S, B, kind))
    if kind == "train":
        return (jaxpr_cost(jax_step.make_train_step(jcfg, JaxAdamWConfig()),
                           jp, jo, ji),
                op_cost(step_mod.make_train_step(cfg, AdamWConfig()),
                        tp, to, ti))
    if kind == "prefill":
        return (jaxpr_cost(jax_step.make_prefill_step(jcfg, S + 256), jp, ji),
                op_cost(step_mod.make_prefill_step(cfg, S + 256), tp, ti))
    extra = ["mrope_positions"] if "mrope_positions" in ti else []
    return (jaxpr_cost(jax_step.make_decode_step(jcfg), jp, ji["cache"],
                       ji["tokens"], *[ji[k] for k in extra]),
            op_cost(step_mod.make_decode_step(cfg), tp, ti["cache"],
                    ti["tokens"], *[ti[k] for k in extra]))


def _ssd_elementwise_flops(arch: str, kind: str) -> float:
    """The FLOPs ``jaxpr_cost`` counts for the elementwise products of the
    SSD's three-operand einsums, which the port does not: a decode step's
    "bn,bhp,bh->bhpn" (2·B·h·p·n + 2·B·h·n a layer); a forward's
    "bzij,bzhij,bzjhp->bzihp", "bzcn,bzchp,bzch->bzhpn" and
    "bzcn,bzhpn,bzch->bzchp" (2·B·l·h·c + 2·2·B·l·h·p a layer, l the padded
    length); a train step's backward counts each product twice more."""
    cfg = get_config(arch, smoke=True)
    if cfg.family != "ssm":
        return 0.0
    _, h, _ = ssm_dims(cfg)
    p, n, L = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.n_layers
    if kind == "decode":
        return L * (2 * B * h * p * n + 2 * B * h * n)
    c = min(cfg.ssm.chunk_size, S)
    l = -(-S // c) * c
    fwd = L * (2 * B * l * h * c + 2 * 2 * B * l * h * p)
    return fwd if kind == "prefill" else 3 * fwd


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_op_cost_flops_equal_jaxpr_cost(arch, kind):
    want, got = _costs(arch, kind)
    assert got.flops > 0 and got.bytes > 0
    assert got.flops == want.flops - _ssd_elementwise_flops(arch, kind)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "whisper-large-v3"])
def test_op_cost_train_flops_with_remat(arch):
    """Remat re-runs each layer's forward in the backward in both packages;
    the port also replays the MoE's combine einsum "gsec,gecd->gsd"
    (2·G·g·E·C·d a layer), whose output the backward does not need."""
    want, got = _costs(arch, "train", remat=True)
    plain = _costs(arch, "train", remat=False)[1]
    assert got.flops > plain.flops                # the replayed forward
    extra = 0.0
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        from repro_torch.models.moe import moe_capacity
        m = cfg.moe
        g = min(m.group_size, B * S)
        extra = cfg.n_layers * 2 * (B * S // g) * g * m.n_experts \
            * moe_capacity(m) * cfg.d_model
    assert got.flops == want.flops + extra


# op_cost's bytes against jaxpr_cost's, a SMOKE step at B x S: the two
# count the same kinds of op, but the programs decompose differently.  The
# reference writes the KV-WAL with scatters and dynamic-update-slices,
# counted as the whole arena read and written; the port writes in place
# (``index_put_``, a ``copy_`` into a slice), which op_cost does not count.
# The reference pads where the port concatenates, and their reductions,
# the stacked gradients of the unbound layers and the embedding's backward
# differ in what they materialize.  Observed on every SMOKE step: 0.655 to
# 1.083 of the reference's bytes, train steps 0.856 to 1.040.
BYTES_RATIO = {"train": (0.85, 1.05), "prefill": (0.6, 1.1),
               "decode": (0.6, 1.1)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_op_cost_bytes_near_jaxpr_cost(arch, kind):
    want, got = _costs(arch, kind)
    lo, hi = BYTES_RATIO[kind]
    assert lo <= got.bytes / want.bytes <= hi


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3-8b", "qwen2-vl-72b",
                                  "phi3-mini-3.8b", "phi3-medium-14b"])
def test_decode_bytes_differ_by_the_kvwal_scatter(arch):
    """A dense decode step's bytes differ by the reference's KV-WAL append
    alone: a scatter a layer into each of the K and V arenas, counted as the
    layer's arena read and written, the (B, KH, d) entries and the (B, 3)
    int32 indices.  What is left (gathers and reductions of other shapes)
    is under 0.1% of the step."""
    want, got = _costs(arch, "decode")
    cfg = get_config(arch, smoke=True)
    arena = input_specs(cfg, ShapeSpec("smoke", S, B, "decode"))["cache"][
        "arena_k"]                               # (L, B, NB, blk, KH, d)
    layer = arena[0].numel() * arena.element_size()
    entry = B * arena.shape[-2] * arena.shape[-1] * arena.element_size()
    scatter = 2 * cfg.n_layers * (2 * layer + entry + B * 3 * 4)
    assert abs(got.bytes + scatter - want.bytes) <= 1e-3 * want.bytes


def test_op_cost_counts_products_and_io():
    import torch

    def f(a, b, x):
        return torch.einsum("bij,bjk->bik", a, b), x.sum(0), torch.tanh(x)
    a = torch.empty(3, 4, 5, device="meta")
    b = torch.empty(3, 5, 6, device="meta")
    x = torch.empty(7, 8, dtype=torch.bfloat16, device="meta")
    c = op_cost(f, a, b, x)
    assert c.flops == 2 * 3 * 4 * 5 * 6
    io = (60 + 90) * 4 + 56 * 2 + 72 * 4 + 8 * 2 + 56 * 2
    products = (60 + 90 + 72) * 4            # bmm's inputs and output
    reduction = 56 * 2 + 8 * 2               # sum's input and output
    assert c.bytes == io + products + reduction
    assert (Cost(1, 2).scaled(3).flops, Cost(1, 2).scaled(3).bytes) == (3, 6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    for kind, n in (("train", 4096 * 256), ("prefill", 32768 * 32),
                    ("decode", 128)):
        assert analysis.model_flops(get_config(arch), n, kind) == \
            jax_analysis.model_flops(jax_get_config(arch), n, kind)


def test_roofline_keys_and_formulas():
    kw = dict(arch="llama3-8b", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=3.1e14, bytes_per_device=2.2e11,
              collective_bytes=4.4e10, peak_memory_per_device=5e10,
              model_flops=7.5e16, collectives={"bytes": {}, "count": {}})
    got = analysis.Roofline(**kw).to_dict()
    assert sorted(got) == sorted(jax_analysis.Roofline(**kw).to_dict())
    assert got["t_compute"] == 3.1e14 / 989e12
    assert got["t_memory"] == 2.2e11 / 3.35e12
    assert got["t_collective"] == 4.4e10 / 50e9
    t = max(got["t_compute"], got["t_memory"], got["t_collective"])
    assert got["bottleneck"] == "collective" and t == got["t_collective"]
    assert got["model_flops_ratio"] == 7.5e16 / (3.1e14 * 256)
    assert got["roofline_fraction"] == (7.5e16 / 256 / t) / 989e12
    # the same formulas as the reference's, over the H100's constants
    ref = jax_analysis.Roofline(**kw)
    assert ref.t_compute * jax_hw.PEAK_FLOPS_BF16 == \
        got["t_compute"] * hw.PEAK_FLOPS_BF16
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_FP32, hw.HBM_BW,
            hw.HBM_PER_CHIP, hw.GPUS_PER_NODE, hw.NVLINK_BW, hw.IB_BW,
            hw.LINK_BW) == (989e12, 67e12, 3.35e12, 80e9, 8, 450e9, 50e9,
                            50e9)
    zero = analysis.Roofline(**{**kw, "flops_per_device": 0,
                                "bytes_per_device": 0,
                                "collective_bytes": 0}).to_dict()
    assert zero["roofline_fraction"] == 0.0


def test_collective_stats():
    st = analysis.CollectiveStats()
    st.add("all-gather", 100)
    st.add("all-gather", 28)
    st.add("all-reduce", 4)
    assert st.bytes_by_kind == {"all-gather": 128, "all-reduce": 4}
    assert st.count_by_kind == {"all-gather": 2, "all-reduce": 1}
    assert st.total_bytes == 132
