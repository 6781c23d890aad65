"""int8 error-feedback gradient compression against the JAX package's:
``quantize_int8`` bit for bit (int8 values and fp32 scale, ties at .5
rounding half to even), the mirrors of
``tests/test_training.py::TestCompression``, and the compressor through
``make_train_step``'s ``compress_grads`` hook.  ``compressed_psum`` over 4
ranks is in ``tests/test_torch_distributed.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import compression as jax_compression
from repro_torch.distributed.compression import (compressed_psum,
                                                 dequantize_int8,
                                                 make_error_feedback_compressor,
                                                 quantize_int8)


def _inputs(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    # Ties: with max |x| = 127 the scale is 1 + 1e-12 = 1.0 in fp32, so
    # every k + 0.5 lands on .5 exactly and must round half to even.
    ties = np.concatenate([np.arange(-126, 127) + 0.5, [127.0, -127.0],
                           [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]]
                          ).astype(np.float32)
    small = (rng.standard_normal(64) * 1e-7).astype(np.float32)
    return [x, ties, small, np.zeros(16, np.float32),
            x.reshape(64, 64)]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_bit_equal_to_jax(seed, case):
    x = _inputs(seed)[case]
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_compression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s).tobytes() == np.asarray(js, np.float32).tobytes()
    deq = dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jax_compression.dequantize_int8(jq, js)))


def test_ties_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, s = quantize_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [0, 2, 2, 0, -2, 127]


def test_compressor_equals_jax_over_steps():
    """Ten steps of error feedback on the same gradients: the compressed
    gradients and residuals equal the JAX package's bit for bit."""
    rng = np.random.default_rng(3)
    grads = [{"w": (rng.standard_normal((8, 16)) * 1e-2).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
             for _ in range(10)]
    compress, init = make_error_feedback_compressor()
    jcompress, jinit = jax_compression.make_error_feedback_compressor()
    r = init({"w": torch.zeros(8, 16), "b": [torch.zeros(5)]})
    jr = jinit({"w": jnp.zeros((8, 16)), "b": [jnp.zeros(5)]})
    for g in grads:
        out, r = compress({"w": torch.from_numpy(g["w"]),
                           "b": [torch.from_numpy(g["b"][0])]}, r)
        jout, jr = jcompress({"w": jnp.asarray(g["w"]),
                              "b": [jnp.asarray(g["b"][0])]}, jr)
        for got, want in ((out["w"], jout["w"]), (out["b"][0], jout["b"][0]),
                          (r["w"], jr["w"]), (r["b"][0], jr["b"][0])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestCompression:
    def test_quantize_roundtrip_bounded_error(self):
        x = torch.randn(1024, generator=torch.Generator().manual_seed(0)) * 3
        q, s = quantize_int8(x)
        err = (dequantize_int8(q, s) - x).abs().max()
        assert float(err) <= float(s) * 0.51

    def test_error_feedback_unbiased_over_steps(self):
        compress, init = make_error_feedback_compressor()
        g = {"w": torch.full((256,), 0.003, dtype=torch.float32)}
        r = init(g)
        total = torch.zeros(256)
        for _ in range(50):
            cg, r = compress(g, r)
            total = total + cg["w"]
        # accumulated compressed gradient ≈ accumulated true gradient
        np.testing.assert_allclose(total.numpy(), np.full(256, 0.15),
                                   rtol=0.05)

    def test_compressed_psum_single_device(self):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            g = {"w": torch.randn(64, generator=torch.Generator()
                                  .manual_seed(1))}
            out = compressed_psum(g)
            np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(),
                                       atol=0.05)
        finally:
            dist.destroy_process_group()


def test_compressor_through_the_train_step_hook():
    """The compressor as ``make_train_step``'s ``compress_grads`` hook: the
    step's update is AdamW of the compressed gradients."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                adamw_update)
    from repro_torch.training.step import make_train_step
    cfg = get_config("qwen3-0.6b", smoke=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch_fn(cfg, 2, 16, "cpu")(0)
    compress, init = make_error_feedback_compressor()
    seen = {}

    def hook(grads):
        seen["raw"] = grads
        seen["out"], seen["res"] = compress(grads, init(grads))
        return seen["out"]

    new, _, _ = make_train_step(cfg, opt, compress_grads=hook)(
        params, adamw_init(params, opt), batch)
    want = adamw_update(params, seen["out"], adamw_init(params, opt), opt)[0]
    for a, b in zip(leaves(new), leaves(want)):
        assert torch.equal(a, b)
    for g, c, r in zip(leaves(seen["raw"]), leaves(seen["out"]),
                       leaves(seen["res"])):
        assert torch.equal(g.float() - c.float(), r)
