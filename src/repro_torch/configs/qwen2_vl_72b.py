"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a stub: ``input_specs`` (still to port) provides
precomputed patch embeddings that replace the first n_vis token slots; the
transformer backbone (80L, GQA kv=8, M-RoPE with (t,h,w) = (16,24,24)
frequency sections over head_dim/2 = 64) is implemented in full.
"""
from repro_torch.models.base import ModelConfig

N_VISION_PATCHES = 1024      # patch-embedding slots provided by the stub

FULL = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    act="silu",
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, mrope_sections=(2, 3, 3),
    act="silu", dtype="float32", remat=False,
)
