"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.models.base import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, head_dim=128,
    act="silu",
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
    d_ff=160, vocab=256, head_dim=16,
    act="silu", dtype="float32", remat=False,
)
