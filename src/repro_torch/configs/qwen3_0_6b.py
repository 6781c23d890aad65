"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B]."""
from repro_torch.models.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, head_dim=128, rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=True, act="silu",
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, qk_norm=True, tie_embeddings=True,
    act="silu", dtype="float32", remat=False,
)
