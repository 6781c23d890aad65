"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.base import ModelConfig

FULL = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128, rope_theta=500_000.0,
    act="silu",
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, rope_theta=500_000.0,
    act="silu", dtype="float32", remat=False,
)
