"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].
Attention-free; fixed-size recurrent state → runs the long_500k cell.
The Tidehunter KV-WAL is inapplicable to SSM layer state (fixed-size
recurrent tensor, not per-token values) — see the
JAX package's DESIGN notes; the engine still serves checkpoint/data storage."""
from repro_torch.models.base import ModelConfig, SsmConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm=SsmConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=256,
    ssm=SsmConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=8),
    tie_embeddings=True, dtype="float32", remat=False,
)
