"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427].  38 layers = 12 full groups + 2 tail
recurrent blocks.  Sub-quadratic → runs the long_500k cell."""
from repro_torch.models.base import GriffinConfig, ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="griffin",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    griffin=GriffinConfig(lru_width=4096, window=2048,
                          pattern=("rec", "rec", "attn"), conv_width=4),
    act="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="griffin",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    griffin=GriffinConfig(lru_width=64, window=16,
                          pattern=("rec", "rec", "attn"), conv_width=4),
    act="geglu", tie_embeddings=True, dtype="float32", remat=False,
    kv_block=8,
)
