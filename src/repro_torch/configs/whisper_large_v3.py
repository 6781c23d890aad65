"""whisper-large-v3 [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

The conv/mel frontend is a stub: ``input_specs`` (still to port) provides
precomputed frame embeddings (B, 1500, 1280).  Both 32-layer encoder and
32-layer decoder (with cross-attention) are implemented.  Position encoding
is sinusoidal computed on the fly (the released model uses learned decoder
positions — a fixed-table deviation recorded here)."""
from repro_torch.models.base import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    n_encoder_layers=32, encoder_seq=1500, encoder_dim=1280,
    act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    n_encoder_layers=2, encoder_seq=16, encoder_dim=64,
    act="gelu", dtype="float32", remat=False,
)
