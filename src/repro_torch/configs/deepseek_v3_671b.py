"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

Deviations from the released model (recorded): all 61 layers are MoE (the
real model's first 3 layers are dense); router uses softmax scoring rather
than the paper's aux-loss-free sigmoid+bias scheme.  The MLA KV cache holds
one (512+64)-dim latent per token — the ideal Tidehunter large-value entry.
"""
from repro_torch.models.base import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_d_ff=2048,
                  shared_d_ff=2048, capacity_factor=1.25, group_size=512),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    mtp_depth=1, act="silu",
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, expert_d_ff=32,
                  shared_d_ff=32, group_size=32),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    mtp_depth=1, act="silu", dtype="float32", remat=False,
)
