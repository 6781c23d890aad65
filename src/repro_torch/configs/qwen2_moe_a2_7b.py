"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, expert_d_ff=1408,
                  shared_d_ff=1408, capacity_factor=1.25, group_size=512),
    act="silu",
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256, head_dim=16,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=2, expert_d_ff=32,
                  shared_d_ff=32, group_size=32),
    act="silu", dtype="float32", remat=False,
)
