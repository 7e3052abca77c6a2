"""Architecture registry (``repro.configs``): ``get_config(arch, smoke=)``.

The same ten architectures as the reference, field for field.  The port
serves llama3.2-3b, gemma3-1b (its 5:1 sliding windows, geglu and one KV
head of width 256), qwen2-vl-7b (M-RoPE, its decode feeding one position
to all three streams), mamba2-130m (the SSM family's recurrent state) and
the two MoE configs (qwen3-moe-30b-a3b and llama4-scout-17b-a16e: routed
experts in place of the MLP), each held against the reference; the rest
are data.
"""
from __future__ import annotations

from repro_torch.models.transformer import ModelConfig

_FULL = {
    # [hf:meta-llama/Llama-4-Scout-17B-16E]
    "llama4-scout-17b-a16e": dict(
        n_layers=48, d_model=5120, n_heads=40, kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202_048, mlp_kind="swiglu", rope_theta=500_000.0,
        n_experts=16, top_k=1, expert_d_ff=8192,
    ),
    "qwen3-moe-30b-a3b": dict(
        n_layers=48, d_model=2048, n_heads=32, kv_heads=4, head_dim=64,
        d_ff=768, vocab=151_936, mlp_kind="swiglu", rope_theta=1_000_000.0,
        n_experts=128, top_k=8, expert_d_ff=768,
    ),
    "yi-6b": dict(
        n_layers=32, d_model=4096, n_heads=32, kv_heads=4, head_dim=128,
        d_ff=11008, vocab=64_000, mlp_kind="swiglu", rope_theta=5_000_000.0,
    ),
    "gemma3-1b": dict(
        n_layers=26, d_model=1152, n_heads=4, kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262_144, mlp_kind="geglu", rope_theta=1_000_000.0,
        window_pattern=(1024, 1024, 1024, 1024, 1024, 0), cache_shard="seq_mp",
    ),
    "nemotron-4-340b": dict(
        n_layers=96, d_model=18432, n_heads=96, kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256_000, mlp_kind="squared_relu", rope_theta=10_000.0,
    ),
    # [hf:meta-llama/Llama-3.2-3B]
    "llama3.2-3b": dict(
        n_layers=28, d_model=3072, n_heads=24, kv_heads=8, head_dim=128,
        d_ff=8192, vocab=128_256, mlp_kind="swiglu", rope_theta=500_000.0,
    ),
    "zamba2-1.2b": dict(
        n_layers=38, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32_000, mlp_kind="swiglu",
        family="hybrid", ssm_state=64, ssm_head_dim=64, hybrid_attn_every=6,
    ),
    "whisper-tiny": dict(
        n_layers=4, d_model=384, n_heads=6, kv_heads=6, head_dim=64,
        d_ff=1536, vocab=51_968, mlp_kind="gelu", family="encdec", enc_layers=4,
    ),
    "qwen2-vl-7b": dict(
        n_layers=28, d_model=3584, n_heads=28, kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152_064, mlp_kind="swiglu", rope_theta=1_000_000.0,
        use_mrope=True,
    ),
    "mamba2-130m": dict(
        n_layers=24, d_model=768, n_heads=1, kv_heads=1,
        d_ff=0, vocab=50_432, family="ssm", ssm_state=128, ssm_head_dim=64,
    ),
}

_SMOKE = {
    "llama4-scout-17b-a16e": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, mlp_kind="swiglu",
        n_experts=4, top_k=1, expert_d_ff=128, capacity_factor=4.0, q_chunk=64,
    ),
    "qwen3-moe-30b-a3b": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=96, vocab=512, mlp_kind="swiglu",
        n_experts=8, top_k=2, expert_d_ff=96, capacity_factor=4.0, q_chunk=64,
    ),
    "yi-6b": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=160, vocab=512, mlp_kind="swiglu", q_chunk=64,
    ),
    "gemma3-1b": dict(
        n_layers=3, d_model=64, n_heads=2, kv_heads=1, head_dim=32,
        d_ff=128, vocab=512, mlp_kind="geglu",
        window_pattern=(8, 8, 0), q_chunk=64, cache_shard="seq_mp",
    ),
    "nemotron-4-340b": dict(
        n_layers=2, d_model=96, n_heads=6, kv_heads=2, head_dim=16,
        d_ff=256, vocab=512, mlp_kind="squared_relu", q_chunk=64,
    ),
    "llama3.2-3b": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, mlp_kind="swiglu", q_chunk=64,
    ),
    "zamba2-1.2b": dict(
        n_layers=5, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, mlp_kind="swiglu",
        family="hybrid", ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        hybrid_attn_every=2, q_chunk=64,
    ),
    "whisper-tiny": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, mlp_kind="gelu", family="encdec", enc_layers=2, q_chunk=64,
    ),
    "qwen2-vl-7b": dict(
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, mlp_kind="swiglu", use_mrope=True, q_chunk=64,
    ),
    "mamba2-130m": dict(
        n_layers=2, d_model=64, n_heads=1, kv_heads=1,
        d_ff=0, vocab=512, family="ssm", ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    ),
}

ARCHS = tuple(_FULL)


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    fields = (_SMOKE if smoke else _FULL)[arch]
    return ModelConfig(name=f"{arch}-smoke" if smoke else arch, **fields)
