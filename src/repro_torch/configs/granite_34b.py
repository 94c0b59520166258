"""granite-34b [arXiv:2405.04324; hf] — llama-arch code model.

88L  d_model=6144  48H (GQA kv=1 => MQA)  d_ff=24576  vocab=49152.
Pure full attention (no sub-quadratic layer).
"""

from ..models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",
        gated_mlp=False,       # granite code models use GPT-style MLP
        rope_theta=10000.0,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="granite-smoke",
        family="dense",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        act="gelu",
        gated_mlp=False,
    )
