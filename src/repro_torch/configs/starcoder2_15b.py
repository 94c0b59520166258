"""starcoder2-15b [arXiv:2402.19173; hf] — GQA, RoPE.

40L  d_model=6144  48H (GQA kv=4)  d_ff=24576  vocab=49152.
"""

from ..models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",
        gated_mlp=False,
        rope_theta=100000.0,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=3,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=512,
        vocab_size=512,
        act="gelu",
        gated_mlp=False,
        rope_theta=100000.0,
    )
