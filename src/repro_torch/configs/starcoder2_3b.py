"""starcoder2-3b [arXiv:2402.19173; hf] — GQA, RoPE.

30L  d_model=3072  24H (GQA kv=2)  d_ff=12288  vocab=49152.
"""

from ..models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        act="gelu",
        gated_mlp=False,
        rope_theta=999999.0,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=384,
        vocab_size=512,
        act="gelu",
        gated_mlp=False,
    )
