"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 + shared attn blocks.

81L  d_model=3584  32H (GQA kv=32)  d_ff=14336  vocab=32000  ssm_state=64.

81 Mamba2 blocks (d_inner = 2*d = 7168, P=64 => 112 SSM heads, 2 B/C
groups, N=64) and ONE shared transformer block (32 heads over
concat(h, emb) = 2*d wide, so head dim 224; MLP d_ff=14336) applied after
every 6 blocks with shared parameters: 13 applications, then 3 Mamba
blocks. KV exists only at the 13 shared applications.
"""

from ..models.mamba2 import Mamba2Config, Zamba2Config


def full() -> Zamba2Config:
    return Zamba2Config(
        name="zamba2-7b",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        mamba=Mamba2Config(
            d_inner=7168,
            head_dim=64,
            n_groups=2,
            d_state=64,
            conv_width=4,
            chunk_size=64,
        ),
        shared_period=6,
        remat="full",
    )


def smoke() -> Zamba2Config:
    return Zamba2Config(
        name="zamba2-smoke",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mamba=Mamba2Config(d_inner=256, head_dim=32, n_groups=2,
                           d_state=16, chunk_size=16),
        shared_period=2,
    )
