"""dbrx-132b [hf:databricks/dbrx-base; unverified] — fine-grained MoE,
16 experts top-4.

40L  d_model=6144  48H (GQA kv=8)  expert d_ff=10752  vocab=100352.
All layers MoE (no dense prefix).
"""

from ..models.moe import MoEConfig
from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="dbrx-132b",
    family="moe",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="hf:databricks/dbrx-base; unverified",
)


def full() -> LMConfig:
    return LMConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        act="silu",
        gated_mlp=True,
        rope_theta=500000.0,
        moe=MoEConfig(
            n_experts=16,
            top_k=4,
            n_shared=0,
            d_expert_ff=10752,
            capacity_factor=1.25,
            act="silu",
            gated=True,
        ),
        n_dense_layers=0,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="dbrx-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        act="silu",
        gated_mlp=True,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert_ff=128),
        n_dense_layers=0,
    )
