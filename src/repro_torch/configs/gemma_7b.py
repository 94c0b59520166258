"""gemma-7b [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MHA (kv=16).

28L  d_model=3072  16H (GQA kv=16)  d_ff=24576  vocab=256000.
Tied embeddings + sqrt(d) embedding scale (Gemma convention). The huge
vocab makes the embedding/logits layer the TP-sharding stress test.
"""

from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="gemma-7b",
    family="dense",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2403.08295; hf",
    notes="256k vocab-parallel embedding; GeGLU; head_dim 256 > d/H.",
)


def full() -> LMConfig:
    return LMConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        act="gelu",
        gated_mlp=True,        # GeGLU
        tie_embeddings=True,
        embed_scale=True,
        rope_theta=10000.0,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="gemma-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        act="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        embed_scale=True,
    )
