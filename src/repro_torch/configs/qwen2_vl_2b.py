"""qwen2-vl-2b [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution.

28L  d_model=1536  12H (GQA kv=2)  d_ff=8960  vocab=151936.

The language backbone only, as in the reference: the ViT patch frontend
is a stub, so the model takes precomputed patch and text embeddings
(``input_mode="embeds"``) and the three (t, h, w) M-RoPE position
streams (``batch["positions"]`` [3, B, S]).
"""

from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="qwen2-vl-2b",
    family="vlm",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2409.12191; hf",
    notes="ViT frontend stubbed: precomputed patch embeddings + M-RoPE ids.",
)


def full() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        act="silu",
        gated_mlp=True,
        rope_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1000000.0,
        input_mode="embeds",
        tie_embeddings=True,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        act="silu",
        gated_mlp=True,
        rope_type="mrope",
        mrope_sections=(2, 3, 3),
        input_mode="embeds",
        tie_embeddings=True,
    )
