"""DiT-S — small (~33M) denoiser (the DiT-S variant of arXiv:2212.09748)."""

from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="dit-s",
    family="denoiser",
    shapes=("sample_64",),
    source="arXiv:2212.09748 (DiT-S variant)",
)


def full() -> LMConfig:
    return LMConfig(
        name="dit-s",
        n_layers=12,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=8,
        act="gelu",
        gated_mlp=False,
        rope_type="none",
        denoiser_latent=16,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="dit-s-smoke",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=8,
        act="gelu",
        gated_mlp=False,
        rope_type="none",
        denoiser_latent=8,
    )
