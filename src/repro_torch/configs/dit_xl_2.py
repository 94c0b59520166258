"""DiT-XL/2 — the paper's ImageNet-256 denoiser backbone [arXiv:2212.09748].

28L  d_model=1152  16H  d_ff=4608; operates on 32x32x4 VAE latents with
2x2 patches => 256 tokens of dim 16. Built in denoiser mode (bidirectional
attention + adaLN time conditioning): ``TransformerLM.denoise``.
"""

from . import ArchMeta
from ..models.transformer import LMConfig

LATENT_TOKENS = 256      # (32/2)^2
LATENT_DIM = 16          # 2*2*4


META = ArchMeta(
    name="dit-xl-2",
    family="denoiser",
    shapes=("sample_256",),
    source="arXiv:2212.09748 (paper's DiT experiments)",
    notes="SA-Solver drives sampling; NFE = solver steps + 1.",
)


def full() -> LMConfig:
    return LMConfig(
        name="dit-xl-2",
        n_layers=28,
        d_model=1152,
        n_heads=16,
        n_kv_heads=16,
        head_dim=72,
        d_ff=4608,
        vocab_size=8,          # unused in denoiser mode (kept tiny)
        act="gelu",
        gated_mlp=False,
        rope_type="none",
        denoiser_latent=LATENT_DIM,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="dit-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=8,
        act="gelu",
        gated_mlp=False,
        rope_type="none",
        denoiser_latent=8,
    )
