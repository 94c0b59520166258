"""musicgen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48L  d_model=2048  32H (GQA kv=32 => MHA)  d_ff=8192  vocab=2048.

[audio]: the assignment specifies the transformer BACKBONE only; the EnCodec
modality frontend is a STUB — the caller provides precomputed frame
embeddings ([B, S, d_model]), so the config runs in input_mode="embeds"
(``launch.train`` refuses it: its synthetic batches are tokens only).
The 2048-entry codebook head stays (it is the backbone's output layer).
"""

from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="musicgen-large",
    family="audio",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2306.05284; hf",
    notes="EnCodec frontend stubbed: inputs are precomputed frame embeddings.",
)


def full() -> LMConfig:
    return LMConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        act="gelu",
        gated_mlp=False,
        rope_type="none",     # musicgen uses learned/sinusoidal positions;
                              # the stub provides position-aware embeddings
        input_mode="embeds",
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        act="gelu",
        gated_mlp=False,
        rope_type="none",
        input_mode="embeds",
    )
