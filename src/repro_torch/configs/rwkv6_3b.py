"""rwkv6-3b "Finch" [arXiv:2404.05892; hf] — attention-free, data-dependent
decay.

32L  d_model=2560  (attn-free)  d_ff=8960  vocab=65536.
head_dim=64 (RWKV convention) => 40 heads. SA-Solver samples it as a
denoiser backbone (``RWKV6.denoise``, latent width set by the caller).
"""

from . import ArchMeta
from ..models.rwkv6 import RWKV6Config


META = ArchMeta(
    name="rwkv6-3b",
    family="ssm",
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2404.05892; hf",
    notes="long_500k runs: O(1) recurrent state, no KV cache.",
)


def full() -> RWKV6Config:
    return RWKV6Config(
        name="rwkv6-3b",
        n_layers=32,
        d_model=2560,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        decay_lora=64,
        tshift_lora=32,
        chunk_size=64,
        remat="full",
    )


def smoke() -> RWKV6Config:
    return RWKV6Config(
        name="rwkv6-smoke",
        n_layers=2,
        d_model=128,
        head_dim=32,
        d_ff=448,
        vocab_size=512,
        decay_lora=16,
        tshift_lora=8,
        chunk_size=64,
    )
