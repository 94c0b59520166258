"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed
top-8 MoE, MTP.

61L  d_model=7168  128H (GQA kv=128)  expert d_ff=2048  vocab=129280.
First 3 layers dense (d_ff 18432, per the paper); remaining 58 MoE.
MLA dims: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128.
The MLA cache holds the compressed c_kv (512) and one rope key (64) a
token, not 128 heads x 128; its decode step attends in the compressed
space (weight-absorbed); the MTP module joins the training loss.
"""

from ..models.attention import MLAConfig
from ..models.moe import MoEConfig
from . import ArchMeta
from ..models.transformer import LMConfig


META = ArchMeta(
    name="deepseek-v3-671b",
    family="moe",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2412.19437; hf",
    notes="MLA compressed-KV cache (c_kv 512 + rope 64 per token, not "
          "128 heads x 128); weight-absorbed decode path; EP over model "
          "axis; MTP head on the training loss.",
)


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,                      # dense layers
        vocab_size=129280,
        act="silu",
        gated_mlp=True,
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            n_shared=1,
            d_expert_ff=2048,
            d_shared_ff=2048,
            capacity_factor=1.25,
            act="silu",
            gated=True,
        ),
        n_dense_layers=3,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_dim=128,
        ),
        mtp=True,
        remat="full",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke",
        family="moe",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=384,
        vocab_size=512,
        act="silu",
        gated_mlp=True,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1,
                      d_expert_ff=64, d_shared_ff=64),
        n_dense_layers=1,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        mtp=True,
    )
