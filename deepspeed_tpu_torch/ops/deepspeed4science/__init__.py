from .evoformer_attn import DS4Sci_EvoformerAttention, evoformer_attention

__all__ = ["DS4Sci_EvoformerAttention", "evoformer_attention"]
