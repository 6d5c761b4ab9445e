from .layer import DistributedAttention, UlyssesAttention, single_all_to_all
from .ring_attention import RingAttention, ring_attention_local
from .cross_entropy import vocab_sequence_parallel_cross_entropy
from .fpdt_layer import (FPDT_Attention, FPDTHostOffloadAttention,
                         SequenceChunk, chunked_attention, fpdt_ffn,
                         fpdt_logits_loss, update_out_and_lse)
