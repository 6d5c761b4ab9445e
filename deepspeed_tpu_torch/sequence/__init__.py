from .layer import DistributedAttention, UlyssesAttention, single_all_to_all
