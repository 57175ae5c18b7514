from biom3_tpu_torch.ops.attention import full_attention
from biom3_tpu_torch.ops.linear_attention import linear_attention
from biom3_tpu_torch.ops.local_attention import local_window_attention
from biom3_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded
from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

__all__ = [
    "full_attention",
    "linear_attention",
    "local_window_attention",
    "ring_attention",
    "ring_attention_sharded",
    "apply_rotary",
    "rotary_cos_sin",
]
