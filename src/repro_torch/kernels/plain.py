"""The plain versions of the model-path kernels, on any device: the ops a
model runs when given ``impl=plain`` (``ops`` dispatch takes 'torch' on CPU
tensors only).  On the card they are the yardstick the kernels' path is
compared with, one model forward against the other."""
from .mamba2_glue import mamba2_conv_in_plain as mamba2_conv_in
from .mamba2_glue import mamba2_gate_out_plain as mamba2_gate_out
from .mamba2_glue import mamba2_norm_in_plain as mamba2_norm_in
from .rwkv6_glue import rwkv6_channel_in_plain as rwkv6_channel_in
from .rwkv6_glue import rwkv6_channel_out_plain as rwkv6_channel_out
from .rwkv6_glue import rwkv6_decay_plain as rwkv6_decay
from .rwkv6_glue import rwkv6_head_out_plain as rwkv6_head_out
from .rwkv6_glue import rwkv6_relu2_plain as rwkv6_relu2
from .rwkv6_glue import rwkv6_time_in_plain as rwkv6_time_in
from .xla_attention import attention
from .xla_linear import mamba2, rwkv6

__all__ = ["attention", "mamba2", "mamba2_conv_in", "mamba2_gate_out",
           "mamba2_norm_in", "rwkv6", "rwkv6_channel_in",
           "rwkv6_channel_out", "rwkv6_decay", "rwkv6_head_out",
           "rwkv6_relu2", "rwkv6_time_in"]
