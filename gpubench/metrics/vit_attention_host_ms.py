"""Host ms per traced volume in the program's `vit/attention` ranges: every
EVA block's norm1, q/k/v projections, qk-norm, RoPE, the flash-attention
call, the inner norm and the output projection, over all windows."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("vit/attention")
