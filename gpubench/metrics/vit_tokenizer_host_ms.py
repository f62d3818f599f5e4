"""Host ms per traced volume in the program's `vit/tokenizer` ranges: the
ViT's conv tokenizer (split convs, instance-norm statistics, D1, the 1x1x1
projection), over all windows."""

from gpubench.readers import range_mean_ms

read = range_mean_ms("vit/tokenizer")
