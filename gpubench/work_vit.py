"""The work of the ViT's requests, counted from the configuration.

Operations and bytes of one forward of the `anatomix-dev-vit` ViT on one
window, and of a volume's `sliding` extraction, for the model FLOP
utilisation and the roofline shares; counted as `work.py` counts the
UNet's. Each product counts once, whatever runs it (the program's
three-term split of the tokenizer's operands runs three times the products;
that is not counted): a 3x3x3 conv `2 * 27 * Ci * Co` a voxel of its
output, a linear `2 * Ci * Co` a token, attention `4 * N^2 * E` a block and
window (q k^T and p v over every head), a transposed conv of kernel 2
`2 * Ci * 8 Co` a voxel of its input. Bytes count each input and output
once in bfloat16, with the weights: the convs, the tokenizer's instance
norms and the decoder's channel LayerNorm and GELU (a read and a write), the
linears, attention (q, k, v read, the output written), the LayerNorms of
the blocks (norm1, q and k, the inner norm, norm2) and the final one, RoPE
on q and k, the exit (the last stage's output read, the folded rows
written) and the stitch (each window's output read, the volume's features
written once in float32). Softmax, residual adds, LayerScale and copies
count nothing, so the least time is a lower bound.
"""

from __future__ import annotations

from gpubench import peaks
from gpubench.reference.primus import (
    decoder_widths,
    grid_shape,
    mlp_hidden,
    tokenizer_widths,
)

ACT_BYTES = 2  # bfloat16


def _parts(cfg: dict) -> list[tuple[str, float, float]]:
    """(part, operations, bytes) of every layer of one forward of one
    window."""
    out: list[tuple[str, float, float]] = []
    b = ACT_BYTES
    s = cfg["input_shape"]
    vox = float(s[0] * s[1] * s[2])

    def conv(ci, co, vin, vout, taps=27):
        out.append(("tokenizer", 2.0 * taps * ci * co * vout,
                    b * (ci * vin + co * vout + taps * ci * co)))

    def norm(c, v):
        out.append(("tokenizer", 0.0, 2.0 * b * c * v))

    stages, last = tokenizer_widths(cfg)
    base = cfg["tokenizer_base_features"]
    conv(cfg["input_channels"], base, vox, vox)
    norm(base, vox)
    for (ci, co), depth in zip(stages, cfg["tokenizer_depth_per_level"]):
        conv(ci, co, vox, vox / 8)
        vox /= 8
        norm(co, vox)
        for _ in range(depth):
            for _ in range(2):
                conv(co, co, vox, vox)
                norm(co, vox)
    e = cfg["embed_dim"]
    conv(last, e, vox, vox, taps=1)
    g = grid_shape(cfg)
    n = float(g[0] * g[1] * g[2] + cfg["num_register_tokens"])
    hd = e // cfg["eva_numheads"]
    hid = mlp_hidden(cfg)

    def linear(ci, co):
        out.append(("linears", 2.0 * ci * co * n,
                    b * (ci * n + co * n + ci * co)))

    def glue(c, tokens):
        out.append(("glue", 0.0, 2.0 * b * c * tokens))

    for _ in range(cfg["eva_depth"]):
        glue(e, n)  # norm1
        for _ in range(4):  # q, k, v, proj
            linear(e, e)
        if cfg["qk_norm"]:
            glue(2 * e, n)
        glue(2 * e, n - cfg["num_register_tokens"])  # RoPE on q and k
        out.append(("attention", 4.0 * n * n * e, 4.0 * b * n * e))
        if cfg["scale_attn_inner"]:
            glue(e, n)
        glue(e, n)  # norm2
        linear(e, hid)
        linear(e, hid)
        linear(hid, e)
    glue(e, n)  # the final norm
    widths = decoder_widths(cfg)
    vin = float(g[0] * g[1] * g[2])
    for i, (ci, co) in enumerate(widths):
        out.append(("decoder", 2.0 * ci * 8 * co * vin,
                    b * (ci * vin + 8 * co * vin + 8 * ci * co)))
        vin *= 8
        if i < len(widths) - 1:  # the channel LayerNorm, then GELU
            out.append(("decoder", 0.0, 2.0 * 2.0 * b * co * vin))
    out.append(("decoder", 0.0, 2.0 * b * widths[-1][1] * vin))  # the exit
    return out


def forward_counts(cfg: dict, part: str | None = None) -> tuple[float, float]:
    """(operations, least seconds) of one forward of one window at the
    card's peaks, of every layer or of one `part` (`tokenizer`, `linears`,
    `glue`, `attention`, `decoder`)."""
    ops = least = 0.0
    for name, o, byts in _parts(cfg):
        if part is None or name == part:
            ops += o
            least += peaks.bound_seconds(o, byts)
    return ops, least


def extract_counts(cfg: dict, size, n_windows: int) -> tuple[float, float]:
    """(operations, least seconds) of one volume's `sliding` extraction:
    a forward of every window, and the stitch."""
    ops, least = forward_counts(cfg)
    s = cfg["input_shape"]
    vox_roi = float(s[0] * s[1] * s[2])
    vox = float(size[0] * size[1] * size[2])
    c = cfg["num_classes"]
    stitch = ACT_BYTES * n_windows * vox_roi * c + 4.0 * vox * c
    return (ops * n_windows,
            least * n_windows + peaks.bound_seconds(0.0, stitch))
