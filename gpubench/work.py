"""The work a request needs, counted from the configuration and the shapes.

Operations and bytes of the UNet forward, for the model FLOP utilisation
and the kernels' roofline share. Each 3x3x3 conv counts once, as
2 * 27 * Ci * Co operations per output voxel, whatever runs it (the
program's three-term split of live-norm activations runs three times the
products; that is not counted). Bytes count each input byte read once and
each output byte written once in bfloat16, the program's storage type: a
conv reads its input (the concatenation in the decoder) and its weights and
writes its output; an instance norm reads and writes its activation once;
a pool or an upsample reads its input and writes its output; the stitch of
`sliding` reads each window's output and writes the volume's features once
in float32. Everything else (copies, glue) counts nothing, so the least
time is a lower bound.
"""

from __future__ import annotations

from gpubench import peaks
from gpubench.reference.unet import layout

ACT_BYTES = 2  # bfloat16


def _levels(cfg: dict, spatial) -> list[tuple[str, float, float]]:
    """(kind, operations, bytes) of every layer of one forward of a
    (1, *spatial) input."""
    lay = layout(cfg)
    vox = float(spatial[0] * spatial[1] * spatial[2])
    ch = cfg["input_nc"]
    out: list[tuple[str, float, float]] = []
    for layer in lay.layers:
        if layer.kind == "conv":
            ci, co = layer.in_ch, layer.out_ch
            ops = 2.0 * 27 * ci * co * vox
            byts = ACT_BYTES * (ci * vox + co * vox + 27 * ci * co)
            out.append(("conv", ops, byts))
            ch = co
        elif layer.kind == "norm" and cfg.get("norm", "batch") != "batch":
            out.append(("norm", 0.0, 2.0 * ACT_BYTES * ch * vox))
        elif layer.kind == "pool":
            out.append(("pool", 0.0, ACT_BYTES * ch * vox * (1 + 1 / 8)))
            vox /= 8
        elif layer.kind == "upsample":
            out.append(("upsample", 0.0, ACT_BYTES * ch * vox * (1 + 8)))
            vox *= 8
    return out


def forward_counts(cfg: dict, spatial) -> tuple[float, float]:
    """(operations, least seconds) of one forward of one (1, *spatial)
    input at the card's peaks."""
    ops = least = 0.0
    for _, o, b in _levels(cfg, spatial):
        ops += o
        least += peaks.bound_seconds(o, b)
    return ops, least


def extract_counts(cfg: dict, size, strategy: str, roi=None,
                   n_windows: int = 0) -> tuple[float, float]:
    """(operations, least seconds) of one volume's extraction: one forward
    of the whole volume (`full`), or one forward of every window and the
    stitch (`sliding`)."""
    if strategy == "full":
        return forward_counts(cfg, size)
    ops, least = forward_counts(cfg, roi)
    vox_roi = float(roi[0] * roi[1] * roi[2])
    vox = float(size[0] * size[1] * size[2])
    stitch = (ACT_BYTES * n_windows * vox_roi * cfg["output_nc"]
              + 4.0 * vox * cfg["output_nc"])
    return (ops * n_windows,
            least * n_windows + peaks.bound_seconds(0.0, stitch))
