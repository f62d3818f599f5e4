"""The UNet decoder's 2x upsampling on NDHWC volumes.

Nearest is torch's legacy nearest (`src = floor(dst / 2)`), the 6M
`anatomix` decoder. Trilinear belongs to the `anatomix-dev` slice
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import torch


def upsample2x(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    if mode != "nearest":
        raise NotImplementedError(
            f"upsample mode {mode!r} arrives with the dev slice "
            "(ROADMAP Queue 1 item 8)"
        )
    for axis in (1, 2, 3):
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x
