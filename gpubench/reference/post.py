"""The export's 'yuv420' transport of f16 frames, in plain PyTorch:
studio-range 4:2:0 (Y 16-235, Cb/Cr 16-240, BT.601 matrix) of the
gamma45 u8 RGB, chroma the 2x2 mean (color.py:628-656 of the reference
package's conversions)."""

import torch

from gpubench.reference import tables


def gamma45_floor(x16, levels):
    bits = x16.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return torch.floor(levels[bits])


def yuv420(x16):
    """(B, 4, H, W) f16 -> (B, H*W + 2*(H/2)*(W/2)) u8, H and W even."""
    levels = torch.from_numpy(tables.gamma45_levels()).to(x16.device)
    u8f = gamma45_floor(x16, levels)
    R, G, Bl = u8f[:, 0], u8f[:, 1], u8f[:, 2]
    Ey = (0.299 * R + 0.587 * G + 0.114 * Bl) / 255.0
    Y = 16.0 + 219.0 * Ey
    Cb = 128.0 + 224.0 * 0.5 / 0.886 * (Bl / 255.0 - Ey)
    Cr = 128.0 + 224.0 * 0.5 / 0.701 * (R / 255.0 - Ey)
    B, H, W = Y.shape

    def sub(c):
        return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

    def q(c, hi):
        return torch.round(torch.clamp(c, 16.0, hi)).to(torch.uint8) \
            .reshape(B, -1)

    return torch.cat([q(Y, 235.0), q(sub(Cb), 240.0), q(sub(Cr), 240.0)],
                     dim=1)
