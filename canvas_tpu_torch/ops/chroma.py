"""DV chroma reconstruction on the host: the DV part of
``canvas_tpu/ops/chroma.py`` (video_reconstruct.c:50-137).

The planner takes the chroma upsample matrix and the YCbCr -> RGB
matrix from here for the batched ``dv_recon_rows`` op; the pull path
reconstructs a frame with NumPy (``reconstruct_dv``).

DV geometry: 720x480, 4:1:1 chroma co-sited with the left pixel,
Rec.709 matrix and transfer, picture offset (0, -1) so line zero
belongs to the first field.
"""

import numpy as np

from canvas_tpu_torch.basetypes import EMPTY_BOX2I, box2i, box2i_intersect
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.ops import scale as scale_ops
from canvas_tpu_torch.ops import window as window_ops

__all__ = ['DV_FULL_WIDTH', 'DV_FULL_HEIGHT', 'DV_PIC_OFFSET',
           'YCBCR_TO_RGB_REC709', 'reconstruct_dv_full', 'reconstruct_dv']

DV_FULL_WIDTH = 720
DV_FULL_HEIGHT = 480
DV_PIC_OFFSET = (0, -1)      # video_reconstruct.c:70-71

# Rec. 709 YCbCr -> RGB (Poynton p. 316; video_reconstruct.c:62-66)
YCBCR_TO_RGB_REC709 = np.array([
    [1.0, 0.0, 1.5748],
    [1.0, -0.187324, -0.468124],
    [1.0, 1.8556, 0.0]], dtype=np.float32)


def _studio_luma8_to_float(y):
    return (y - np.float32(16.0)) / np.float32(219.0)


def _studio_chroma8_to_float(c):
    return (c - np.float32(128.0)) / np.float32(224.0)


_dv_up = None


def _dv_up_matrix():
    """(720, 180) chroma scatter matrix: triangle filter sub=4, offset 0
    (video_reconstruct.c:85-109). Chroma sample x contributes to luma
    columns 4x-3 .. 4x+3 with weights 1-|i|/4 (not normalized)."""
    global _dv_up
    if _dv_up is None:
        coeff, center = scale_ops.triangle_weights(4.0, 0.0)
        W = np.zeros((DV_FULL_WIDTH, DV_FULL_WIDTH // 4), dtype=np.float32)
        endx = (DV_FULL_WIDTH - 1) // 4
        for x in range(endx + 1):
            for k, w in enumerate(coeff):
                i = x * 4 + (k - center)
                if 0 <= i < DV_FULL_WIDTH:
                    W[i, x] += w
        _dv_up = W
    return _dv_up


def reconstruct_dv_full(y_plane, cb_plane, cr_plane):
    """Full-frame DV 4:1:1 -> linear RGBA f16.

    y: (480, 720) u8; cb/cr: (480, 180) u8. Returns (4, 480, 720) f16 in
    *image coordinates* (row 0 = image line 0); callers apply the (0,-1)
    picture offset when windowing.
    """
    y = _studio_luma8_to_float(y_plane.astype(np.float32))
    cb = _studio_chroma8_to_float(cb_plane.astype(np.float32))
    cr = _studio_chroma8_to_float(cr_plane.astype(np.float32))

    U = _dv_up_matrix()
    cb_full = cb @ U.T       # (480, 720)
    cr_full = cr @ U.T

    M = YCBCR_TO_RGB_REC709
    ycc = np.stack([y, cb_full, cr_full], axis=0)
    rgb = np.einsum('ij,jhw->ihw', M, ycc)
    alpha = np.ones_like(y)[None]
    # TRUNCATING f32->f16 like the reference's rgba_f32_to_f16
    # (half_convert_from_float rounds toward zero), so the LUT input and
    # the decoded pixels are the C engine's bits
    rgba16 = color_ops.float_to_half_trunc(
        np.concatenate([rgb, alpha], axis=0))
    return color_ops.transfer_rec709_to_linear_scene(rgba16)


def reconstruct_dv(planes, full_window):
    """DV 4:1:1 planar -> windowed linear RGBA f16 frame data.

    planes: (y, cb, cr) u8 arrays of shapes (480,720), (480,180),
    (480,180). Returns (data (4,H,W) f16, current_window) for the given
    target *full_window* (video_reconstruct.c:50-137).
    """
    ox, oy = DV_PIC_OFFSET
    image_box = box2i(ox, oy, DV_FULL_WIDTH + ox - 1, DV_FULL_HEIGHT + oy - 1)
    current = box2i_intersect(image_box, full_window)
    if current.empty():
        return (np.zeros((4, full_window.height, full_window.width),
                         np.float16), EMPTY_BOX2I)
    full = reconstruct_dv_full(planes[0], planes[1], planes[2])
    return window_ops.place(full, image_box, full_window, current), current
