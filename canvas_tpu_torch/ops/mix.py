"""Crossfade and over on NumPy frames (the ``*_np`` arm of
``canvas_tpu/ops/mix.py``, the pull path's blends; video_mix.c).

Colors are stored with *unassociated* alpha; both blends weight by alpha
and divide back out, exactly like the reference:

  cross (video_mix.c:108-235):
      alpha_a = a.a * (1 - mix_b); alpha_b = b.a * mix_b
  over  (video_mix.c:238-370):
      alpha_b = b.a * mix_b;       alpha_a = under.a * (1 - b.a * mix_b)
  out.a = alpha_a + alpha_b
  out.rgb = (a.rgb * alpha_a + b.rgb * alpha_b) / out.a   (0 where out.a == 0)

Inputs and outputs are float32 ``(4, H, W)`` planes, zero outside their
current windows, so one pointwise formula covers the whole frame.
"""

import numpy as np

__all__ = ['cross', 'over', 'attenuate']


def _combine(rgb_a, alpha_a, rgb_b, alpha_b):
    out_a = alpha_a + alpha_b
    with np.errstate(divide='ignore', invalid='ignore'):
        rgb = (rgb_a * alpha_a + rgb_b * alpha_b) / out_a
    rgb = np.where(out_a != 0.0, rgb, 0.0).astype(np.float32)
    return np.concatenate([rgb, out_a[None]], axis=0)


def cross(a, b, mix_b):
    a, b = np.asarray(a), np.asarray(b)
    mix_b = min(max(np.float32(mix_b), np.float32(0.0)), np.float32(1.0))
    alpha_a = a[3] * (np.float32(1.0) - mix_b)
    alpha_b = b[3] * mix_b
    return _combine(a[:3], alpha_a, b[:3], alpha_b)


def over(under, b, mix_b):
    under, b = np.asarray(under), np.asarray(b)
    mix_b = min(max(np.float32(mix_b), np.float32(0.0)), np.float32(1.0))
    alpha_b = b[3] * mix_b
    alpha_a = under[3] * (np.float32(1.0) - alpha_b)
    return _combine(under[:3], alpha_a, b[:3], alpha_b)


def attenuate(a, factor):
    """Multiply alpha by factor (video_copy_frame_alpha_f32)."""
    out = np.array(a, copy=True)
    out[3] *= np.float32(factor)
    return out
