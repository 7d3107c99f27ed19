"""Crossfade and over for the pull path (``canvas_tpu/ops/mix.py``,
video_mix.c), each with a NumPy arm and a torch arm.

Colors are stored with *unassociated* alpha; both blends weight by alpha
and divide back out, exactly like the reference:

  cross (video_mix.c:108-235):
      alpha_a = a.a * (1 - mix_b); alpha_b = b.a * mix_b
  over  (video_mix.c:238-370):
      alpha_b = b.a * mix_b;       alpha_a = under.a * (1 - b.a * mix_b)
  out.a = alpha_a + alpha_b
  out.rgb = (a.rgb * alpha_a + b.rgb * alpha_b) / out.a   (0 where out.a == 0)

Inputs and outputs are float32 ``(4, H, W)`` planes, zero outside their
current windows, so one pointwise formula covers the whole frame. An op
takes the torch arm when an input is a tensor (on that tensor's device;
a NumPy input is copied there) or when ``backend.use_torch_for`` says
so. The torch arm keeps the JAX arm's form and op order,
``where(out_a != 0, num / where(out_a != 0, out_a, 1), 0)``.
"""

import numpy as np
import torch

from canvas_tpu_torch import backend

__all__ = ['cross', 'over', 'over_stack', 'attenuate']


def _clamp_mix(mix_b):
    return min(max(np.float32(mix_b), np.float32(0.0)), np.float32(1.0))


# --- NumPy arm ---------------------------------------------------------------

def _combine_np(rgb_a, alpha_a, rgb_b, alpha_b):
    out_a = alpha_a + alpha_b
    with np.errstate(divide='ignore', invalid='ignore'):
        rgb = (rgb_a * alpha_a + rgb_b * alpha_b) / out_a
    rgb = np.where(out_a != 0.0, rgb, 0.0).astype(np.float32)
    return np.concatenate([rgb, out_a[None]], axis=0)


def _cross_np(a, b, mix_b):
    alpha_a = a[3] * (np.float32(1.0) - mix_b)
    alpha_b = b[3] * mix_b
    return _combine_np(a[:3], alpha_a, b[:3], alpha_b)


def _over_np(under, b, mix_b):
    alpha_b = b[3] * mix_b
    alpha_a = under[3] * (np.float32(1.0) - alpha_b)
    return _combine_np(under[:3], alpha_a, b[:3], alpha_b)


# --- torch arm ---------------------------------------------------------------

def _combine_t(rgb_a, alpha_a, rgb_b, alpha_b):
    out_a = alpha_a + alpha_b
    num = rgb_a * alpha_a + rgb_b * alpha_b
    nz = out_a != 0.0
    rgb = torch.where(nz, num / torch.where(nz, out_a, 1.0), 0.0)
    return torch.cat([rgb, out_a[None]], dim=0)


def _cross_t(a, b, mix_b):
    return _combine_t(a[:3], a[3] * float(np.float32(1.0) - mix_b),
                      b[:3], b[3] * float(mix_b))


def _over_t(under, b, mix_b):
    alpha_b = b[3] * float(mix_b)
    alpha_a = under[3] * (1.0 - alpha_b)
    return _combine_t(under[:3], alpha_a, b[:3], alpha_b)


# --- dispatch ----------------------------------------------------------------

def _blend(np_fn, t_fn, a, b, mix_b):
    mix_b = _clamp_mix(mix_b)
    dev = backend.torch_device_for(a.shape, a, b)
    if dev is not None:
        return t_fn(backend.as_tensor(a, dev), backend.as_tensor(b, dev),
                    mix_b)
    return np_fn(np.asarray(a), np.asarray(b), mix_b)


def cross(a, b, mix_b):
    return _blend(_cross_np, _cross_t, a, b, mix_b)


def over(under, b, mix_b):
    return _blend(_over_np, _over_t, under, b, mix_b)


def attenuate(a, factor):
    """Multiply alpha by factor (video_copy_frame_alpha_f32)."""
    dev = backend.torch_device_for(a.shape, a)
    if dev is not None:
        out = backend.as_tensor(a, dev).clone()
        out[3] *= float(np.float32(factor))
        return out
    out = np.array(a, copy=True)
    out[3] *= np.float32(factor)
    return out


def over_stack(layers):
    """layers: (L, 4, H, W); composite bottom-to-top with over at mix 1.0."""
    if layers.shape[0] == 1:
        return layers[0]
    dev = backend.torch_device_for(layers.shape, layers)
    if dev is not None:
        layers = backend.as_tensor(layers, dev)
        out = layers[0]
        for i in range(1, layers.shape[0]):
            alpha_b = layers[i, 3]
            out = _combine_t(out[:3], out[3] * (1.0 - alpha_b),
                             layers[i, :3], alpha_b)
        return out
    layers = np.asarray(layers)
    out = layers[0]
    for i in range(1, layers.shape[0]):
        out = _over_np(out, layers[i], np.float32(1.0))
    return out
