"""One frame of a configuration (``configs/<name>.json``, the layer
dicts of ``graph.py``) composited in plain PyTorch, in the order and
precision of the pull path (src/process/*.c of the reference engine):
every layer rendered in f32 over the whole window, the workspace's over
blends in f32, the result rounded to f16 once. Parameters are worked out
on the host in f64, as frame functions are.

A layer kind of its own (``graph.py``) renders through
``layers/<kind>.py`` beside this file: its ``render(renderer, spec,
frame, full)`` returns ``(data, box)`` as ``Renderer.layer`` does, renders
a nested spec with ``renderer.layer`` (a stack of them with
``renderer.stack``) and imports nothing of the program.

Boxes are ``(x0, y0, x1, y1)`` tuples, inclusive; a box with x1 < x0 or
y1 < y0 is empty. A frame is ``(data, box)``: ``data`` a (4, H, W) f32
tensor over the requested window, zero outside ``box``.
"""

import os

import numpy as np
import torch

from gpubench import cells, inputs
from gpubench.reference import tables

#: Where a layer kind of its own is found: ``<kind>.py``.
LAYERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'layers')

EMPTY = (0, 0, -1, -1)

#: The DV picture inside its frame: line zero belongs to the first
#: field, so the picture sits one row up (video_reconstruct.c:70-71).
DV_IMAGE = (0, -1, 719, 478)

YCBCR_TO_RGB_REC709 = np.array([[1.0, 0.0, 1.5748],
                                [1.0, -0.187324, -0.468124],
                                [1.0, 1.8556, 0.0]], dtype=np.float32)


# --- boxes and frame functions ----------------------------------------------

def empty(b):
    return b[2] < b[0] or b[3] < b[1]


def intersect(a, b):
    out = (max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]),
           min(a[3], b[3]))
    return EMPTY if empty(out) else out


def union(a, b):
    """Union where an empty box is the identity."""
    if empty(a):
        return b
    if empty(b):
        return a
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]),
            max(a[3], b[3]))


def size(b):
    return b[3] - b[1] + 1, b[2] - b[0] + 1


def _values(value, frame, length):
    """A spec value at *frame* as four f64 values (basicframefuncs.c)."""
    out = np.zeros(4, np.float64)
    if isinstance(value, dict) and 'lerp' in value:
        s, e = np.zeros(4), np.zeros(4)
        s[:len(value['lerp'][0])] = value['lerp'][0]
        e[:len(value['lerp'][1])] = value['lerp'][1]
        s = s.astype(np.float32).astype(np.float64)
        e = e.astype(np.float32).astype(np.float64)
        f = np.asarray([float(frame)], np.float64)[:, None]
        return (f * (e - s) / float(length) + s)[0]
    if isinstance(value, dict) and 'linear' in value:
        a, b = value['linear']
        out[0] = float(frame) * (a / length) + b
        return out
    v = list(value) if isinstance(value, (list, tuple)) else [value]
    out[:len(v)] = v
    return out


def _lround(x):
    return int(np.sign(x) * np.floor(np.abs(x) + 0.5))


def f32(value, frame, length):
    return float(np.float32(_values(value, frame, length)[0]))


def v2f(value, frame, length):
    v = _values(value, frame, length)
    return float(np.float32(v[0])), float(np.float32(v[1]))


def rgba(value, frame, length):
    v = _values(value, frame, length).astype(np.float32)
    return (float(v[0]), float(v[1]), float(v[2]),
            float(np.clip(v[3], 0.0, 1.0)))


def box(value, frame, length):
    v = _values(value, frame, length)
    return tuple(_lround(x) for x in v)


# --- blends (video_mix.c) -----------------------------------------------------

def _combine(rgb_a, alpha_a, rgb_b, alpha_b):
    out_a = alpha_a + alpha_b
    rgb = (rgb_a * alpha_a + rgb_b * alpha_b) / out_a
    rgb = torch.where(out_a != 0.0, rgb, torch.zeros((), device=rgb.device))
    return torch.cat([rgb, out_a[None]], dim=0)


def cross(a, b, mix_b):
    mix_b = np.float32(min(max(np.float32(mix_b), np.float32(0.0)),
                           np.float32(1.0)))
    return _combine(a[:3], a[3] * float(np.float32(1.0) - mix_b),
                    b[:3], b[3] * float(mix_b))


def over(under, b):
    alpha_b = b[3] * 1.0
    return _combine(under[:3], under[3] * (1.0 - alpha_b), b[:3], alpha_b)


# --- the bilinear scaler's taps (filter.c, video_scale.c) -----------------------

def _axis_taps(factor, t_lo, t_hi, s_lo, s_hi, t_point, s_point):
    T = t_hi - t_lo + 1
    if T <= 0 or factor <= 0.0:
        return (np.zeros((max(T, 0), 1), np.int32),
                np.zeros((max(T, 0), 1), np.float32),
                np.zeros(max(T, 0), bool))
    t = np.arange(t_lo, t_hi + 1, dtype=np.float64)
    width = 1.0 if factor > 1.0 else 1.0 / factor
    g = (t - t_point) / factor + s_point
    left = np.floor(g - width).astype(np.int64) + 1
    right = np.ceil(g + width).astype(np.int64) - 1
    K = int(max(1, (right - left).max() + 1))
    pos = left[:, None] + np.arange(K)[None, :]
    in_support = pos <= right[:, None]
    dist = np.abs(pos - g[:, None]) / width
    w_raw = np.where(in_support, 1.0 - dist, 0.0).astype(np.float32)
    w = w_raw
    if factor < 1.0:
        sums = w.sum(axis=1, keepdims=True)
        w = np.where(sums != 0.0, w / np.where(sums != 0.0, sums, 1.0), 0.0)
    in_window = (pos >= s_lo) & (pos <= s_hi)
    w = np.where(in_window, w, 0.0).astype(np.float32)
    touched = (in_window & (w_raw != 0.0)).any(axis=1)
    pos = np.clip(pos, s_lo, s_hi).astype(np.int32)
    return pos, w, touched


def _axis_matrix(factor, t_lo, t_hi, s_lo, s_hi, t_point, s_point):
    T, S = t_hi - t_lo + 1, s_hi - s_lo + 1
    if T <= 0 or S <= 0 or factor <= 0.0:
        return (np.zeros((max(T, 0), max(S, 0)), np.float32),
                np.zeros(max(T, 0), bool))
    W = np.zeros((T, S), dtype=np.float32)
    pos, w, touched = _axis_taps(factor, t_lo, t_hi, s_lo, s_hi, t_point,
                                 s_point)
    np.add.at(W, (np.repeat(np.arange(T), pos.shape[1]),
                  (pos - s_lo).ravel()), w.ravel())
    return W, touched


def _touched(touched, lo):
    idx = np.nonzero(touched)[0]
    if idx.size == 0:
        return None
    return int(idx[0]) + lo, int(idx[-1]) + lo


def _axis(factor, t_lo, t_hi, s_lo, s_hi, tp, sp):
    """One axis of the scale: its matrix and the target range it
    touches (None: nothing)."""
    W, touched = _axis_matrix(factor, t_lo, t_hi, s_lo, s_hi, tp, sp)
    if factor == 1.0 and tp == sp:
        lo, hi = max(s_lo, t_lo), min(s_hi, t_hi)
        return W, ((lo, hi) if lo <= hi else None)
    return W, _touched(touched, t_lo)


def scale_bilinear(src, src_full, src_cur, target, tp, sp, factors):
    """The scaled (4, H, W) f32 frame over *target*, and its box."""
    h, w = size(target)
    if empty(src_cur) or factors[0] <= 0.0 or factors[1] <= 0.0:
        return torch.zeros((4, h, w), device=src.device), EMPTY
    Wy, yr = _axis(factors[1], target[1], target[3], src_cur[1], src_cur[3],
                   tp[1], sp[1])
    Wx, xr = _axis(factors[0], target[0], target[2], src_cur[0], src_cur[2],
                   tp[0], sp[0])
    if yr is None or xr is None:
        return torch.zeros((4, h, w), device=src.device), EMPTY

    def expand(W, cur_lo, full_lo, full_hi):
        out = np.zeros((W.shape[0], full_hi - full_lo + 1), np.float32)
        a = cur_lo - full_lo
        out[:, a:a + W.shape[1]] = W
        return torch.from_numpy(out).to(src.device)

    Wy = expand(Wy, src_cur[1], src_full[1], src_full[3])
    Wx = expand(Wx, src_cur[0], src_full[0], src_full[2])
    out = torch.matmul(torch.matmul(Wy, src), Wx.T)
    return out, intersect((xr[0], yr[0], xr[1], yr[1]), target)


# --- DV 4:1:1 reconstruction (video_reconstruct.c:50-137) -----------------------

def _triangle(sub, offset):
    """filter_createTriangle (filter.c:24-77) in f32: (coeffs, center)."""
    sub, offset = np.float32(sub), np.float32(offset)
    width = np.float32(1.0) / sub if sub < np.float32(1.0) else sub
    left = np.float32(np.ceil(offset - width))
    right = np.float32(np.floor(offset + width))
    if left == offset - width:
        left += np.float32(1.0)
    if right == offset + width:
        right -= np.float32(1.0)
    n, center = int(right) - int(left) + 1, -int(left)
    i = np.arange(n, dtype=np.float32)
    coeff = (np.float32(1.0) - np.abs((np.float32(1.0) / width)
                                      * ((i - np.float32(center)) - offset)))
    return coeff.astype(np.float32), center


def dv_up_matrix():
    """(720, 180): chroma sample x spreads over luma columns 4x-3 .. 4x+3
    with weights 1 - |i| / 4."""
    coeff, center = _triangle(4.0, 0.0)
    W = np.zeros((720, 180), np.float32)
    for x in range(180):
        for k, w in enumerate(coeff):
            i = x * 4 + (k - center)
            if 0 <= i < 720:
                W[i, x] += w
    return W


def _quantize_f16_trunc(x):
    h = x.to(torch.float16)
    bits = h.view(torch.int16)
    over_ = h.float().abs() > x.abs()
    out = torch.where(over_, bits - 1, bits).view(torch.float16).float()
    big = x.abs() >= 65536.0
    inf = torch.full_like(x, float('inf'))
    return torch.where(big, torch.where(x < 0, -inf, inf), out)


def _gather(table, x16):
    bits = x16.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return table[bits]


def dv_image(planes, device, consts):
    """The (4, 480, 720) f16 linear RGBA picture of one DV frame."""
    y8, cb8, cr8 = (torch.from_numpy(np.ascontiguousarray(p)).to(device)
                    for p in planes)
    y = (y8.float() - 16.0) / 219.0
    cb = torch.matmul((cb8.float() - 128.0) / 224.0, consts['dv_up'].T)
    cr = torch.matmul((cr8.float() - 128.0) / 224.0, consts['dv_up'].T)
    rgb = torch.einsum('ij,jhw->ihw', consts['ycbcr'],
                       torch.stack([y, cb, cr], dim=0))
    rgba16 = _quantize_f16_trunc(torch.cat([rgb, torch.ones_like(y)[None]]))
    return _gather(consts['scene'], rgba16).to(torch.float16)


def place(src, src_box, dst_box, copy):
    h, w = size(dst_box)
    out = torch.zeros((src.shape[0], h, w), dtype=src.dtype,
                      device=src.device)
    if not empty(copy):
        out[:, copy[1] - dst_box[1]:copy[3] - dst_box[1] + 1,
            copy[0] - dst_box[0]:copy[2] - dst_box[0] + 1] = \
            src[:, copy[1] - src_box[1]:copy[3] - src_box[1] + 1,
                copy[0] - src_box[0]:copy[2] - src_box[0] + 1]
    return out


# --- layers --------------------------------------------------------------------

class Renderer:
    """Renders frames of one configuration for one seed on *device*."""

    def __init__(self, config, seed, device):
        self.config = config
        self.length = config['length']
        self.device = torch.device(device)
        self.window = tuple(config['window'])
        self.seed = seed
        self._dv = {}
        self._kinds = {}
        self.consts = {
            'dv_up': torch.from_numpy(dv_up_matrix()).to(self.device),
            'ycbcr': torch.from_numpy(YCBCR_TO_RGB_REC709).to(self.device),
            'scene': torch.from_numpy(
                tables.rec709_to_linear_scene()).to(self.device),
        }

    def _dv_base(self, clip):
        if clip not in self._dv:
            self._dv[clip] = inputs.dv_base_planes(self.seed, clip)
        return self._dv[clip]

    def layer(self, spec, frame, full):
        """Render *spec* at *frame* over the box *full*: (data, box)."""
        kind, L = spec['kind'], self.length
        h, w = size(full)
        zeros = torch.zeros((4, h, w), dtype=torch.float32,
                            device=self.device)
        if kind == 'solid':
            win = (box(spec['window'], frame, L) if 'window' in spec
                   else (-(1 << 30), -(1 << 30), 1 << 30, 1 << 30))
            cur = intersect(win, full)
            if empty(cur):
                return zeros, EMPTY
            color = np.asarray(rgba(spec['color'], frame, L), np.float32)
            zeros[:, cur[1] - full[1]:cur[3] - full[1] + 1,
                  cur[0] - full[0]:cur[2] - full[0] + 1] = \
                torch.from_numpy(color).to(self.device)[:, None, None]
            return zeros, cur
        if kind == 'gain_offset':
            data, cur = self.layer(spec['source'], frame, full)
            if empty(cur):
                return data, cur
            g = f32(spec['gain'], frame, L)
            o = f32(spec.get('offset', 0.0), frame, L)
            scale = torch.tensor([g, g, g, 1.0], dtype=torch.float32,
                                 device=self.device)[:, None, None]
            shift = torch.tensor([o, o, o, 0.0], dtype=torch.float32,
                                 device=self.device)[:, None, None]
            out = data * scale + shift
            if cur != full and o != 0.0:
                out = place(out, full, full, cur)
            return out, cur
        if kind == 'mix':
            m = min(max(f32(spec['mix'], frame, L), 0.0), 1.0)
            if m == 0.0:
                return self.layer(spec['a'], frame, full)
            if m == 1.0:
                return self.layer(spec['b'], frame, full)
            a, abox = self.layer(spec['a'], frame, full)
            b, bbox = self.layer(spec['b'], frame, full)
            outer = intersect(union(abox, bbox), full)
            if empty(outer):
                return zeros, EMPTY
            return cross(a, b, m), outer
        if kind == 'scaler':
            return self._scaler(spec, frame, full, zeros)
        if kind == 'dv':
            cur = intersect(DV_IMAGE, full)
            if empty(cur):
                return zeros, EMPTY
            planes = inputs.dv_frame_planes(self._dv_base(spec['clip']),
                                            frame)
            image = dv_image(planes, self.device, self.consts)
            return place(image, DV_IMAGE, full, cur).float(), cur
        return self._kind(kind).render(self, spec, frame, full)

    def _kind(self, kind):
        if kind not in self._kinds:
            path = os.path.join(LAYERS_DIR, kind + '.py')
            if not os.path.exists(path):
                raise SystemExit('unknown layer kind %r: no %s'
                                 % (kind, path))
            self._kinds[kind] = cells.load_reference(
                path, 'gpubench.reference.layers.' + kind)
        return self._kinds[kind]

    def _scaler(self, spec, frame, full, zeros):
        L = self.length
        tp = v2f(spec['target_point'], frame, L)
        sp = v2f(spec['source_point'], frame, L)
        fx, fy = v2f(spec['scale_factors'], frame, L)
        rect = box(spec['source_rect'], frame, L)
        if fx == 0.0 or fy == 0.0:
            return zeros, EMPTY
        if fx == 1.0 and fy == 1.0 and tp == sp:
            return self.layer(spec['source'], frame, full)
        fetch = (int(sp[0] - (tp[0] - full[0]) / fx) - 1,
                 int(sp[1] - (tp[1] - full[1]) / fy) - 1,
                 int(sp[0] + (full[2] - tp[0]) / fx) + 1,
                 int(sp[1] + (full[3] - tp[1]) / fy) + 1)
        fetch = intersect(fetch, rect)
        if empty(fetch):
            return zeros, EMPTY
        src, cur = self.layer(spec['source'], frame, fetch)
        if empty(cur):
            return zeros, EMPTY
        return scale_bilinear(src, fetch, cur, full, tp, sp, (fx, fy))

    def frame(self, frame):
        """The (4, H, W) f16 frame *frame* of the workspace."""
        out, _cur = self.stack(self.config['layers'], frame, self.window)
        return out.to(torch.float16)

    def stack(self, specs, frame, full):
        """The layers *specs*, bottom to top, composited over the box
        *full* as a workspace composites its items: (data, box)."""
        out, cur = None, EMPTY
        for spec in specs:
            data, win = self.layer(spec, frame, full)
            if out is None:
                out, cur = data, win
            elif empty(cur):
                out = data.clone()
                cur = intersect(win, full) if not empty(win) else EMPTY
            elif not empty(win):
                out = over(out, data)
                cur = intersect(union(cur, win), full)
        return out, cur
