"""Whether the frames the window produced are right: each sampled frame
against the plain reference (``reference/``), rendered from the same
configuration, seed and frame index.

An export cell compares the fetched u8 transport with the reference's:
``reference/post.yuv420`` for the post 'yuv420', and for any other post
the ``apply(x16)`` of ``reference/posts/<post>.py``, which maps a
(B, 4, H, W) f16 batch to the u8 transport the program fetches. A cell
with no post compares the f16 frames left on the device with the
reference's, bit for bit. Two numbers each, with their limits in
``limits/<cell>.json``: the share of values that differ
(``*_mismatch_share``) and the largest difference (``*_max_diff``); a
number the cell's limits leave out is not compared."""

import os

import torch

from gpubench import cells
from gpubench.reference import compose, post

#: Where the reference of a post other than 'yuv420' is found:
#: ``<post>.py``.
POSTS_DIR = os.path.join(cells.HERE, 'reference', 'posts')


def reference_post(name):
    """The plain form of the post *name*, (B, 4, H, W) f16 -> the u8
    transport; None for no post."""
    if name is None:
        return None
    if name == 'yuv420':
        return post.yuv420
    path = os.path.join(POSTS_DIR, name + '.py')
    if not os.path.exists(path):
        raise SystemExit('no reference for the post %r: no %s'
                         % (name, path))
    return cells.load_reference(
        path, 'gpubench.reference.posts.' + name).apply


def judge(samples, config, seed, traffic, device, limits):
    """``(correct, failed, checks)``: *checks* maps each compared number's
    name (those *limits* holds) to its value and limit; *failed* counts
    the sampled frames that break a limit on their own."""
    renderer = compose.Renderer(config, seed, device)
    convert = reference_post(traffic['post'])
    u8 = convert is not None
    tag = 'u8' if u8 else 'f16'
    share_key, max_key = tag + '_mismatch_share', tag + '_max_diff'
    differ = total = 0
    worst = 0.0
    failed = 0
    for frame, data in samples:
        ref16 = renderer.frame(frame)
        if u8:
            ref = convert(ref16[None])[0].to(torch.int32)
            d = (data.to(device).to(torch.int32) - ref).abs()
            n_diff = int((d != 0).sum())
        else:
            got = data.to(device)
            n_diff = int((got.view(torch.int16)
                          != ref16.view(torch.int16)).sum())
            d = torch.nan_to_num((got.float() - ref16.float()).abs(),
                                 nan=float('inf'))
        m = float(d.max())
        n = d.numel()
        values = {share_key: n_diff / n, max_key: m}
        if any(values[k] > limits[k] for k in values if k in limits):
            failed += 1
        differ += n_diff
        total += n
        worst = max(worst, m)
    values = {share_key: differ / total if total else float('inf'),
              max_key: worst if samples else float('inf')}
    checks = {k: {'value': v, 'limit': limits[k]}
              for k, v in values.items() if k in limits}
    checks['frames_compared'] = {'value': len(samples), 'limit': 1,
                                 'at_least': True}
    correct = (all(c['value'] <= c['limit'] for k, c in checks.items()
                   if k != 'frames_compared') and len(samples) >= 1)
    return correct, failed, checks
