"""Whether the frames the window produced are right: each sampled frame
against the plain reference (``reference/``), rendered from the same
configuration, seed and frame index.

An export cell (``post`` 'yuv420') compares the fetched u8 transport
with the reference's; a cell with no post compares the f16 frames left
on the device with the reference's, bit for bit. Two numbers each, with
their limits in ``limits/<cell>.json``: the share of values that differ
(``*_mismatch_share``) and the largest difference (``*_max_diff``); a
number the cell's limits leave out is not compared."""

import torch

from gpubench.reference import compose, post


def judge(samples, config, seed, traffic, device, limits):
    """``(correct, failed, checks)``: *checks* maps each compared number's
    name (those *limits* holds) to its value and limit; *failed* counts
    the sampled frames that break a limit on their own."""
    renderer = compose.Renderer(config, seed, device)
    u8 = traffic['post'] is not None
    if u8 and traffic['post'] != 'yuv420':
        raise ValueError('the check knows the yuv420 post only')
    tag = 'u8' if u8 else 'f16'
    share_key, max_key = tag + '_mismatch_share', tag + '_max_diff'
    differ = total = 0
    worst = 0.0
    failed = 0
    for frame, data in samples:
        ref16 = renderer.frame(frame)
        if u8:
            ref = post.yuv420(ref16[None])[0].to(torch.int32)
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
