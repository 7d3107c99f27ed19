"""The device trace of a window: ``torch.profiler`` over CPU and CUDA,
kept in memory. A card's busy time is the union of its kernel, copy and
set intervals inside the window's own span (``gpubench.window``); a
run's is the mean over its cards. The device-side copies of host ranges
(``record_function``: the harness's spans and the program's, such as
``render.replay`` or ``backend.to_host``) are annotations that span the
gaps between their operations, and are left out."""

import torch

HOST_SPANS = ('gpubench.next', 'gpubench.fetch')


def profile(cuda):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _busy_s(intervals):
    return sum(b - a for a, b in _union(intervals)) / 1e6


def read(prof, cards=()):
    """The window's device picture: a dict with ``busy_s_by_card`` (each
    of the CUDA device indices *cards* in turn), ``busy_s`` (their mean;
    with no *cards*, the union over every device), ``window_s``,
    ``device`` (name, start us, end us) per device operation inside the
    window, ``cards_seen`` (the indices its operations ran on), and
    ``breakdown`` (the ten device operations that took the most time,
    and the idle time by the harness span the host was in, over the
    union of every card's)."""
    dev, host, win = [], [], None
    # the profiler's raw events: its own event tree, built on first use
    # of ``prof.events()``, takes minutes over a window's ~10^6 kernels
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((name, a, b, e.device_index()))
        elif name == 'gpubench.window':
            win = (a, b)
        elif name in HOST_SPANS:
            host.append((a, b, name))
    if win is None:
        return None
    w0, w1 = win
    dev = [(n, max(a, w0), min(b, w1), c) for n, a, b, c in dev
           if b > w0 and a < w1]
    busy = _union([a, b] for _n, a, b, _c in dev)
    by_card = [_busy_s([a, b] for _n, a, b, c in dev if c == card)
               for card in cards]
    by_op = {}
    for n, a, b, _c in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    idle = {}
    host.sort()
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = 'harness'
        for h0, h1, hn in host:
            if h0 <= mid <= h1:
                name = hn
                break
        idle[name] = idle.get(name, 0.0) + (b - a)

    def top(d):
        return [[_short(n), v / 1e6] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {'busy_s': (sum(by_card) / len(by_card) if by_card
                       else sum(b - a for a, b in busy) / 1e6),
            'busy_s_by_card': by_card,
            'window_s': (w1 - w0) / 1e6,
            'device': [(n, a, b) for n, a, b, _c in dev],
            'cards_seen': sorted(set(c for _n, _a, _b, c in dev)),
            'breakdown': {'device_ops': top(by_op), 'idle_gaps': top(idle)}}


def _short(name):
    """A device operation's name, at most 160 characters."""
    return name[:160]
