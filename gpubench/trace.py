"""The device trace of a window: ``torch.profiler`` over CPU and CUDA,
kept in memory. Busy time is the union of the device's kernel, copy and
set intervals inside the window's own span (``gpubench.window``)."""

import torch

HOST_SPANS = ('gpubench.next', 'gpubench.fetch')


def profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
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


def read(prof):
    """The window's device picture: a dict with ``busy_s``, ``window_s``,
    ``device`` (name, start us, end us) per device operation inside the
    window, and ``breakdown`` (the ten device operations that took the
    most time, and the idle time by the harness span the host was in)."""
    dev, host, win = [], [], None
    # the profiler's raw events: its own event tree, built on first use
    # of ``prof.events()``, takes minutes over a window's ~10^6 kernels
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            # the device-side copies of the harness's own spans are
            # annotations, not work
            if not name.startswith('gpubench.'):
                dev.append((name, a, b))
        elif name == 'gpubench.window':
            win = (a, b)
        elif name in HOST_SPANS:
            host.append((a, b, name))
    if win is None:
        return None
    w0, w1 = win
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in dev
           if b > w0 and a < w1]
    busy = _union([a, b] for _n, a, b in dev)
    by_op = {}
    for n, a, b in dev:
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

    return {'busy_s': sum(b - a for a, b in busy) / 1e6,
            'window_s': (w1 - w0) / 1e6,
            'device': dev,
            'breakdown': {'device_ops': top(by_op), 'idle_gaps': top(idle)}}


def _short(name):
    """A device operation's name, at most 160 characters."""
    return name[:160]
