"""One run of one cell: set-up, the measured window, the traced
reading, the check against the reference, and the result line."""

import gc
import json
import resource
import sys
import time

import torch

from canvas_tpu_torch import backend, profiling, render
from canvas_tpu_torch.mesh import Mesh
from canvas_tpu_torch.render import RenderPlanner

from gpubench import cells, check, drive, graph, guard, trace

#: Published HBM3 bandwidth of one NVIDIA H100 SXM (bytes/s).
PEAK_BYTES_PER_S = 3.35e12


def _plan_report():
    return {k: (v[0], v[1]) for k, v in profiling.report().items()}


def _counters():
    stats = render.program_stats()
    return {'report': _plan_report(),
            'h2d_bytes': backend.transfer_stats['h2d_bytes'],
            'h2d_calls': backend.transfer_stats['h2d_calls'],
            'programs': {k: stats[k] for k in ('calls', 'replays',
                                               'captures')}}


def _delta(after, before):
    rep = {}
    for name, (total, count) in after['report'].items():
        t0, c0 = before['report'].get(name, (0.0, 0))
        rep[name] = (total - t0, count - c0)
    return {'report': rep,
            'h2d_bytes': after['h2d_bytes'] - before['h2d_bytes'],
            'h2d_calls': after['h2d_calls'] - before['h2d_calls'],
            'programs': {k: after['programs'][k] - before['programs'][k]
                         for k in after['programs']}}


def cell_devices(cell, kind='cuda'):
    """The devices a run of *cell* renders on: cards 0 to ``chips`` - 1,
    or as many entries of the CPU for *kind* 'cpu'."""
    if kind == 'cpu':
        return ['cpu'] * cell['chips']
    return ['%s:%d' % (kind, i) for i in range(cell['chips'])]


def run_cell(cell, seed, seconds, traced, devices, t_start, quality=None):
    """Run *cell* (``cells.cell``) once over *devices*, a list of 'cpu'
    or CUDA devices (one may repeat): the planner's device is the first,
    and more than one make a mesh. Returns the result dict (the JSON
    line's keys)."""
    devices = [torch.device(d) for d in devices]
    devices = [torch.device('cuda', 0) if d.type == 'cuda'
               and d.index is None else d for d in devices]
    device = devices[0]
    cards = list(dict.fromkeys(d for d in devices if d.type == 'cuda'))
    on_cuda = bool(cards)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    config, traffic = cell['config'], cell['traffic']
    check.reference_post(traffic['post'])
    t_build = time.perf_counter()
    if on_cuda:
        torch.cuda.init()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    source = graph.build(config, seed)
    planner = RenderPlanner(source, graph.window(config),
                            quality=config['quality'] if quality is None
                            else quality, device=device)
    mesh = Mesh(devices, ('frames',)) if len(devices) > 1 else None
    stream = drive.Stream(planner, config, traffic, seed, sync, mesh)
    t_warm = time.perf_counter()
    stream.warm()
    before = _counters()
    setup_s = time.perf_counter() - t_start
    print('set-up: %.3f s to the planner, %.3f s to build it, %.3f s to '
          'warm up' % (t_build - t_start, t_warm - t_build,
                       t_start + setup_s - t_warm), file=sys.stderr)
    prof = trace.profile(on_cuda) if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        w = stream.window(seconds, traced=traced)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    after = _counters()
    _print_window(w, _delta(after, before))
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    plan_text = stream.explain() if traced else None
    picture = trace.read(prof, [d.index for d in cards]) if traced else None
    if traced:
        print('trace read: %d device operations on cards %s; host peak %d '
              'MB' % (len(picture['device']) if picture else 0,
                      picture['cards_seen'] if picture else [],
                      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                      // 1024), file=sys.stderr)
    planner.close()
    del planner, source, stream, prof, mesh
    gc.collect()
    for d in cards:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    correct, failed, checks = check.judge(
        w['samples'], config, seed, traffic, device, cell['limits'])
    w['samples'] = None
    failed += w['short']

    metrics = {}
    if not traced:
        for m in cell['end_to_end']:
            if m['name'] == 'setup_s':
                value = setup_s
            elif m['unit'] == 'frames/s':
                value = w['frames'] / w['seconds']
            else:
                raise SystemExit('no way to take end-to-end metric %r'
                                 % (m['name'],))
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        ctx = dict(_delta(after, before), frames=w['frames'],
                   batches=w['batches'], firsts=w['firsts'],
                   batch=traffic['batch'],
                   seconds=w['seconds'], fetch=traffic['fetch'],
                   fetch_s=w['fetch_s'], next_s=w['next_s'],
                   trace=picture, plan_text=plan_text,
                   busy_s_by_card=picture and picture['busy_s_by_card'],
                   kernels=cells.kernels(), peak_bytes_per_s=PEAK_BYTES_PER_S)
        for m in cell['per_layer']:
            value = cells.reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}

    result = {
        'correct': bool(correct),
        'attempted': w['frames'],
        'failed': failed,
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if on_cuda else device.type,
            'kind': (torch.cuda.get_device_name(device) if on_cuda
                     else device.type),
            'count': cell['chips'],
            'memory_peak_bytes': peak,
        },
    }
    if traced and picture is not None:
        result['device']['busy_s'] = picture['busy_s']
        result['device']['window_s'] = picture['window_s']
        result['device']['busy_s_by_card'] = picture['busy_s_by_card']
        result['breakdown'] = picture['breakdown']
    result['checks'] = checks
    return result


def _print_window(w, delta):
    """The window's counts on standard error, for the reader of a run
    that reads far off."""
    rep = {k: '%d in %.3f s' % (c, t) for k, (t, c) in
           sorted(delta['report'].items())}
    print('window: %d frames in %d batches over %.3f s; host waited '
          '%.3f s for batches and %.3f s for fetches; programs %s; spans '
          '%s; %d B to the device in %d copies; host peak %d MB'
          % (w['frames'], w['batches'], w['seconds'], w['next_s'],
             w['fetch_s'], delta['programs'], rep, delta['h2d_bytes'],
             delta['h2d_calls'],
             resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024),
          file=sys.stderr)


def check_lines(checks):
    out = []
    for name, c in checks.items():
        rel = '>=' if c.get('at_least') else '<='
        out.append('check %s %r %s limit %r' % (name, c['value'], rel,
                                                 c['limit']))
    return out


def main(argv, t_start):
    import argparse
    p = argparse.ArgumentParser(prog='gpubench/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        print('no CUDA device: the benchmark runs on the card only',
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell['chips']:
        print('%s needs %d CUDA devices, found %d'
              % (args.workload, cell['chips'], torch.cuda.device_count()),
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      cell_devices(cell), t_start)
    mods = guard.refused_modules()
    if mods:
        print('refused modules loaded: %s' % ', '.join(mods),
              file=sys.stderr)
        return 3
    opened = guard.refused_opens(cells.ROOT)
    if opened:
        print('refused files opened: %s' % ', '.join(opened),
              file=sys.stderr)
        return 3
    for line in check_lines(result['checks']):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
