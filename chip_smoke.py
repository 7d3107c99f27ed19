#!/usr/bin/env python3
"""Smoke run of the PyTorch port (canvas_tpu_torch) on one CUDA card.

Drives the port's two render paths on the card, the headline render (a
10-layer 1080p composite streamed by RenderPlanner.iter_batches,
``canvas_tpu_torch.timelines.build_timeline``, bench.py's timeline) and
the mixed-content timeline (``timelines.mixed_timeline``, benchmarks.py
config7's: the headline with three DV clips, decoded on the host and
staged by the port, through animated scalers), then the fold studies and
the roofline probe, then the headline's export conversions. Each phase
prints one line; any failure raises (traceback, nonzero exit, no result
line):

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernels vs plain: each kernel against its plain PyTorch version on
   the card, on seeded inputs (solid_fold and region_over bit-identical;
   region_over_sep within atol 1e-6, f32 reassociation);
4. headline slice: frames 0..255 of timelines.build_timeline(1024)
   through iter_batches; its kernels'
   launch counters must rise; finite f16 (B, 4, 1080, 1920) batches;
   frames 0, 130 and 1000 against the NumPy pull path at atol 2e-3;
5. headline timing: cold streaming fps of frames 128..511 in 128-frame
   batches, the device's busy time for the same batches (device idle
   share), and each kernel's time beside its plain version's at the
   main path's shapes;
6. mixed slice: frames 0..127 of timelines.mixed_timeline(256) through
   iter_batches(batch=16); all three kernels' launch counters must rise;
   finite f16 batches; frames 0, 1 and 70 against the NumPy pull path at
   atol 1e-2 with at least 99% of values bit-equal;
7. mixed timing: config7_mixed_content_10layer_fps (cold: no stage
   cache, no plan cache; frames 0..127, batch 16, one warm pass, best of
   3), the device busy time of the same batches replayed and the idle
   share, the replay's device time by kernel (torch.profiler),
   and region_over beside its plain version at the path's three region
   shapes;
8. studies (canvas_tpu_torch.studies): the fold_interior kernel in all
   four variants, tile_fold and roofline_fold bit-identical to their
   plain versions, and the FMA chain within study_ops.fma_chain_tol of
   its plain version, each at a small seeded size and at the scripts'
   full size (B=32, 1080x1920 or 1088x1920); then the studies' timing
   runs: each kernel beside its plain version and, for the two folds,
   the shipped solid_fold on the same inputs, and the card's measured
   bandwidth, FMA rate (with the SM clock, which must be read) and what
   bounds solid_fold;
9. export posts: headline frames 128..383 through
   iter_batches(batch=128, post='bgra_u8') and (post='yuv420'), each
   batch against the same conversion run on the CPU over the post=None
   f16 frames of the range (the share of u8 values that differ and the
   largest difference, at most 1 on at most 0.1% of values); the
   conversions' device time on one batch; the headline's cold fps with
   post='yuv420' beside post=None's, timed in turns under phase 5's
   protocol.

Each path (the headline, the mixed timeline, the studies' timing runs,
the export posts) runs with every launch counter set to 0 just before
it and read just after; the kernels line reports each kernel's launches
in those runs, its time, its plain version's, and its bound: the larger
of the bytes it must move over the card's published memory rate and its
f32 operations over the published f32 rate (PEAK_BYTES_PER_S,
PEAK_F32_PER_S), from this run's shapes. No single PyTorch call computes
what any of the kernels computes, so ``library_ms`` is null throughout.
The line before the last is the card's nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root with no
arguments: ``python3 chip_smoke.py``. An import hook refuses JAX, the
JAX package (``canvas_tpu``) and the root scripts (``bench``,
``benchmarks``, ``scripts``): the port runs on its own, and its pull
path on NumPy.
"""

import importlib.abc
import json
import os
import subprocess
import sys
import time

SEED = 20261016
WINDOW = (0, 0, 1919, 1079)

#: Top-level modules this process may not import: JAX, the JAX package
#: and the repository's root scripts.
REFUSED = ('jax', 'jaxlib', 'canvas_tpu', 'bench', 'benchmarks', 'scripts')

#: Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet):
#: HBM bytes per second and f32 operations per second outside the tensor
#: cores. A kernel's bound is the larger of its bytes and its operations
#: over these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

#: f32 operations per pixel the kernels do (multiplies, adds, divides;
#: integer compares not counted): one premultiplied-over step of a solid
#: layer is a*m, 1 - a*m, three P*k + c*a*m and A*k + a*m (10); the
#: finalize divides three channels by A (3); a rank-1 region builds its
#: layer (ry*rx, then four channels, 5) before its over step (12); the
#: FMA chain does 2 per step and element.
FOLD_OPS_PER_LAYER = 10
FINALIZE_OPS = 3
OVER_OPS = 12
RANK1_OPS = 5


def _bound(nbytes, ops):
    """(bound ms, 'bytes' or 'operations'): the least time the card could
    take to move *nbytes* and do *ops* f32 operations."""
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_F32_PER_S * 1e3
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def _fold_params_bytes(L, B):
    """Bytes of a fold's per-layer scalars: color and box (L, B, 4) f32 /
    int32, gain and offset (L, B) f32."""
    return L * B * 40


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuse every import of a REFUSED module in this process."""

    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in REFUSED:
            raise ImportError('chip_smoke.py runs without JAX, canvas_tpu '
                              'and the root scripts (%s)' % name)
        return None


def _card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _solid_layers(rng, L, B, H, W):
    """Seeded layer scalars: random boxes, one touching the bottom-right
    edge, one empty."""
    import numpy as np
    color = rng.uniform(0.0, 1.0, size=(L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=(L, B)).astype(np.float32)
    offset = rng.uniform(-0.2, 0.2, size=(L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            y0 = rng.integers(0, H - 1)
            x0 = rng.integers(0, W - 1)
            box[l, b] = (y0, rng.integers(y0, H), x0, rng.integers(x0, W))
    box[0, 0] = (H // 2, H - 1, W // 2, W - 1)
    box[L - 1, B - 1] = (5, 4, 5, 4)
    return color, box, gain, offset


def _launch_counts():
    from canvas_tpu_torch.ops import cuda_ops
    return {'solid_fold': cuda_ops.solid_fold.launches,
            'region_over_sep': cuda_ops.region_over_sep.launches,
            'region_over': cuda_ops.region_over.launches}


_STUDY_WRAPPERS = ('fold_variant', 'tile_fold', 'fma_chain', 'roofline_fold')


def _study_launch_counts():
    from canvas_tpu_torch.ops import study_ops
    return {name: getattr(study_ops, name).launches
            for name in _STUDY_WRAPPERS}


def _zero_launch_counts():
    from canvas_tpu_torch.ops import cuda_ops, study_ops
    for name in _launch_counts():
        getattr(cuda_ops, name).launches = 0
    for name in _STUDY_WRAPPERS:
        getattr(study_ops, name).launches = 0


def _n_nodes(sig):
    return 1 + sum(_n_nodes(c) for c in sig[3])


def _children_params(sig, tparams):
    """[(child signature, its flat params)] of an over_stack root."""
    out, idx = [], 1
    for cs in sig[3]:
        n = _n_nodes(cs)
        out.append((cs, tparams[idx:idx + n]))
        idx += n
    return out


def _bit_share(a, b):
    """Share of equal f16 bit patterns of two numpy f16 arrays."""
    import numpy as np
    return float(np.mean(a.view(np.uint16) == b.view(np.uint16)))


def _mixed_slice(tag, window):
    """Phase 6: the mixed-content timeline through the kernels. Returns
    (the timeline, launches)."""
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner

    H, W = window.height, window.width
    ws = timelines.mixed_timeline(256)
    planner = RenderPlanner(ws, window)
    picked = {}
    n_frames = 0
    _zero_launch_counts()
    for s, n, out in planner.iter_batches(0, 128, batch=16):
        if (out.dtype != torch.float16
                or tuple(out.shape) != (n, 4, H, W)
                or not bool(torch.isfinite(out).all())):
            raise AssertionError('mixed batch at %d: %s %s, finite=%s'
                                 % (s, out.dtype, tuple(out.shape),
                                    bool(torch.isfinite(out).all())))
        for i in (0, 1, 70):
            if s <= i < s + n:
                picked[i] = out[i - s].cpu().numpy()
        n_frames += n
    launches = _launch_counts()
    if n_frames != 128 or min(launches.values()) <= 0:
        raise AssertionError('mixed slice rendered %d frames with launches '
                             '%r' % (n_frames, launches))
    errs, shares = {}, {}
    for i in (0, 1, 70):
        want = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        errs[i] = float(np.abs(picked[i].astype(np.float32)
                               - want.astype(np.float32)).max())
        shares[i] = _bit_share(picked[i], want)
        if (not np.isfinite(picked[i]).all() or errs[i] > 1e-2
                or shares[i] < 0.99):
            raise AssertionError('mixed frame %d differs from the pull path '
                                 'by %r (%.5f bit-equal)'
                                 % (i, errs[i], shares[i]))
    print('phase 6 mixed slice: 128 frames of timelines.mixed_timeline(256) '
          'at 1080p via iter_batches(0, 128, batch=16), finite f16; launches '
          '%s; vs the NumPy pull path frame 0 max diff %.3g (%.5f bit-equal), '
          '1 %.3g (%.5f), 70 %.3g (%.5f) (atol 1e-2, >= 0.99) %s'
          % (json.dumps(launches), errs[0], shares[0], errs[1], shares[1],
             errs[70], shares[70], tag), flush=True)
    return ws, launches


def _profile_kernels(fn):
    """[(kernel name, device ms, calls)] of one run of *fn*, by device
    time, and the total device ms (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type.name == 'CUDA':
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def _mixed_timing(tag, ws, window):
    """Phase 7: cold streaming fps, host prepare time, device busy and
    idle share, the replay's kernels, region_over vs plain. Returns
    region_over's (max diff, ms, plain ms, bound ms, bound by) at the
    path's shapes."""
    import numpy as np
    import torch

    from canvas_tpu_torch.backend import cuda_ms, paired_ms
    from canvas_tpu_torch.ops import cuda_ops
    from canvas_tpu_torch.render import RenderPlanner, params_to_torch, run

    dev = torch.device('cuda')
    H, W = window.height, window.width
    start, stop, batch = 0, 128, 16
    planner = RenderPlanner(ws, window)
    planner.stage_cache_mb = 0        # cold: every pass decodes and stages
    torch.cuda.reset_peak_memory_stats()
    for _ in planner.iter_batches(start, stop, batch=batch):
        pass
    walls = []
    for _rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _s, k, _out in planner.iter_batches(start, stop, batch=batch):
            n += k
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    fps = (stop - start) / wall
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    work = []
    prepare_ms = []
    for seg in planner.segments(start, stop, min_span=batch):
        t0 = time.perf_counter()
        _s0, sig, batches = planner._prepare(seg, batch)
        prepare_ms.append((seg, (time.perf_counter() - t0) * 1e3))
        for (_pos, _take, plist) in batches:
            work.append((sig, params_to_torch(plist, dev)))
    torch.cuda.synchronize()

    def replay():
        for sig, tparams in work:
            run(sig, tparams, dev)

    busy_ms = cuda_ms(replay, 3)
    idle = 1.0 - busy_ms / (wall * 1e3)
    t0 = time.perf_counter()
    replay()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print('phase 7 mixed host: plan + stage per segment %s ms; enqueue of '
          'the %d replayed batches %.3f ms (host clock, no sync) %s'
          % (', '.join('[%d, %d) %.1f' % (sg[0], sg[1], ms)
                       for sg, ms in prepare_ms), len(work), enqueue_ms,
             tag), flush=True)
    print('phase 7 mixed timing: config7_mixed_content_10layer_fps %.1f '
          '(best of 3 cold passes over frames %d..%d, batch %d, stage cache '
          'and plan cache off; walls %s s); device busy %.3f ms of %.3f ms '
          'wall, device idle share %.3f; peak device memory %.2f GB %s'
          % (fps, start, stop - 1, batch,
             ', '.join('%.4f' % w for w in walls), busy_ms, wall * 1e3,
             idle, peak_gb, tag), flush=True)

    kernels, prof_ms = _profile_kernels(replay)
    for name, ms, calls in kernels[:14]:
        print('phase 7 replay kernel %.3f ms (%.1f%%), %d calls: %s'
              % (ms, 100.0 * ms / prof_ms, calls, name[:160]), flush=True)
    print('phase 7 replay profile: %.3f ms of device time over %d batches '
          '%s' % (prof_ms, len(work), tag), flush=True)

    # region_over at the path's three region shapes: the non-factored
    # placed children of the first full batch of segment [1, 65).
    sig, tparams = next((sg, tp) for sg, tp in work
                        if sg[3][1][0] == 'placed'
                        and sg[3][1][3][0][0] == 'scale_taps_dyn')
    regions = [(cs[1], cp[0]['dy0'], cp[0]['dx0'])
               for cs, cp in _children_params(sig, tparams)
               if cs[0] == 'placed'
               and not cs[3][0][0].startswith('scale_solid')]
    if len(regions) != 3:
        raise AssertionError('expected 3 DV regions, got %r' % (regions,))
    rng = np.random.default_rng(SEED + 7)
    B = batch
    err = 0.0
    ms = plain_ms = 0.0
    px_all = 0
    for (h, w), dy0, dx0 in regions:
        P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)).to(dev) for s in ((B, 3, H, W), (B, 1, H, W),
                                            (B, 4, h, w))]
        P2, A2 = P.clone(), A.clone()
        cuda_ops.region_over(P, A, layer, dy0, dx0)
        cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
        err = max(err, float((P - P2).abs().max()),
                  float((A - A2).abs().max()))
        k = lambda: cuda_ops.region_over(P, A, layer, dy0, dx0)
        p = lambda: cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
        tk, tp = paired_ms(k, p, 20, 3)
        ms += tk
        plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        px_all += px
        nbytes = px * 48
        print('phase 7 kernel region_over %dx%d @ (%d, %d), batch %d: cuda '
              '%.4f ms (%.1f GB/s for %.1f MB), plain torch %.4f ms %s'
              % (h, w, dy0, dx0, B, tk, nbytes / tk / 1e6, nbytes / 1e6, tp,
                 tag), flush=True)
    if err != 0.0:
        raise AssertionError('region_over at the path shapes differs from '
                             'plain by %r' % err)

    # per pixel: the layer read (16 B), P and A read and written (32 B)
    return (err, ms, plain_ms) + _bound(px_all * 48, px_all * OVER_OPS)


def _studies(tag):
    """Phase 8: the fold studies and the roofline probe
    (canvas_tpu_torch.studies). Each kernel and variant against its plain
    version at a small seeded size and at the scripts' full size, then
    the studies' timing runs with the launch counters zeroed before and
    read after. Returns the four kernels' entries of the kernels line."""
    import torch

    from canvas_tpu_torch.ops import study_ops
    from canvas_tpu_torch.studies import fold_interior_study as fis
    from canvas_tpu_torch.studies import fold_tile_study as fts
    from canvas_tpu_torch.studies import vpu_roofline as vr

    dev = torch.device('cuda')
    errs = fis.check(dev, 6, 32, sizes=[fis.CHECK_SIZE, fis.FULL_SIZE])
    err_var = {v: max(e for (_h, _w, vv), e in errs.items() if vv == v)
               for v in study_ops.VARIANTS}
    print('phase 8 check fold_interior, L=6 B=32 at 240x512 and 1080x1920, '
          'kernel vs plain vs solid_fold_plain, max diff %s (must be 0) %s'
          % (json.dumps(err_var), tag), flush=True)
    if any(err_var.values()):
        raise AssertionError('a fold_interior variant differs: %r' % errs)
    errs = fts.check(dev)
    err_tile = max(errs.values())
    print('phase 8 check tile_fold, the script\'s five cases and L=6 B=32 '
          '1088x1920 mixed and full, kernel vs plain vs solid_fold_plain, '
          'max diff %r (must be 0) %s' % (err_tile, tag), flush=True)
    if err_tile != 0.0:
        raise AssertionError('tile_fold differs: %r' % errs)
    roof = {}
    for shape in ((2, 136, 200), (32,) + vr.FULL_SIZE):
        for name, (err, tol) in vr.check(dev, shape).items():
            e0, t0 = roof.get(name, (0.0, float('inf')))
            roof[name] = (max(e0, err), min(t0, tol))
    print('phase 8 check roofline at 2x4x136x200 and 32x4x1088x1920, kernel '
          'vs plain: %s %s' % ('; '.join(
              '%s max diff %.3g (allowed %.3g)' % (name, e, t)
              for name, (e, t) in roof.items()), tag), flush=True)
    bad = {k: v for k, v in roof.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError('roofline kernels outside tolerance: %r' % bad)
    torch.cuda.empty_cache()

    _zero_launch_counts()
    t_var = fis.timeit(dev, 6, 32)
    t_tile = fts.timeit(dev)
    r = vr.measure(dev, 32)
    launches = _study_launch_counts()
    if min(launches.values()) <= 0:
        raise AssertionError('a study kernel did not launch: %r' % launches)
    print('phase 8 studies: launches %s %s' % (json.dumps(launches), tag),
          flush=True)
    print('phase 8 fold_interior, L=6 B=32 1080x1920 finalize f32, %dx%d '
          'tiles: solid_fold (shipped) %.4f ms; %s; plain %s %s' % (
              study_ops.TILE + (t_var['solid_fold'], ', '.join(
                  '%s %.4f ms' % kv for kv in t_var['kernel'].items()),
                  ', '.join('%s %.3f ms' % kv
                            for kv in t_var['plain'].items()), tag)),
          flush=True)
    for cover, t in t_tile.items():
        print('phase 8 tile_fold %s, L=6 B=32 1088x1920 mid fold: solid_fold '
              '(shipped) %.4f ms; tile_fold %.4f ms; plain %.3f ms %s' % (
                  cover, t['solid_fold'], t['kernel'], t['plain'], tag),
              flush=True)
    for line in vr.report(r):
        print('phase 8 roofline %s %s' % (line, tag), flush=True)
    if r['sm_clock_mhz'] is None:
        raise AssertionError('nvidia-smi gave no SM clock during the FMA '
                             'chain')

    k = 40
    fma_err, fma_tol = roof['fma_chain k=%d' % k]
    # Bounds from the timed shapes: the interior study finalizes L=6
    # layers to (B, 4, H, W) f32 at B=32 1080p; the tile study writes the
    # mid fold's P and A at B=32 1088p (the ops count takes every layer
    # in every pixel, more than its tiles fold); the roofline's chain and
    # fold read and write the (B, 4, H, W) f32 image.
    L, B, (H, W) = 6, 32, fis.FULL_SIZE
    px = B * H * W
    var_bound = _bound(px * 16 + _fold_params_bytes(L, B),
                       px * (L * FOLD_OPS_PER_LAYER + FINALIZE_OPS))
    L, B, H, W = fts.FULL
    px = B * H * W
    tile_bound = _bound(px * 16 + _fold_params_bytes(L, B),
                        px * L * FOLD_OPS_PER_LAYER)
    n = r['B'] * 4 * r['H'] * r['W']
    fma_bound = _bound(r['bytes'] + 4 * k, 2 * k * n)
    fold_bound = _bound(r['bytes'] + 32 * vr.L,
                        n // 4 * vr.L * FOLD_OPS_PER_LAYER)
    return [
        {'name': 'fold_interior', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/fold_study.cu',
         'replaces': 'scripts/fold_interior_study.py:154',
         'launches': launches['fold_variant'],
         'max_abs_err': max(err_var.values()),
         'ms': t_var['kernel']['current'],
         'plain_ms': t_var['plain']['current'],
         'bound_ms': var_bound[0], 'bound_by': var_bound[1],
         'library_ms': None,
         'solid_fold_ms': t_var['solid_fold'],
         'variants': {v: {'ms': t_var['kernel'][v],
                          'plain_ms': t_var['plain'][v]}
                      for v in study_ops.VARIANTS}},
        {'name': 'tile_fold', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/tile_fold.cu',
         'replaces': 'scripts/fold_tile_study.py:33',
         'launches': launches['tile_fold'], 'max_abs_err': err_tile,
         'ms': t_tile['mixed']['kernel'],
         'plain_ms': t_tile['mixed']['plain'],
         'bound_ms': tile_bound[0], 'bound_by': tile_bound[1],
         'library_ms': None,
         'solid_fold_ms': t_tile['mixed']['solid_fold'],
         'full_coverage': {'ms': t_tile['full']['kernel'],
                           'plain_ms': t_tile['full']['plain'],
                           'solid_fold_ms': t_tile['full']['solid_fold']}},
        {'name': 'roofline_fma', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/fma_chain.cu',
         'replaces': 'scripts/vpu_roofline.py:100',
         'launches': launches['fma_chain'], 'max_abs_err': fma_err,
         'tolerance': fma_tol, 'k': k, 'ms': r['chain_ms'][k],
         'plain_ms': r['chain_plain_ms'][k],
         'bound_ms': fma_bound[0], 'bound_by': fma_bound[1],
         'library_ms': None, 'tflops': r['tflops'],
         'copy_tbs': r['copy_tbs']},
        {'name': 'roofline_fold', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/fold_study.cu',
         'replaces': 'scripts/vpu_roofline.py:197',
         'launches': launches['roofline_fold'],
         'max_abs_err': max(roof['roofline_fold select'][0],
                            roof['roofline_fold mult'][0]),
         'ms': r['fold_ms'][False], 'plain_ms': r['fold_plain_ms'][False],
         'bound_ms': fold_bound[0], 'bound_by': fold_bound[1],
         'library_ms': None,
         'mult_ms': r['fold_ms'][True],
         'mult_plain_ms': r['fold_plain_ms'][True]},
    ]


def _stream_wall(planner, start, stop, batch, post=None):
    """Wall seconds of one streaming pass over [start, stop), until the
    card has finished the last batch (phase 5's protocol)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _out in planner.iter_batches(start, stop, batch=batch, post=post):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _posts(tag, window):
    """Phase 9: the headline's export conversions. Frames 128..383 through
    iter_batches(batch=128) with post='bgra_u8' and post='yuv420', each
    batch against the same conversion run on the CPU over the post=None
    f16 frames of the range; the conversions' device time on one batch;
    the cold fps with post='yuv420' beside post=None's, in turns. Returns
    the path's launches."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.render import RenderPlanner

    H, W = window.height, window.width
    start, stop, batch = 128, 384, 128
    planner = RenderPlanner(timelines.build_timeline(1024), window)
    f16 = {s: out.cpu()
           for s, _n, out in planner.iter_batches(start, stop, batch=batch)}
    sizes = {'bgra_u8': (H, W * 4),
             'yuv420': (H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2),)}
    agree = {}
    _zero_launch_counts()
    for post, size in sizes.items():
        n_diff = n_all = worst = 0
        for s, n, out in planner.iter_batches(start, stop, batch=batch,
                                              post=post):
            if out.dtype != torch.uint8 or tuple(out.shape) != (n,) + size:
                raise AssertionError('post %s batch at %d: %s %s' % (
                    post, s, out.dtype, tuple(out.shape)))
            got = out.cpu()
            for i in range(0, n, 16):
                want = color_ops.POSTS[post](f16[s][i:i + 16])
                d = (got[i:i + 16].int() - want.int()).abs()
                n_diff += int((d != 0).sum())
                n_all += d.numel()
                worst = max(worst, int(d.max()))
        agree[post] = (n_diff / n_all, worst)
    launches = _launch_counts()
    if (launches['solid_fold'] <= 0 or launches['region_over_sep'] <= 0
            or launches['region_over'] != 0):
        raise AssertionError('export posts ran with launches %r' % launches)
    print('phase 9 posts: frames %d..%d at %dx%d via iter_batches(batch=%d, '
          'post=...), against the same conversion on the CPU over the '
          'post=None f16 frames: %s (at most 1 on at most 0.1%%); launches '
          '%s %s' % (start, stop - 1, W, H, batch, '; '.join(
              '%s %.4g of u8 values differ, max |diff| %d' % (p, sh, wd)
              for p, (sh, wd) in agree.items()), json.dumps(launches), tag),
          flush=True)
    if any(wd > 1 or sh > 1e-3 for sh, wd in agree.values()):
        raise AssertionError('posts differ from the CPU: %r' % agree)

    x16 = next(planner.iter_batches(start, start + batch, batch=batch))[2]
    px = batch * H * W
    for post, per_px in (('bgra_u8', 4), ('yuv420', 1.5)):
        ms = cuda_ms(lambda: color_ops.POSTS[post](x16), 5)
        print('phase 9 post %s on one batch of %d %dx%d f16 frames: %.3f ms '
              'on the card (%.1f GB/s for the f16 read and the u8 write) %s'
              % (post, batch, W, H, ms, px * (8 + per_px) / ms / 1e6, tag),
              flush=True)
    del x16, f16

    start, stop = 128, 512
    for post in (None, 'yuv420'):
        _stream_wall(planner, 0, batch, batch, post)
    walls = {None: [], 'yuv420': []}
    for _rep in range(3):
        for post in (None, 'yuv420'):
            walls[post].append(_stream_wall(planner, start, stop, batch,
                                            post))
    print('phase 9 timing: 1080p_10layer_composite_fps_per_chip with '
          'post=yuv420 %.1f beside post=None %.1f (best of 3 cold passes '
          'each, in turns, over frames %d..%d, batch %d; walls %s s and '
          '%s s) %s' % (
              (stop - start) / min(walls['yuv420']),
              (stop - start) / min(walls[None]), start, stop - 1, batch,
              ', '.join('%.4f' % w for w in walls['yuv420']),
              ', '.join('%.4f' % w for w in walls[None]), tag), flush=True)
    return launches


def main():
    sys.meta_path.insert(0, _Refuse())
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms, paired_ms
    from canvas_tpu_torch.ops import _build, cuda_ops
    from canvas_tpu_torch.render import (RenderPlanner, _scale_solid_factors,
                                         box2i, params_to_torch, run)

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device and '
                         'torch.cuda.is_available() is False')
    dev = torch.device('cuda')

    # 1. card
    card = _card_line()
    tag = '[%s]' % card
    kind = torch.cuda.get_device_name(0)
    print(card)
    print('phase 1 card: %s, %d device(s), torch %s, CUDA %s'
          % (kind, torch.cuda.device_count(), torch.__version__,
             torch.version.cuda), flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print('phase 2 build: %.2f s (nvcc %.2f s, cached=%s) -> %s %s'
          % (time.perf_counter() - t0, info['seconds'], info['cached'],
             os.path.relpath(info['path']), tag), flush=True)

    # 3. kernels vs plain on the card, seeded inputs
    rng = np.random.default_rng(SEED)

    def on(*arrays):
        return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]

    H, W = 1080, 1920
    layers = on(*_solid_layers(rng, 6, 8, H, W))
    got = cuda_ops.solid_fold(None, None, *layers, H, W)
    want = cuda_ops.solid_fold_plain(None, None, *layers, H, W)
    err_mid = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if err_mid != 0.0:
        raise AssertionError('solid_fold mid fold differs from plain by %r'
                             % err_mid)
    layers = on(*_solid_layers(rng, 2, 8, H, W))
    A = rng.uniform(0.0, 1.0, (8, 1, H, W)).astype(np.float32)
    P = (rng.uniform(0.0, 1.0, (8, 3, H, W)) * A).astype(np.float32)
    P, A = on(P, A)
    got = cuda_ops.solid_fold(P, A, *layers, H, W, finalize=True,
                              out_dtype=torch.float16)
    want = cuda_ops.solid_fold_plain(P, A, *layers, H, W, finalize=True,
                                     out_dtype=torch.float16)
    err_fin = float((got.float() - want.float()).abs().max())
    if got.dtype != torch.float16 or err_fin != 0.0:
        raise AssertionError('solid_fold finalize (%s) differs from plain '
                             'by %r' % (got.dtype, err_fin))
    err_ro = 0.0
    for (Hf, Wf, h, w, dy0, dx0) in ((H, W, 640, 1024, 448, 896),
                                     (H, W, 704, 1152, 64, 512),
                                     (540, 960, 384, 640, 192, 384)):
        P, A, layer = on(*[rng.uniform(0.0, 1.0, s).astype(np.float32)
                           for s in ((8, 3, Hf, Wf), (8, 1, Hf, Wf),
                                     (8, 4, h, w))])
        P2, A2 = P.clone(), A.clone()
        outP, outA = cuda_ops.region_over(P, A, layer, dy0, dx0)
        cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
        if outP is not P or outA is not A:
            raise AssertionError('region_over did not update in place')
        err_ro = max(err_ro, float((P - P2).abs().max()),
                     float((A - A2).abs().max()))
    if err_ro != 0.0:
        raise AssertionError('region_over differs from plain by %r' % err_ro)
    err_reg = 0.0
    for (Hf, Wf, h, w, dy0, dx0) in ((H, W, 512, 1024, 576, 896),
                                     (540, 960, 384, 640, 192, 384)):
        P, A, color, ry, rx = on(*[
            rng.uniform(0.0, 1.0, s).astype(np.float32)
            for s in ((8, 3, Hf, Wf), (8, 1, Hf, Wf), (8, 4), (8, h),
                      (8, w))])
        P2, A2 = P.clone(), A.clone()
        cuda_ops.region_over_sep(P, A, color, ry, rx, dy0, dx0)
        cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
        err_reg = max(err_reg, float((P - P2).abs().max()),
                      float((A - A2).abs().max()))
    if not err_reg <= 1e-6:
        raise AssertionError('region_over_sep differs from plain by %r'
                             % err_reg)
    print('phase 3 kernels vs plain: solid_fold mid L=6 B=8 1080p max diff '
          '%r, finalize L=2 base f16 max diff %r (both must be 0); '
          'region_over_sep 512x1024 @ (576, 896) of 1080p and 384x640 @ '
          '(192, 384) of 540x960 max diff %.3g (atol 1e-6); region_over '
          '640x1024 @ (448, 896) and 704x1152 @ (64, 512) of 1080p, 384x640 '
          '@ (192, 384) of 540x960, B=8, max diff %r (must be 0) %s'
          % (err_mid, err_fin, err_reg, err_ro, tag), flush=True)
    del P, A, P2, A2, got, want, layers, layer

    # 4. the slice, through the kernels
    ws = timelines.build_timeline(1024)
    window = box2i(*WINDOW)
    H, W = window.height, window.width
    planner = RenderPlanner(ws, window)
    picked = {}
    n_frames = 0
    _zero_launch_counts()
    for s, n, out in planner.iter_batches(0, 256, batch=64):
        if (out.dtype != torch.float16
                or tuple(out.shape) != (n, 4, H, W)
                or not bool(torch.isfinite(out).all())):
            raise AssertionError('batch at %d: %s %s, finite=%s'
                                 % (s, out.dtype, tuple(out.shape),
                                    bool(torch.isfinite(out).all())))
        for i in (0, 130):
            if s <= i < s + n:
                picked[i] = out[i - s].cpu().numpy()
        n_frames += n
    launches = _launch_counts()
    del launches['region_over']         # not on the headline path
    if n_frames != 256 or min(launches.values()) <= 0:
        raise AssertionError('slice rendered %d frames with launches %r'
                             % (n_frames, launches))
    for s, n, out in planner.iter_batches(1000, 1001, batch=64):
        picked[1000] = out[0].cpu().numpy()
    errs = {}
    for i in (0, 130, 1000):
        want = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        errs[i] = float(np.abs(picked[i].astype(np.float32)
                               - want.astype(np.float32)).max())
        if not np.isfinite(picked[i]).all() or errs[i] > 2e-3:
            raise AssertionError('frame %d differs from the pull path by %r'
                                 % (i, errs[i]))
    print('phase 4 slice: 256 frames of the 1080p composite via '
          'iter_batches(0, 256, batch=64), finite f16; launches %s; vs the '
          'NumPy pull path max diff frame 0 %.3g, 130 %.3g, 1000 %.3g '
          '(atol 2e-3) %s' % (json.dumps(launches), errs[0], errs[130],
                              errs[1000], tag), flush=True)

    # 5. timing: cold streaming, device busy time, kernels vs plain
    start, stop, batch = 128, 512, 128
    for _ in planner.iter_batches(0, batch, batch=batch):
        pass
    walls = [_stream_wall(planner, start, stop, batch) for _rep in range(3)]
    wall = min(walls)
    fps = (stop - start) / wall

    # The same batches with planning and copies done beforehand: device
    # time of the render alone, launched back to back.
    work = []
    for seg in planner.segments(start, stop, min_span=batch):
        _s0, sig, batches = planner._prepare(seg, batch)
        for (_pos, _take, plist) in batches:
            work.append((sig, params_to_torch(plist, dev)))
    torch.cuda.synchronize()

    def replay():
        for sig, tparams in work:
            run(sig, tparams, dev)

    busy_ms = cuda_ms(replay, 3)
    idle = 1.0 - busy_ms / (wall * 1e3)
    print('phase 5 timing: 1080p_10layer_composite_fps_per_chip %.1f '
          '(best of 3 cold passes over frames %d..%d, batch %d; walls %s s); '
          'device busy %.3f ms of %.3f ms wall, device idle share %.3f %s'
          % (fps, start, stop - 1, batch,
             ', '.join('%.4f' % w for w in walls), busy_ms, wall * 1e3,
             idle, tag), flush=True)

    # Kernels at the main path's shapes: the first timed batch's params.
    sig, tparams = work[0]
    kids = sig[3]
    idx = 1
    folds, regions = [], []
    for cs in kids:
        if cs[0] == 'solid_stack':
            folds.append(tparams[idx])
            idx += 1
        elif cs[0] == 'placed' and cs[3][0][0].startswith('scale_solid'):
            inner = cs[3][0]
            regions.append((tparams[idx], _scale_solid_factors(
                inner[0], inner[1], tparams[idx + 1])))
            idx += 2
        else:
            raise AssertionError('unexpected headline child %r' % (cs[0],))
    if len(folds) != 2 or len(regions) != 2 or kids[-1][0] != 'solid_stack':
        raise AssertionError('unexpected headline plan: %r'
                             % ([c[0] for c in kids],))
    B = batch

    def fargs(p):
        return p['color'], p['box'], p['gain'], p['offset'], H, W

    mid = lambda: cuda_ops.solid_fold(None, None, *fargs(folds[0]))
    mid_p = lambda: cuda_ops.solid_fold_plain(None, None, *fargs(folds[0]))
    baseP, baseA = mid()
    fin = lambda: cuda_ops.solid_fold(baseP, baseA, *fargs(folds[1]),
                                      finalize=True, out_dtype=torch.float16)
    fin_p = lambda: cuda_ops.solid_fold_plain(
        baseP, baseA, *fargs(folds[1]), finalize=True,
        out_dtype=torch.float16)
    err_main = max([float((g - w).abs().max())
                    for g, w in zip(mid(), mid_p())]
                   + [float((fin().float() - fin_p().float()).abs().max())])
    if err_main != 0.0:
        raise AssertionError('solid_fold at the main path shapes differs '
                             'from plain by %r' % err_main)
    rows = []
    fold_ms = fold_plain_ms = reg_ms = reg_plain_ms = 0.0
    fold_bytes = fold_ops = reg_bytes = reg_ops = 0
    for name, k, p, nbytes, fp in (
            ('mid fold L=6', mid, mid_p, 16, folds[0]),
            ('finalize L=2 f16', fin, fin_p, 24, folds[1])):
        tk, tp = paired_ms(k, p, 10, 2)
        fold_ms += tk
        fold_plain_ms += tp
        rows.append((name, tk, tp, B * H * W * nbytes))
        # the mid fold writes P and A (16 B/px); the finalize reads them
        # and writes f16 frames (24 B/px)
        L = fp['color'].shape[0]
        fold_bytes += B * H * W * nbytes + _fold_params_bytes(L, B)
        fold_ops += B * H * W * (L * FOLD_OPS_PER_LAYER
                                 + (FINALIZE_OPS if nbytes == 24 else 0))
    for j, (pl, (color, ry, rx)) in enumerate(regions):
        dy0, dx0 = pl['dy0'], pl['dx0']
        h, w = ry.shape[1], rx.shape[1]
        P1, A1 = baseP.clone(), baseA.clone()
        P2, A2 = baseP.clone(), baseA.clone()
        cuda_ops.region_over_sep(P1, A1, color, ry, rx, dy0, dx0)
        cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
        err_reg = max(err_reg, float((P1 - P2).abs().max()),
                      float((A1 - A2).abs().max()))
        k = lambda: cuda_ops.region_over_sep(P1, A1, color, ry, rx, dy0, dx0)
        p = lambda: cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx,
                                                   dy0, dx0)
        tk, tp = paired_ms(k, p, 20, 3)
        reg_ms += tk
        reg_plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        rows.append(('region %d %dx%d @ (%d, %d)' % (j, h, w, dy0, dx0),
                     tk, tp, px * 32))
        # P and A read and written in the region; color, ry, rx read
        reg_bytes += px * 32 + B * (4 + h + w) * 4
        reg_ops += px * (RANK1_OPS + OVER_OPS)
    if not err_reg <= 1e-6:
        raise AssertionError('region_over_sep at the main path shapes '
                             'differs from plain by %r' % err_reg)
    for name, tk, tp, nbytes in rows:
        print('phase 5 kernel %s, batch %d: cuda %.4f ms (%.1f GB/s for %.1f '
              'MB), plain torch %.4f ms %s'
              % (name, B, tk, nbytes / tk / 1e6, nbytes / 1e6, tp, tag),
              flush=True)

    del work, baseP, baseA, P1, A1, P2, A2
    torch.cuda.empty_cache()

    # 6-7. the mixed-content path
    mixed, mixed_launches = _mixed_slice(tag, window)
    err_ro_path, ro_ms, ro_plain_ms, ro_bound, ro_by = _mixed_timing(
        tag, mixed, window)

    # 8. the fold studies and the roofline probe
    del mixed
    torch.cuda.empty_cache()
    study_kernels = _studies(tag)

    # 9. the export conversions of the headline
    torch.cuda.empty_cache()
    post_launches = _posts(tag, window)

    total = {k: launches.get(k, 0) + mixed_launches[k] + post_launches[k]
             for k in mixed_launches}
    fold_bound, fold_by = _bound(fold_bytes, fold_ops)
    reg_bound, reg_by = _bound(reg_bytes, reg_ops)
    kernels = [
        {'name': 'solid_fold', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/solid_fold.cu',
         'replaces': 'canvas_tpu/ops/pallas_ops.py:179',
         'launches': total['solid_fold'],
         'max_abs_err': max(err_mid, err_fin, err_main),
         'ms': fold_ms, 'plain_ms': fold_plain_ms,
         'bound_ms': fold_bound, 'bound_by': fold_by, 'library_ms': None},
        {'name': 'region_over_sep', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/region_over_sep.cu',
         'replaces': 'canvas_tpu/ops/pallas_ops.py:375',
         'launches': total['region_over_sep'],
         'max_abs_err': err_reg,
         'ms': reg_ms, 'plain_ms': reg_plain_ms,
         'bound_ms': reg_bound, 'bound_by': reg_by, 'library_ms': None},
        {'name': 'region_over', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/region_over.cu',
         'replaces': 'canvas_tpu/ops/pallas_ops.py:276',
         'launches': total['region_over'],
         'max_abs_err': max(err_ro, err_ro_path),
         'ms': ro_ms, 'plain_ms': ro_plain_ms,
         'bound_ms': ro_bound, 'bound_by': ro_by, 'library_ms': None},
    ] + study_kernels
    for k in kernels:
        print('kernel %s: %d launches, %.4f ms against a bound of %.4f ms '
              '(%s, %.0f%%), plain %.4f ms %s'
              % (k['name'], k['launches'], k['ms'], k['bound_ms'],
                 k['bound_by'], 100 * k['bound_ms'] / k['ms'],
                 k['plain_ms'], tag), flush=True)
    if any(m.split('.')[0] in REFUSED for m in sys.modules):
        raise AssertionError('a refused module was imported: %r' % sorted(
            m for m in sys.modules if m.split('.')[0] in REFUSED))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
