#!/usr/bin/env python3
"""Smoke run of the PyTorch port (canvas_tpu_torch) on one CUDA card.

Drives the port's two render paths on the card, the headline render (a
10-layer 1080p composite streamed by RenderPlanner.iter_batches,
``canvas_tpu_torch.timelines.build_timeline``, bench.py's timeline) and
the mixed-content timeline (``timelines.mixed_timeline``, benchmarks.py
config7's: the headline with three DV clips, decoded on the host and
staged by the port, through animated scalers), then the fold studies and
the roofline probe, then the headline's export conversions, then the
editor's display path (``render_display``, the quality <= 9 tier and the
playback engine). Each phase prints one line or more; any failure raises
(traceback, nonzero exit, no result line):

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernels vs plain: each kernel against its plain PyTorch version on
   the card, on seeded inputs, bit-identical (max diff 0), then each
   quality <= 9 form (bf16 accumulators: solid_fold's mid fold storing
   bf16, from a bf16 base, and its finalize from a bf16 base;
   region_over_sep and region_over in bf16) at the same shapes, then
   solid_fold and region_over_sep in every form at frames whose rows are
   not a multiple of 8 values and through planes that do not start at a
   multiple of 16 bytes (the kernels' scalar instantiation; the shapes
   before took the 16-byte one, some with the region overhanging the
   bottom edge), with the launches of each instantiation counted;
4. headline slice: frames 0..255 of timelines.build_timeline(1024)
   through iter_batches; its kernels'
   launch counters must rise; finite f16 (B, 4, 1080, 1920) batches;
   frames 0, 130 and 1000 against the NumPy pull path at atol 2e-3; and
   frames of timelines.transfer_timeline(1024) (a solid through the
   rec709 -> linear transfer) at 1280x720, bit-equal to the pull path;
5. headline timing: cold streaming fps of frames 128..511 in 128-frame
   batches, the device's busy time for the same batches (device idle
   share), and each kernel pass's time beside its plain version's and
   its own byte floor at the main path's shapes;
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
   protocol;
10. display path, on the headline at 1080p: ``render_display`` of frames
   0, 130 and 1000 through the u8 (intent None and 1.25), rgb24 and
   yuv420 transports, at full size and at 960x540, each against a
   ``device='cpu'`` planner's pull (at most 1 on at most 0.1% of u8
   values); ``render_display_1080p_warm_ms`` (p50, p95 of frames 1..63
   of a cached segment) and ``render_display_1080p_cold_ms`` (the first
   frame of 8 uncached 64-frame segments), rgb24 at full size and at
   960x540; the quality tier: frames 128..255 at quality 9 through
   iter_batches(batch=128) against quality 10 (max 0.01, mean 1e-3) and
   frames 128 and 200 of the same plan on the CPU (2e-3), frames 0 and 70
   of the mixed timeline at quality 5 against the CPU (1e-2), and the
   bf16 forms' times beside their plain versions at the tier's shapes;
   playback: a ``VideoPlaybackEngine`` on a ``SystemPresentationClock`` at
   60 fps, warmed, playing for 3 s, three times (full size, a 960x540
   viewport, quality 5 in that viewport), with its presented frames
   against the ideal count, the skipped indices and the mean batch time,
   then one batch taken apart (render, conversion, fetch, host unpack).

Each path (the headline, the mixed timeline, the studies' timing runs,
the export posts, the display path) runs with every launch counter set
to 0 just before it and read just after; the kernels line reports each
kernel's launches in those runs, its time, its plain version's, and its
bound: the larger of the bytes it must move over the card's published
memory rate and its f32 operations over the published f32 rate
(PEAK_BYTES_PER_S, PEAK_F32_PER_S), from this run's shapes. The bf16
form of each render kernel has an entry of its own. No single PyTorch
call computes what any of the kernels computes, so ``library_ms`` is
null throughout.
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
#: layer ((c*ry)*rx for four channels, 8) before its over step (12); the
#: FMA chain does 2 per step and element.
FOLD_OPS_PER_LAYER = 10
FINALIZE_OPS = 3
OVER_OPS = 12
RANK1_OPS = 8


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


#: The render kernels; each has an f32 and a bf16 (quality <= 9) form,
#: counted apart ('<name>' and '<name>_bf16').
_RENDER_KERNELS = ('solid_fold', 'region_over_sep', 'region_over')


def _launch_counts():
    from canvas_tpu_torch.ops import cuda_ops
    out = {}
    for name in _RENDER_KERNELS:
        fn = getattr(cuda_ops, name)
        out[name] = fn.launches
        out[name + '_bf16'] = fn.launches_bf16
    return out


_STUDY_WRAPPERS = ('fold_variant', 'tile_fold', 'fma_chain', 'roofline_fold')


def _study_launch_counts():
    from canvas_tpu_torch.ops import study_ops
    return {name: getattr(study_ops, name).launches
            for name in _STUDY_WRAPPERS}


def _zero_launch_counts():
    from canvas_tpu_torch.ops import cuda_ops, study_ops
    for name in _RENDER_KERNELS:
        getattr(cuda_ops, name).launches = 0
        getattr(cuda_ops, name).launches_bf16 = 0
    for name in _STUDY_WRAPPERS:
        getattr(study_ops, name).launches = 0


def _max_diff(got, want):
    """Largest |got - want| over paired tensors (any float dtype)."""
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def _bf16_forms_vs_plain(rng, on, H, W):
    """Phase 3's bf16 half: each quality <= 9 form of the render kernels
    against its plain version on seeded inputs at phase 3's shapes.
    Returns {form: max diff}."""
    import numpy as np
    import torch

    from canvas_tpu_torch.ops import cuda_ops

    bf = torch.bfloat16

    def bf16(*arrays):
        return [t.to(bf) for t in on(*arrays)]

    err = {}
    layers = on(*_solid_layers(rng, 6, 8, H, W))
    err['solid_fold mid'] = _max_diff(
        cuda_ops.solid_fold(None, None, *layers, H, W, acc_dtype=bf),
        cuda_ops.solid_fold_plain(None, None, *layers, H, W, acc_dtype=bf))
    layers = on(*_solid_layers(rng, 2, 8, H, W))
    A = rng.uniform(0.0, 1.0, (8, 1, H, W)).astype(np.float32)
    P, A = bf16((rng.uniform(0.0, 1.0, (8, 3, H, W)) * A).astype(np.float32),
                A)
    err['solid_fold mid over base'] = _max_diff(
        cuda_ops.solid_fold(P, A, *layers, H, W, acc_dtype=bf),
        cuda_ops.solid_fold_plain(P, A, *layers, H, W, acc_dtype=bf))
    got = cuda_ops.solid_fold(P, A, *layers, H, W, finalize=True,
                              out_dtype=torch.float16)
    if got.dtype != torch.float16:
        raise AssertionError('solid_fold finalize stored %s' % got.dtype)
    err['solid_fold finalize'] = _max_diff([got], [
        cuda_ops.solid_fold_plain(P, A, *layers, H, W, finalize=True,
                                  out_dtype=torch.float16)])
    err['region_over_sep'] = err['region_over'] = 0.0
    for kind, shapes in (
            ('region_over_sep', ((H, W, 512, 1024, 576, 896),
                                 (540, 960, 384, 640, 192, 384))),
            ('region_over', ((H, W, 640, 1024, 448, 896),
                             (H, W, 704, 1152, 64, 512),
                             (540, 960, 384, 640, 192, 384)))):
        for (Hf, Wf, h, w, dy0, dx0) in shapes:
            P, A = bf16(*[rng.uniform(0.0, 1.0, s).astype(np.float32)
                          for s in ((8, 3, Hf, Wf), (8, 1, Hf, Wf))])
            if kind == 'region_over':
                args = bf16(rng.uniform(0.0, 1.0, (8, 4, h, w)).astype(
                    np.float32))
            else:
                args = on(*[rng.uniform(0.0, 1.0, s).astype(np.float32)
                            for s in ((8, 4), (8, h), (8, w))])
            P2, A2 = P.clone(), A.clone()
            outP, outA = getattr(cuda_ops, kind)(P, A, *args, dy0, dx0)
            getattr(cuda_ops, kind + '_plain')(P2, A2, *args, dy0, dx0)
            if outP is not P or P.dtype != bf:
                raise AssertionError('%s bf16 did not update in place' % kind)
            err[kind] = max(err[kind], _max_diff((P, A), (P2, A2)))
    return err


def _instantiation_counts():
    """Launches of the 16-byte and the scalar instantiation of the two
    kernels that have both."""
    from canvas_tpu_torch.ops import cuda_ops
    return {name: (getattr(cuda_ops, name).launches_vector,
                   getattr(cuda_ops, name).launches_scalar)
            for name in ('solid_fold', 'region_over_sep')}


def _offset_view(t):
    """A contiguous copy of *t* that starts one value into its storage,
    so its data_ptr() is not a multiple of 16."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _scalar_forms_vs_plain(rng, on):
    """Phase 3's last part: solid_fold (mid fold and finalize, empty, f32
    and bf16 base) and region_over_sep (f32, bf16) against their plain
    versions where the 16-byte instantiation cannot run: a 270x481 and a
    150x300 frame (rows not a multiple of 8 values; the region overhangs
    both edges) and a 96x256 frame whose planes start one value into
    their storage. Returns the largest difference (must be 0)."""
    import numpy as np
    import torch

    from canvas_tpu_torch.ops import cuda_ops

    bf = torch.bfloat16
    err = 0.0
    for H, W, shift in ((270, 481, False), (96, 256, True)):
        layers = on(*_solid_layers(rng, 4, 3, H, W))
        A = rng.uniform(0.0, 1.0, (3, 1, H, W)).astype(np.float32)
        P, A = on((rng.uniform(0.0, 1.0, (3, 3, H, W)) * A).astype(
            np.float32), A)
        for base in (None, torch.float32, bf):
            if base is None and shift:
                continue            # no plane to shift: the 16-byte form
            bP = bA = None
            if base is not None:
                bP, bA = P.to(base), A.to(base)
                if shift:
                    bP, bA = _offset_view(bP), _offset_view(bA)
            for kw in ({}, {'acc_dtype': bf},
                       {'finalize': True, 'out_dtype': torch.float16}):
                got = cuda_ops.solid_fold(bP, bA, *layers, H, W, **kw)
                want = cuda_ops.solid_fold_plain(bP, bA, *layers, H, W, **kw)
                if kw.get('finalize'):
                    got, want = [got], [want]
                err = max(err, _max_diff(got, want))
    for H, W, h, w, dy0, dx0, shift in ((150, 300, 128, 256, 64, 128, False),
                                        (96, 256, 64, 128, 64, 128, True)):
        for dtype in (torch.float32, bf):
            P, A = [t.to(dtype) for t in on(*[
                rng.uniform(0.0, 1.0, s).astype(np.float32)
                for s in ((3, 3, H, W), (3, 1, H, W))])]
            if shift:
                P, A = _offset_view(P), _offset_view(A)
            args = on(*[rng.uniform(0.0, 1.0, s).astype(np.float32)
                        for s in ((3, 4), (3, h), (3, w))])
            P2, A2 = P.clone(), A.clone()
            cuda_ops.region_over_sep(P, A, *args, dy0, dx0)
            cuda_ops.region_over_sep_plain(P2, A2, *args, dy0, dx0)
            err = max(err, _max_diff((P, A), (P2, A2)))
    return err


def _transfer_clip(tag):
    """Phase 4's last line: frames 300..303 of the config1-like clip
    (timelines.transfer_timeline: a ramping solid through rec709 ->
    linear, the color filter's 'transfer' op) at 1280x720 against the
    NumPy pull path, bit-equal."""
    import numpy as np

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i

    src = timelines.transfer_timeline(1024)
    window = box2i(0, 0, 1279, 719)
    got = RenderPlanner(src, window).render(300, 304)
    want = np.stack([np.asarray(src.get_frame_f16(i, window).data,
                                np.float16) for i in range(300, 304)])
    share = _bit_share(got, want)
    print('phase 4 transfer clip: frames 300..303 of '
          'timelines.transfer_timeline(1024) at 1280x720, finite=%s, %.5f '
          'of f16 values bit-equal to the NumPy pull path (must be 1) %s'
          % (bool(np.isfinite(got).all()), share, tag), flush=True)
    if got.shape != (4, 4, 720, 1280) or share != 1.0:
        raise AssertionError('the transfer clip differs from the pull path '
                             '(%r, %.5f bit-equal)' % (got.shape, share))


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
    if n_frames != 128 or min(launches[k] for k in _RENDER_KERNELS) <= 0:
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


#: Phase 10's display comparisons: frames, (transport, intent), viewport.
DISPLAY_FRAMES = (0, 130, 1000)
DISPLAY_CASES = (('u8', None), ('u8', 1.25), ('rgb24', 1.25),
                 ('yuv420', 1.25))
VIEWPORT = (960, 540)


def _display_vs_cpu(tag, ws, window):
    """Phase 10.1: render_display on the card against a CPU planner's, for
    every frame, transport and size of DISPLAY_*."""
    import numpy as np

    from canvas_tpu_torch.render import RenderPlanner

    card = RenderPlanner(ws, window)
    cpu = RenderPlanner(ws, window, device='cpu')
    worst_diff, worst_share, n = 0, 0.0, 0
    for f in DISPLAY_FRAMES:
        for transport, intent in DISPLAY_CASES:
            for size in (None, VIEWPORT):
                kw = dict(intent=intent, display_size=size,
                          transport=transport)
                got = card.render_display(f, **kw).astype(np.int32)
                want = cpu.render_display(f, **kw).astype(np.int32)
                w, h = size or (window.width, window.height)
                if got.shape != (h, w, 4) or want.shape != got.shape:
                    raise AssertionError('render_display %d %r: %s vs %s'
                                         % (f, kw, got.shape, want.shape))
                d = np.abs(got - want)
                share = float(np.mean(d != 0))
                if d.max() > 1 or share > 1e-3:
                    raise AssertionError(
                        'render_display %d %r differs from the CPU by up to '
                        '%d on %.3g of u8 values' % (f, kw, d.max(), share))
                worst_diff = max(worst_diff, int(d.max()))
                worst_share = max(worst_share, share)
                n += 1
    print('phase 10 render_display vs the CPU: frames %s, transports %s, '
          'full size and %dx%d (%d pulls): max |diff| %d, largest share of '
          'u8 values that differ %.3g (at most 1 on at most 0.1%%) %s'
          % (list(DISPLAY_FRAMES), ['%s intent=%s' % c for c in DISPLAY_CASES],
             VIEWPORT[0], VIEWPORT[1], n, worst_diff, worst_share, tag),
          flush=True)


def _display_latency(tag, ws, window):
    """Phase 10.2: single-frame latency of render_display (rgb24), warm
    (frames 1..63 of the cached segment [1, 64)) and cold (the first
    frame of 8 uncached 64-frame segments), at full size and at
    VIEWPORT. Returns {size: (warm p50, p95, cold p50, p95, bytes)}."""
    import numpy as np

    from canvas_tpu_torch.render import RenderPlanner

    planner = RenderPlanner(ws, window)
    out = {}
    for size in (None, VIEWPORT):
        kw = dict(transport='rgb24', display_size=size)
        planner.render_display(1, **kw)         # plans and uploads [1, 64)

        def pull(i):
            t0 = time.perf_counter()
            planner.render_display(i, **kw)
            return (time.perf_counter() - t0) * 1e3

        warm = [pull(i) for i in range(1, 64)]
        cold = [pull(64 * k) for k in range(1, 9)]
        w, h = size or (window.width, window.height)
        out[size] = (float(np.percentile(warm, 50)),
                     float(np.percentile(warm, 95)),
                     float(np.percentile(cold, 50)),
                     float(np.percentile(cold, 95)), h * w * 3)
        print('phase 10 latency rgb24 %dx%d: render_display_1080p_warm_ms '
              'p50 %.3f p95 %.3f (frames 1..63, segment cached); '
              'render_display_1080p_cold_ms p50 %.3f p95 %.3f (first frame '
              'of 8 uncached 64-frame segments: %s); %d bytes fetched per '
              'frame (host clock, each pull ends in its copy to the host) %s'
              % ((w, h) + out[size][:4]
                 + (', '.join('%.2f' % c for c in cold), h * w * 3, tag)),
              flush=True)
    return out


def _bf16_timings(tag, p9, mixed5, window):
    """The bf16 forms at the quality tier's shapes: solid_fold's mid fold
    and finalize and both rank-1 regions of the first quality-9 headline
    batch (128 frames), region_over at the three DV regions of the
    quality-5 mixed batch of segment [1, 65) (16 frames); each against
    its plain version (max diff, must be 0) and timed beside it. Returns
    {form: (max diff, ms, plain ms, bound ms, bound by)}."""
    import numpy as np
    import torch

    from canvas_tpu_torch.backend import paired_ms
    from canvas_tpu_torch.ops import cuda_ops
    from canvas_tpu_torch.render import _scale_solid_factors, params_to_torch

    dev = p9.device
    bf = torch.bfloat16
    H, W = window.height, window.width
    _s, sig, batches = p9._prepare((128, 256), 128)
    tparams = params_to_torch(batches[0][2], dev)
    B = 128
    folds, regions = [], []
    for cs, cp in _children_params(sig, tparams):
        if cs[0] == 'solid_stack':
            folds.append(cp[0])
        elif cs[0] == 'placed' and cs[3][0][0].startswith('scale_solid'):
            inner = cs[3][0]
            regions.append((cp[0], _scale_solid_factors(inner[0], inner[1],
                                                        cp[1])))
    if len(folds) != 2 or len(regions) != 2:
        raise AssertionError('unexpected quality-9 headline plan')

    def fargs(p):
        return p['color'], p['box'], p['gain'], p['offset'], H, W

    out = {}
    mid = lambda: cuda_ops.solid_fold(None, None, *fargs(folds[0]),
                                      acc_dtype=bf)
    mid_p = lambda: cuda_ops.solid_fold_plain(None, None, *fargs(folds[0]),
                                              acc_dtype=bf)
    baseP, baseA = mid()
    fin = lambda: cuda_ops.solid_fold(baseP, baseA, *fargs(folds[1]),
                                      finalize=True, out_dtype=torch.float16)
    fin_p = lambda: cuda_ops.solid_fold_plain(
        baseP, baseA, *fargs(folds[1]), finalize=True,
        out_dtype=torch.float16)
    err = max(_max_diff(mid(), mid_p()), _max_diff([fin()], [fin_p()]))
    ms = plain_ms = 0.0
    nbytes = ops = 0
    for name, k, p, per_px, fp in (('mid fold L=6 bf16', mid, mid_p, 8,
                                    folds[0]),
                                   ('finalize L=2 bf16 base to f16', fin,
                                    fin_p, 16, folds[1])):
        tk, tp = paired_ms(k, p, 10, 2)
        ms += tk
        plain_ms += tp
        L = fp['color'].shape[0]
        # the mid fold writes bf16 P and A (8 B/px); the finalize reads
        # them and writes f16 frames (16 B/px)
        nbytes += B * H * W * per_px + _fold_params_bytes(L, B)
        ops += B * H * W * (L * FOLD_OPS_PER_LAYER
                            + (FINALIZE_OPS if per_px == 16 else 0))
        floor = _bound(B * H * W * per_px, 0)[0]
        print('phase 10 kernel solid_fold %s, batch %d: cuda %.4f ms (%.1f '
              'GB/s for %.1f MB; byte floor %.4f ms, time / floor %.2f), '
              'plain torch %.4f ms %s'
              % (name, B, tk, B * H * W * per_px / tk / 1e6,
                 B * H * W * per_px / 1e6, floor, tk / floor, tp, tag),
              flush=True)
    out['solid_fold_bf16'] = (err, ms, plain_ms) + _bound(nbytes, ops)

    err = ms = plain_ms = 0.0
    nbytes = ops = 0
    for j, (pl, (color, ry, rx)) in enumerate(regions):
        dy0, dx0 = pl['dy0'], pl['dx0']
        h, w = ry.shape[1], rx.shape[1]
        P1, A1 = baseP.clone(), baseA.clone()
        P2, A2 = baseP.clone(), baseA.clone()
        cuda_ops.region_over_sep(P1, A1, color, ry, rx, dy0, dx0)
        cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
        err = max(err, _max_diff((P1, A1), (P2, A2)))
        k = lambda: cuda_ops.region_over_sep(P1, A1, color, ry, rx, dy0, dx0)
        p = lambda: cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx,
                                                   dy0, dx0)
        tk, tp = paired_ms(k, p, 20, 3)
        ms += tk
        plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        # bf16 P and A read and written in the region (16 B/px); color,
        # ry, rx read
        nbytes += px * 16 + B * (4 + h + w) * 4
        ops += px * (RANK1_OPS + OVER_OPS)
        floor = _bound(px * 16, 0)[0]
        print('phase 10 kernel region_over_sep bf16 region %d %dx%d @ (%d, '
              '%d), batch %d: cuda %.4f ms (%.1f GB/s for %.1f MB; byte '
              'floor %.4f ms, time / floor %.2f), plain torch %.4f ms %s'
              % (j, h, w, dy0, dx0, B, tk, px * 16 / tk / 1e6, px * 16 / 1e6,
                 floor, tk / floor, tp, tag), flush=True)
    out['region_over_sep_bf16'] = (err, ms, plain_ms) + _bound(nbytes, ops)
    del baseP, baseA, P1, A1, P2, A2, tparams
    torch.cuda.empty_cache()

    _s, sig, batches = mixed5._prepare((1, 65), 16)
    tparams = params_to_torch(batches[0][2], dev)
    shapes = [(cs[1], cp[0]['dy0'], cp[0]['dx0'])
              for cs, cp in _children_params(sig, tparams)
              if cs[0] == 'placed'
              and not cs[3][0][0].startswith('scale_solid')]
    if len(shapes) != 3:
        raise AssertionError('expected 3 DV regions, got %r' % (shapes,))
    rng = np.random.default_rng(SEED + 10)
    B = 16
    err = ms = plain_ms = 0.0
    px_all = 0
    for (h, w), dy0, dx0 in shapes:
        P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)).to(dev).to(bf) for s in ((B, 3, H, W), (B, 1, H, W),
                                                  (B, 4, h, w))]
        P2, A2 = P.clone(), A.clone()
        cuda_ops.region_over(P, A, layer, dy0, dx0)
        cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
        err = max(err, _max_diff((P, A), (P2, A2)))
        k = lambda: cuda_ops.region_over(P, A, layer, dy0, dx0)
        p = lambda: cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
        tk, tp = paired_ms(k, p, 20, 3)
        ms += tk
        plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        px_all += px
        print('phase 10 kernel region_over bf16 %dx%d @ (%d, %d), batch %d: '
              'cuda %.4f ms (%.1f GB/s for %.1f MB), plain torch %.4f ms %s'
              % (h, w, dy0, dx0, B, tk, px * 24 / tk / 1e6, px * 24 / 1e6,
                 tp, tag), flush=True)
    # per pixel: the bf16 layer read (8 B), P and A read and written (16 B)
    out['region_over_bf16'] = (err, ms, plain_ms) + _bound(px_all * 24,
                                                           px_all * OVER_OPS)
    bad = {k: v[0] for k, v in out.items() if v[0] != 0.0}
    if bad:
        raise AssertionError('bf16 forms at the tier shapes differ from '
                             'plain: %r' % bad)
    return out


def _quality_tier(tag, ws, window):
    """Phase 10.3: the headline at quality 9 on the card against quality
    10 and against the CPU on the same plan; the mixed timeline at
    quality 5 against the CPU. Returns the two planners (quality-9
    headline, quality-5 mixed) for _bf16_timings."""
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, params_to_torch, run

    cpu = torch.device('cpu')
    H, W = window.height, window.width
    p9 = RenderPlanner(ws, window, quality=9)
    p10 = RenderPlanner(ws, window)
    (s9, n9, o9), = p9.iter_batches(128, 256, batch=128)
    (s10, _n, o10), = p10.iter_batches(128, 256, batch=128)
    if (s9, n9) != (128, 128) or tuple(o9.shape) != (128, 4, H, W):
        raise AssertionError('quality 9 batch %r %s' % ((s9, n9), o9.shape))
    if not bool(torch.isfinite(o9).all()):
        raise AssertionError('quality 9 frames are not finite')
    d = (o9.float() - o10.float()).abs()
    vs10 = (float(d.max()), float(d.mean()))
    del d, o10
    cpu9 = RenderPlanner(ws, window, quality=9, device='cpu')
    s0, sig, batches = cpu9._prepare((128, 256), 1)
    vs_cpu = {}
    for pos, _take, plist in batches:
        if s0 + pos in (128, 200):
            want = run(sig, params_to_torch(plist, cpu), cpu)[0].float()
            vs_cpu[s0 + pos] = float((o9[pos].cpu().float()
                                      - want).abs().max())
    del o9
    print('phase 10 quality 9: headline frames 128..255 via '
          'iter_batches(batch=128) against quality 10 max |diff| %.5f, mean '
          '%.3g (max 0.01, mean 1e-3); against the CPU on the same plan, '
          'frame 128 %.3g, 200 %.3g (2e-3) %s'
          % (vs10 + (vs_cpu[128], vs_cpu[200], tag)), flush=True)
    if vs10[0] > 0.01 or vs10[1] > 1e-3 or max(vs_cpu.values()) > 2e-3:
        raise AssertionError('quality 9 off: vs quality 10 %r, vs CPU %r'
                             % (vs10, vs_cpu))

    mixed = timelines.mixed_timeline(256)
    card5 = RenderPlanner(mixed, window, quality=5)
    cpu5 = RenderPlanner(mixed, window, quality=5, device='cpu')
    errs = {}
    for f in (0, 70):
        got = card5.render(f, f + 1)[0].astype(np.float32)
        want = cpu5.render(f, f + 1)[0].astype(np.float32)
        if not np.isfinite(got).all():
            raise AssertionError('mixed quality 5 frame %d is not finite' % f)
        errs[f] = float(np.abs(got - want).max())
    print('phase 10 quality 5: mixed frames 0 and 70 (lq taps, bf16 '
          'accumulators) finite, against the CPU max |diff| %.3g and %.3g '
          '(1e-2) %s' % (errs[0], errs[70], tag), flush=True)
    if max(errs.values()) > 1e-2:
        raise AssertionError('mixed quality 5 differs from the CPU: %r'
                             % errs)
    return p9, card5


def _playback(tag, ws, window):
    """Phase 10.4: a VideoPlaybackEngine on the headline, 60 fps, warmed,
    playing 3 s on a SystemPresentationClock: at full size, with a
    VIEWPORT viewport, and at quality 5 in that viewport (an editor drops
    to preview quality while the user drags in its widget; at full 1080p
    the host's yuv420 unpack alone takes most of a 4-frame period, which
    _playback_breakdown shows). Raises if the presented indices do not
    increase, if fewer than half of the ideal frames were presented, or
    if the engine logged a failed batch. Returns [(label, presented,
    ideal, skipped, batches, mean batch ms)]."""
    import logging
    from fractions import Fraction

    import numpy as np

    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.playback import VideoPlaybackEngine
    from canvas_tpu_torch.process import get_time_frame

    class Timed(VideoPlaybackEngine):
        """Records the wall time of every render batch."""

        def __init__(self, *args, **kwargs):
            self.batch_ms = []
            super().__init__(*args, **kwargs)

        def _render_batch(self, start, stop):
            t0 = time.perf_counter()
            try:
                return super()._render_batch(start, stop)
            finally:
                self.batch_ms.append((time.perf_counter() - t0) * 1e3)

    class Failures(logging.Handler):
        def __init__(self):
            super().__init__()
            self.seen = []

        def emit(self, record):
            if 'render batch failed' in record.getMessage():
                self.seen.append(record)

    rate, seconds = Fraction(60, 1), 3.0
    failures = Failures()
    logger = logging.getLogger('canvas_tpu_torch.playback')
    logger.addHandler(failures)
    out = []
    try:
        for label, setup in (('full size', {}),
                             ('viewport %dx%d' % VIEWPORT,
                              {'set_viewport': VIEWPORT}),
                             ('quality 5, viewport %dx%d' % VIEWPORT,
                              {'set_viewport': VIEWPORT,
                               'set_quality': 5})):
            presented = []
            clock = SystemPresentationClock()
            engine = Timed(ws, clock, rate, window,
                           lambda i, frame: presented.append(i))
            try:
                for name, value in setup.items():
                    getattr(engine, name)(value)
                engine.warm(0)
                clock.play(1)
                time.sleep(seconds)
                clock.stop()
                last = get_time_frame(rate, clock.get_presentation_time())
            finally:
                engine.stop()
            shown = list(presented)
            ideal = last + 1
            skipped = sorted(set(range(ideal)) - set(shown))
            mean_ms = float(np.mean(engine.batch_ms))
            out.append((label, len(shown), ideal, skipped,
                        len(engine.batch_ms), mean_ms))
            print('phase 10 playback %s: %d of %d ideal frames presented (60 '
                  'fps, %.0f s of clock), %d skipped %s; %d render batches of '
                  '%d, mean %.2f ms %s'
                  % (label, len(shown), ideal, seconds, len(skipped),
                     skipped[:12] + (['...'] if len(skipped) > 12 else []),
                     len(engine.batch_ms), engine.batch, mean_ms, tag),
                  flush=True)
            if any(a >= b for a, b in zip(shown, shown[1:])):
                raise AssertionError('playback %s presented %r' % (label,
                                                                   shown))
            if 2 * len(shown) < ideal:
                raise AssertionError('playback %s presented %d of %d frames'
                                     % (label, len(shown), ideal))
            if failures.seen:
                raise AssertionError('playback %s: %s' % (
                    label, failures.seen[0].getMessage()))
    finally:
        logger.removeHandler(failures)
    return out


def _playback_breakdown(tag, ws, window):
    """Phase 10.4's batch (4 frames from frame 8) taken apart on the host
    clock, each step ending in a synchronize, median of 5: the render,
    the display conversion on the card, the fetch (pinned, beside a
    plain ``.cpu()``) and the host unpack, at quality 10 (rgb24) and 5
    (yuv420)."""
    import numpy as np
    import torch

    from canvas_tpu_torch.backend import to_host
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.render import RenderPlanner

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    H, W = window.height, window.width
    for quality in (10, 5):
        planner = RenderPlanner(ws, window, quality=quality)
        data = planner.render(8, 12, device_out=True)
        if quality > 5:
            convert = lambda: color_ops.display_u8(data, 1.25, (2, 1, 0))
            unpack = lambda host: color_ops.rgb24_unpack(host)
        else:
            convert = lambda: color_ops.yuv420_pack(data, 1.25)
            unpack = lambda host: color_ops.yuv420_unpack_batch(host, H, W)
        packed = convert()
        host = to_host(packed)
        steps = (('render', ms(lambda: planner.render(8, 12,
                                                      device_out=True))),
                 ('convert', ms(convert)),
                 ('fetch pinned', ms(lambda: to_host(packed))),
                 ('fetch .cpu()', ms(lambda: packed.cpu())),
                 ('unpack', ms(lambda: unpack(host))))
        print('phase 10 playback batch at quality %d (4 frames, %.1f MB '
              'fetched): %s ms %s' % (quality, packed.numel() / 1e6, ', '.join(
                  '%s %.2f' % kv for kv in steps), tag), flush=True)


def _display_path(tag, window):
    """Phase 10, the editor's display path, with the launch counters zeroed
    before and read after; then the bf16 forms' timings (whose launches
    count nowhere). Returns (launches, the bf16 timings)."""
    import torch

    from canvas_tpu_torch import timelines

    ws = timelines.build_timeline(1024)
    _zero_launch_counts()
    _display_vs_cpu(tag, ws, window)
    seen = _launch_counts()
    if min(seen['solid_fold'], seen['region_over_sep']) <= 0:
        raise AssertionError('render_display ran with launches %r' % seen)
    _display_latency(tag, ws, window)
    torch.cuda.empty_cache()
    p9, mixed5 = _quality_tier(tag, ws, window)
    torch.cuda.empty_cache()
    _playback(tag, ws, window)
    _playback_breakdown(tag, ws, window)
    launches = _launch_counts()
    print('phase 10 display path: launches %s %s' % (json.dumps(launches),
                                                    tag), flush=True)
    if min(launches[k + '_bf16'] for k in _RENDER_KERNELS) <= 0:
        raise AssertionError('a bf16 form did not launch on the display '
                             'path: %r' % launches)
    torch.cuda.empty_cache()
    return launches, _bf16_timings(tag, p9, mixed5, window)


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
    inst0 = _instantiation_counts()

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
    if err_reg != 0.0:
        raise AssertionError('region_over_sep differs from plain by %r'
                             % err_reg)
    print('phase 3 kernels vs plain: solid_fold mid L=6 B=8 1080p max diff '
          '%r, finalize L=2 base f16 max diff %r; region_over_sep 512x1024 '
          '@ (576, 896) of 1080p and 384x640 @ (192, 384) of 540x960 max '
          'diff %r; region_over 640x1024 @ (448, 896) and 704x1152 @ (64, '
          '512) of 1080p, 384x640 @ (192, 384) of 540x960, B=8, max diff %r '
          '(all must be 0) %s'
          % (err_mid, err_fin, err_reg, err_ro, tag), flush=True)
    del P, A, P2, A2, got, want, layers, layer
    err16 = _bf16_forms_vs_plain(rng, on, H, W)
    print('phase 3 bf16 forms vs plain (quality <= 9: bf16 accumulators, '
          'f32 math): solid_fold mid L=6 B=8 1080p storing bf16, mid L=2 '
          'over a bf16 base, finalize L=2 from a bf16 base to f16, '
          'region_over_sep and region_over in bf16 at the shapes above, max '
          'diff %s (all must be 0) %s' % (json.dumps(err16), tag), flush=True)
    if any(err16.values()):
        raise AssertionError('a bf16 form differs from plain: %r' % err16)
    inst1 = _instantiation_counts()
    err_scalar = _scalar_forms_vs_plain(rng, on)
    inst2 = _instantiation_counts()
    by_inst = {k: {'above': [inst1[k][i] - inst0[k][i] for i in (0, 1)],
                   'here': [inst2[k][i] - inst1[k][i] for i in (0, 1)]}
               for k in inst0}
    print('phase 3 instantiations: solid_fold (empty, f32 and bf16 base; '
          'mid f32, mid bf16, finalize f16) at 270x481 and through shifted '
          'planes at 96x256, region_over_sep (f32, bf16) 128x256 @ (64, 128) '
          'of 150x300 and 64x128 @ (64, 128) of shifted 96x256 planes, B=3, '
          'max diff %r (must be 0); launches [16-byte, scalar] in the checks '
          'above and here: %s %s' % (err_scalar, json.dumps(by_inst), tag),
          flush=True)
    if err_scalar != 0.0:
        raise AssertionError('a scalar instantiation differs from plain by '
                             '%r' % err_scalar)
    for k, v in by_inst.items():
        if v['above'][0] <= 0 or v['above'][1] != 0 or v['here'][1] <= 0:
            raise AssertionError('%s: the 16-byte instantiation must run in '
                                 'the checks above and the scalar one here: '
                                 '%r' % (k, by_inst))

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
    if n_frames != 256 or min(launches['solid_fold'],
                              launches['region_over_sep']) <= 0:
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

    _transfer_clip(tag)

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
    if err_reg != 0.0:
        raise AssertionError('region_over_sep at the main path shapes '
                             'differs from plain by %r' % err_reg)
    for name, tk, tp, nbytes in rows:
        floor = _bound(nbytes, 0)[0]
        print('phase 5 kernel %s, batch %d: cuda %.4f ms (%.1f GB/s for %.1f '
              'MB; byte floor %.4f ms, time / floor %.2f), plain torch %.4f '
              'ms %s' % (name, B, tk, nbytes / tk / 1e6, nbytes / 1e6, floor,
                         tk / floor, tp, tag), flush=True)

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

    # 10. the editor's display path
    torch.cuda.empty_cache()
    display_launches, bf16 = _display_path(tag, window)

    total = {k: (launches[k] + mixed_launches[k] + post_launches[k]
                 + display_launches[k]) for k in mixed_launches}
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
    ] + [
        {'name': name + '_bf16', 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/%s.cu' % name,
         'replaces': 'canvas_tpu/ops/pallas_ops.py:%d' % line,
         'launches': total[name + '_bf16'],
         'max_abs_err': max([bf16[name + '_bf16'][0]]
                            + [err16[k] for k in keys]),
         'ms': bf16[name + '_bf16'][1], 'plain_ms': bf16[name + '_bf16'][2],
         'bound_ms': bf16[name + '_bf16'][3],
         'bound_by': bf16[name + '_bf16'][4], 'library_ms': None}
        for name, line, keys in (
            ('solid_fold', 179, ('solid_fold mid', 'solid_fold mid over base',
                                 'solid_fold finalize')),
            ('region_over_sep', 375, ('region_over_sep',)),
            ('region_over', 276, ('region_over',)))
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
