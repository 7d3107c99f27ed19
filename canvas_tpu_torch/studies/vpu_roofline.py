"""Roofline of the card for the solid fold: the port's counterpart of
``scripts/vpu_roofline.py``.

Measures, on a (B, 4, 1088, 1920) f32 image with CUDA events:

1. bandwidth: a plain device-to-device copy of the image, and the
   ``fma_chain`` kernel with k=8 (read + write of the whole image);
2. the FMA rate: the slope ``(t(k2) - t(k1)) / (k2 - k1)`` of the chain
   (an FFMA counted as 2 flops), with the SM clock sampled while it
   runs. The script's pair (8, 40) is timed too, but on this card both
   are bound by bytes (k=40 needs well under half the time of its
   reads and writes in FFMA), so the rate comes from k = 256 and 1024;
3. the probe's 6-layer fold over the image in the select and the
   multiplicative-indicator form (``roofline_fold``), each beside its
   plain version;
4. what bounds the shipped ``cuda_ops.solid_fold`` at B=32 and 1080p:
   the mid fold (L=6, no base, f32 accumulators) and the finalize (L=2
   over a base, f16 out), each against the bytes it moves over the
   measured bandwidth, and its instructions per pixel (parts counted in
   the SASS, ``SOLID_FOLD_SASS``, put together for the layers each tile
   of this run's boxes lists) over two rates: the assumed issue ceiling
   at the sampled clock (not measured) and the FMA chain's measured
   rate. A pass is bound by bytes when its byte time is at least
   ``BOUND_SHARE`` of its time, by instructions when its instructions at
   the chain's measured rate take between ``BOUND_SHARE`` and all of
   it; otherwise the bound is not settled.

The TPU script's R-difference timing worked around its host link and is
not carried over. Its grid (``H // 256`` x ``W // 512``) left 24.7% of
each 1088x1920 plane unwritten while its byte count took the whole
plane; the kernels here cover the whole plane and the bytes counted are
the bytes moved.

    python -m canvas_tpu_torch.studies.vpu_roofline --check [--device cpu]
    python -m canvas_tpu_torch.studies.vpu_roofline --time
"""

import argparse
import hashlib
import subprocess
import sys

import numpy as np
import torch

from canvas_tpu_torch.backend import cuda_ms, paired_ms
from canvas_tpu_torch.ops import _build, cuda_ops, study_ops
from canvas_tpu_torch.studies import (check_device, max_diff, on_device,
                                      time_device)
from canvas_tpu_torch.studies.fold_interior_study import make_inputs as \
    make_fold_inputs

FULL_SIZE = (1088, 1920)
CHECK_SHAPE = (2, 544, 1280)        # B, H, W on the CPU
L = 6
#: Instructions of solid_fold's 16-byte instantiations, counted by hand
#: in the SASS for sm_90a (``cuobjdump -sass`` of the built library; each
#: function cut at the next ``Function :`` line). With per-tile layer
#: lists the count per pixel depends on the boxes, so the parts are
#: recorded and ``instructions_per_pixel`` puts them together for the
#: boxes of a run. Per pass, for one thread of ``pixels`` pixels (4
#: columns of 2 rows where a plane holds f32):
#:
#: - ``fixed``: everything outside the layer loop for a thread that loads
#:   no layer and builds no list (the skipped prologue, 12 + 8; the tile
#:   geometry, 13; the base loads or the zeroed accumulators; the stores).
#:   Mid fold: 12 + 8 + 13 + 6 + 20 + 52 stores = 111. Finalize from an
#:   f32 base to f16: 12 + 8 + 13 + 66 + 4 + 464 = 567, of which 24 f32
#:   divides on their fast path (the slow path's 3 instructions each left
#:   out) and the f16 packing.
#: - ``layer``: the loop's header and step per listed layer (11 + 4).
#: - ``inside``: the body of ``step_inside`` for the 8 pixels: one
#:   subtract, 32 multiplies, 32 adds and the branch.
#: - ``select``: the body of ``step_select`` for the 8 pixels with its
#:   compares and selects.
#: - ``block`` and ``block_layer``: per block of 16x128 pixels, the 32
#:   lanes that build the list (73 instructions each for L <= 32) and the
#:   thread that loads one layer (70 per layer).
#:
#: The counts hold only for the nvcc release and the sha256 of NVCC_FLAGS
#: and the kernel's three sources recorded here (``SASS_SOURCES``);
#: ``solid_fold_instructions`` raises for any other, so a changed kernel
#: or compiler is recounted before a bound is printed. (A comment-only
#: edit moves no instruction; the key was then set anew without a
#: recount, last for the header comment of cols.cuh.)
SASS_SOURCES = ('solid_fold.cu', 'fold_tile.cuh', 'cols.cuh')
SOLID_FOLD_SASS = {
    'nvcc': '12.9',
    'sha256': 'c487f73768375b620b92a8c28fd9f058'
              '5112fd4e121fb795e2f09ef24ef08f92',
    'counts': {
        'mid fold L=6': {'pixels': 8, 'fixed': 111, 'layer': 15,
                         'inside': 66, 'select': 137, 'block': 2336,
                         'block_layer': 70},
        'finalize L=2 f16': {'pixels': 8, 'fixed': 567, 'layer': 15,
                             'inside': 66, 'select': 136, 'block': 2336,
                             'block_layer': 70},
    },
}
#: Warp-instructions an SM is assumed to issue per clock (4 schedulers,
#: one each). Not measured: the only measured instruction rate is the
#: FMA chain's.
ASSUMED_ISSUE_PER_CLOCK = 4
#: Share of a pass's time its byte (or instruction) time must reach for
#: the pass to count as bound by bytes (or instructions).
BOUND_SHARE = 0.9


def make_inputs(B, H, W, R, seed=0):
    """The script's seeded inputs, in its draw order (vpu_roofline.py:77-83
    and 193-195): the image (B, 4, H, W) f32 (normal, scaled by 0.1), R
    sets of 64 constants, and the fold's L boxes, shared by all frames."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, 4, H, W), np.float32) * 0.1
    consts = rng.standard_normal((R, 64), np.float32)
    boxes = rng.integers(0, 500, size=(L, 4)).astype(np.int32)
    boxes[:, 1] += 500
    boxes[:, 3] += 1200
    return img, consts, boxes


def fold_colors(consts, r):
    """The fold's (L, 4) layer colors of copy r (vpu_roofline.py:201)."""
    return consts[r, :L * 4].reshape(L, 4) * 0.1 + 0.4


def chain_constants(n, seed=1):
    """n FMA-chain constants in (-0.9, 0.9), so the chain stays bounded
    and ``study_ops.fma_chain_tol`` applies."""
    return np.random.default_rng(seed).uniform(-0.9, 0.9, n).astype(
        np.float32)


def check(device, shape=None):
    """The chain (k = 8 and 40) and both fold forms on the script's
    inputs at *shape* (B, H, W). On the CPU: the plain chain against a
    float64 chain and the two plain folds against each other; on a card:
    each kernel against its plain version. Returns {name: (max diff,
    allowed)}."""
    B, H, W = shape or (CHECK_SHAPE if device.type == 'cpu'
                        else (32,) + FULL_SIZE)
    img, consts, boxes = make_inputs(B, H, W, 1)
    cs = chain_constants(64)
    x, col, box, c = on_device(device, img, fold_colors(consts, 0), boxes,
                               cs)
    out = {}
    for k in (8, 40):
        if device.type == 'cpu':
            exact = img.astype(np.float64)
            for i in range(k):
                exact = exact * np.float64(cs[i]) + img
            err = float(np.abs(study_ops.fma_chain_plain(x, c, k).double()
                               .numpy() - exact).max())
        else:
            err = max_diff(study_ops.fma_chain(x, c, k),
                           study_ops.fma_chain_plain(x, c, k))
        out['fma_chain k=%d' % k] = (err, study_ops.fma_chain_tol(x, c, k))
    want = study_ops.roofline_fold_plain(x, col, box, False)
    for mult in (False, True):
        got = (study_ops.roofline_fold_plain(x, col, box, mult)
               if device.type == 'cpu' else
               study_ops.roofline_fold(x, col, box, mult))
        out['roofline_fold %s' % ('mult' if mult else 'select')] = (
            max_diff(got, want), 0.0)
    return out


def solid_fold_source_sha256():
    """sha256 of NVCC_FLAGS and the sources of solid_fold's kernel
    (``SASS_SOURCES``), the key of ``SOLID_FOLD_SASS``."""
    digest = hashlib.sha256(' '.join(_build.NVCC_FLAGS).encode())
    for name in SASS_SOURCES:
        digest.update((_build.CSRC / name).read_bytes())
    return digest.hexdigest()


def solid_fold_instructions(nvcc_release):
    """``SOLID_FOLD_SASS['counts']``, or raise if they were not counted
    in the SASS of this source, these flags and this nvcc release."""
    digest = solid_fold_source_sha256()
    if (digest, nvcc_release) != (SOLID_FOLD_SASS['sha256'],
                                  SOLID_FOLD_SASS['nvcc']):
        raise RuntimeError(
            'SOLID_FOLD_SASS was counted for nvcc %s and sources + flags '
            'sha256 %s, not nvcc %s and %s: recount the instructions in '
            'cuobjdump -sass of the built library'
            % (SOLID_FOLD_SASS['nvcc'], SOLID_FOLD_SASS['sha256'],
               nvcc_release, digest))
    return SOLID_FOLD_SASS['counts']


def instructions_per_pixel(parts, box, H, W):
    """Instructions per pixel of one solid_fold pass over *box* (L, B, 4)
    at (H, W), from the counted *parts* of ``SOLID_FOLD_SASS`` and the
    layers each tile lists (``cuda_ops.fold_tile_pixel_layers``, on the
    host): whole threads and whole tiles, the ragged edge not counted."""
    L, B = box.shape[0], box.shape[1]
    inside, across = cuda_ops.fold_tile_pixel_layers(box, H, W)
    px = B * H * W
    th, tw = cuda_ops.FOLD_TILE
    threads = (parts['fixed'] * px
               + (parts['layer'] + parts['inside']) * inside
               + (parts['layer'] + parts['select']) * across
               ) / parts['pixels']
    blocks = px / (th * tw) * (parts['block'] + L * parts['block_layer'])
    return (threads + blocks) / px


def bound(ms, byte_ms, chain_rate_ms):
    """'bytes', 'instructions' or 'not settled' for a pass of *ms* whose
    bytes take *byte_ms* at the measured bandwidth and whose instructions
    take *chain_rate_ms* at the FMA chain's measured rate."""
    if byte_ms >= BOUND_SHARE * ms:
        return 'bytes'
    if BOUND_SHARE * ms <= chain_rate_ms <= ms:
        return 'instructions'
    return 'not settled'


def _sm_clock_mhz():
    """The SM clock nvidia-smi reads now, in MHz, or None without it."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.sm', '--format=csv,noheader,'
             'nounits', '-i', str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return float(out.split()[0])


def measure(device, B=32, ks=(8, 40), rate_ks=(256, 1024), reps=10,
            plain_reps=2):
    """The roofline numbers on the card (see the module docstring), as a
    dict."""
    counts = solid_fold_instructions(_build.nvcc_release())
    H, W = FULL_SIZE
    img, consts, boxes = make_inputs(B, H, W, 1)
    x, col, box, c = on_device(device, img, fold_colors(consts, 0), boxes,
                               chain_constants(max(rate_ks + ks)))
    del img
    n = x.numel()
    nbytes = 2 * n * 4                    # read + write of the image
    r = {'B': B, 'H': H, 'W': W, 'bytes': nbytes}
    y = torch.empty_like(x)
    r['copy_ms'] = cuda_ms(lambda: y.copy_(x), reps)
    del y
    r['chain_ms'], r['chain_plain_ms'] = {}, {}
    for k in ks:
        r['chain_ms'][k], r['chain_plain_ms'][k] = paired_ms(
            lambda: study_ops.fma_chain(x, c, k),
            lambda: study_ops.fma_chain_plain(x, c, k), reps, plain_reps)
    for k in rate_ks:
        r['chain_ms'][k] = cuda_ms(lambda: study_ops.fma_chain(x, c, k), 3)
    # The clock while the longest chain runs: queue ~0.3 s of it, read.
    k = rate_ks[-1]
    runs = max(1, int(300 / r['chain_ms'][k]))
    for _ in range(runs):
        study_ops.fma_chain(x, c, k)
    r['sm_clock_mhz'] = _sm_clock_mhz()
    torch.cuda.synchronize()

    r['copy_tbs'] = nbytes / r['copy_ms'] / 1e9
    r['chain_tbs'] = nbytes / r['chain_ms'][ks[0]] / 1e9
    k1, k2 = ks
    r['slope_ms_%d_%d' % ks] = (r['chain_ms'][k2] - r['chain_ms'][k1]) \
        / (k2 - k1)
    k1, k2 = rate_ks
    slope = (r['chain_ms'][k2] - r['chain_ms'][k1]) / (k2 - k1)
    r['ffma_per_s'] = n / (slope / 1e3)
    r['tflops'] = 2 * r['ffma_per_s'] / 1e12
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    r['sms'] = sms
    if r['sm_clock_mhz']:
        r['issue_per_s'] = (sms * ASSUMED_ISSUE_PER_CLOCK * 32
                            * r['sm_clock_mhz'] * 1e6)
    else:
        r['issue_per_s'] = None

    r['fold_ms'], r['fold_plain_ms'] = {}, {}
    for mult in (False, True):
        r['fold_ms'][mult], r['fold_plain_ms'][mult] = paired_ms(
            lambda: study_ops.roofline_fold(x, col, box, mult),
            lambda: study_ops.roofline_fold_plain(x, col, box, mult),
            reps, plain_reps)
    del x

    # The shipped solid_fold at B and 1080p.
    H, W = 1080, 1920
    rng = np.random.default_rng(7)
    mid_host = make_fold_inputs(rng, 6, B, H, W, 0)
    fin_host = make_fold_inputs(rng, 2, B, H, W, 1)
    mid = on_device(device, *mid_host)
    fin = on_device(device, *fin_host)
    A = rng.uniform(0.0, 1.0, (B, 1, H, W)).astype(np.float32)
    P = (rng.uniform(0.0, 1.0, (B, 3, H, W)) * A).astype(np.float32)
    P, A = on_device(device, P, A)
    px = B * H * W
    r['solid_fold'] = {}
    for name, fn, per_px, box in (
            ('mid fold L=6', lambda: cuda_ops.solid_fold(
                None, None, *mid, H, W), 16, mid_host[1]),
            ('finalize L=2 f16', lambda: cuda_ops.solid_fold(
                P, A, *fin, H, W, finalize=True, out_dtype=torch.float16),
             24, fin_host[1])):
        ms = cuda_ms(fn, reps)
        byte_ms = px * per_px / (r['copy_tbs'] * 1e12) * 1e3
        instr = instructions_per_pixel(counts[name], box, H, W)
        chain_rate_ms = px * instr / r['ffma_per_s'] * 1e3
        r['solid_fold'][name] = {
            'ms': ms, 'bytes': px * per_px, 'byte_ms': byte_ms,
            'instructions_per_px': instr,
            'issue_ms': (px * instr / r['issue_per_s'] * 1e3
                         if r['issue_per_s'] else None),
            'chain_rate_ms': chain_rate_ms,
            'bound': bound(ms, byte_ms, chain_rate_ms)}
    return r


def report(r):
    """The lines ``--time`` prints for the result of ``measure``."""
    ks = sorted(r['chain_ms'])
    clock = ('%.0f MHz' % r['sm_clock_mhz'] if r['sm_clock_mhz']
             else 'not measured')
    lines = [
        'bandwidth (B=%d, 4x%dx%d f32, %.3f GB read + written, the whole '
        'plane): copy %.4f ms = %.3f TB/s; fma_chain k=%d %.4f ms = %.3f '
        'TB/s' % (r['B'], r['H'], r['W'], r['bytes'] / 1e9, r['copy_ms'],
                  r['copy_tbs'], ks[0], r['chain_ms'][ks[0]],
                  r['chain_tbs']),
        'fma_chain: %s; plain %s' % (
            ', '.join('k=%d %.4f ms' % (k, r['chain_ms'][k]) for k in ks),
            ', '.join('k=%d %.3f ms' % (k, ms)
                      for k, ms in sorted(r['chain_plain_ms'].items()))),
        'FMA rate: slope over k=(%d, %d) %.3f TFLOP/s (%.4g FFMA/s, SM '
        'clock %s while it ran; %d SMs); the script\'s pair is bound by '
        'bytes: slope %s ms per step' % (
            ks[-2], ks[-1], r['tflops'], r['ffma_per_s'], clock, r['sms'],
            ', '.join('%s %.5f' % (k[9:], v) for k, v in r.items()
                      if k.startswith('slope_ms_'))),
        'roofline_fold (L=6 over the image, 32 B/px): select %.4f ms, mult '
        '%.4f ms; plain %.3f / %.3f ms' % (
            r['fold_ms'][False], r['fold_ms'][True],
            r['fold_plain_ms'][False], r['fold_plain_ms'][True]),
    ]
    for name, s in r['solid_fold'].items():
        lines.append(
            'solid_fold %s, B=%d 1080p: %.4f ms; bytes %.3f GB -> %.4f ms '
            '(%.0f%%) at the copy\'s bandwidth; %.1f SASS instructions/px -> '
            '%.4f ms (%.0f%%) at the FMA chain\'s measured rate, %s at the '
            'assumed issue ceiling (%d SMs x %d warp-instructions per clock '
            'at %s, not measured); bound: %s'
            % (name, r['B'], s['ms'], s['bytes'] / 1e9, s['byte_ms'],
               100 * s['byte_ms'] / s['ms'], s['instructions_per_px'],
               s['chain_rate_ms'], 100 * s['chain_rate_ms'] / s['ms'],
               'not measured' if s['issue_ms'] is None
               else '%.4f ms' % s['issue_ms'], r['sms'],
               ASSUMED_ISSUE_PER_CLOCK, clock, s['bound']))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--time', action='store_true')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                    help='--check on the CPU (plain versions) with cpu; '
                    'default the card')
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not (args.check or args.time):
        ap.error('give --check or --time')
    if args.check:
        dev = check_device(args.device)
        res = check(dev)
        for name, (err, tol) in res.items():
            print('%-22s on %s: max diff %.3g (allowed %.3g)'
                  % (name, dev.type, err, tol))
        bad = {k: v for k, v in res.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError('outside tolerance: %r' % bad)
        print('parity OK')
    if args.time:
        dev = time_device()
        print(torch.cuda.get_device_name(dev))
        for line in report(measure(dev, args.batch, reps=args.reps)):
            print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
