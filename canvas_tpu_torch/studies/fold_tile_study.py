"""Per-tile layer-list study of the solid fold on the card: the port's
counterpart of ``scripts/fold_tile_study.py``.

``study_ops.tile_fold`` folds, in each tile, only the layers whose box
meets the tile, in z order; skipping the others is bit-exact, so it
must equal the shipped ``cuda_ops.solid_fold_plain``.

    python -m canvas_tpu_torch.studies.fold_tile_study --check [--device cpu]
    python -m canvas_tpu_torch.studies.fold_tile_study --time

``--check`` runs the script's five cases on the card, the kernel against
its plain version and against ``solid_fold_plain``, and also at B=32 and
1088x1920 (with ``--device cpu``, the five cases with the plain version
on the CPU). ``--time``
times the kernel, its plain version, and the shipped ``solid_fold`` on
the same inputs: the mid fold (no base, f32 accumulators) of L=6 layers
at B=32, 1088x1920, with ``mixed`` and ``full`` coverage.
"""

import argparse
import sys

import numpy as np
import torch

from canvas_tpu_torch.backend import cuda_ms
from canvas_tpu_torch.ops import cuda_ops, study_ops
from canvas_tpu_torch.studies import (check_device, max_diff, on_device,
                                      time_device)

#: The script's check cases (fold_tile_study.py:182-187):
#: (L, B, H, W, coverage, with base, finalize).
CASES = ((6, 3, 96, 256, 'mixed', False, False),
         (6, 3, 96, 256, 'mixed', True, True),
         (4, 2, 64, 128, 'full', False, True),
         (5, 2, 72, 384, 'empty', True, False),
         (1, 1, 8, 128, 'mixed', False, False))
#: The script's timing cases (fold_tile_study.py:237-238).
FULL = (6, 32, 1088, 1920)
COVERAGES = ('mixed', 'full')


def make_case(rng, L, B, H, W, coverage='mixed'):
    """The script's generator (fold_tile_study.py:159-175), on a
    ``np.random.RandomState``: ``mixed`` (layer 0 full-frame, the others
    random boxes of up to half each side), ``full`` (every layer
    full-frame) or ``empty`` (odd layers empty)."""
    color = rng.rand(L, B, 4).astype(np.float32)
    gain = rng.uniform(0.2, 1.2, (L, B)).astype(np.float32)
    offset = rng.uniform(-0.1, 0.1, (L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            if coverage == 'full' or (l == 0 and coverage == 'mixed'):
                box[l, b] = [0, H - 1, 0, W - 1]
            elif coverage == 'empty' and l % 2:
                box[l, b] = [5, 1, 5, 1]        # empty (y1 < y0)
            else:
                y0 = rng.randint(0, H // 2)
                x0 = rng.randint(0, W // 2)
                box[l, b] = [y0, y0 + rng.randint(1, H // 2),
                             x0, x0 + rng.randint(1, W // 2)]
    return color, box, gain, offset


def check(device, cases=None, seed=7):
    """Each case through ``tile_fold`` against ``solid_fold_plain`` (and,
    on a card, against ``tile_fold_plain``). Returns {case: max diff};
    every value must be 0."""
    if cases is None:
        cases = CASES + (() if device.type == 'cpu' else tuple(
            FULL + (cov, False, False) for cov in COVERAGES))
    rng = np.random.RandomState(seed)
    out = {}
    for case in cases:
        L, B, H, W, cover, base, fin = case
        args = on_device(device, *make_case(rng, L, B, H, W, cover))
        P = A = None
        if base:
            P, A = on_device(device, rng.rand(B, 3, H, W).astype(np.float32),
                             rng.rand(B, 1, H, W).astype(np.float32))
        got = study_ops.tile_fold(P, A, *args, H, W, finalize=fin)
        err = max_diff(got, cuda_ops.solid_fold_plain(P, A, *args, H, W,
                                                      finalize=fin))
        if device.type == 'cuda':
            err = max(err, max_diff(got, study_ops.tile_fold_plain(
                P, A, *args, H, W, finalize=fin)))
        out[case] = err
    return out


def timeit(device, reps=20, plain_reps=2, seed=7):
    """Device ms of the mid fold at FULL, per coverage: {coverage:
    {'solid_fold': ms (timed before and after the kernel), 'kernel': ms,
    'plain': ms}}."""
    L, B, H, W = FULL
    rng = np.random.RandomState(seed)
    out = {}
    for cover in COVERAGES:
        args = on_device(device, *make_case(rng, L, B, H, W, cover))
        shipped = lambda: cuda_ops.solid_fold(None, None, *args, H, W)
        before = cuda_ms(shipped, reps)
        kernel = cuda_ms(lambda: study_ops.tile_fold(None, None, *args, H, W),
                         reps)
        after = cuda_ms(shipped, reps)
        out[cover] = {'solid_fold': (before + after) / 2, 'kernel': kernel,
                      'plain': cuda_ms(lambda: study_ops.tile_fold_plain(
                          None, None, *args, H, W), plain_reps)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--time', action='store_true')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                    help='--check on the CPU (plain versions) with cpu; '
                    'default the card')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not (args.check or args.time):
        ap.error('give --check or --time')
    if args.check:
        dev = check_device(args.device)
        errs = check(dev)
        for (L, B, H, W, cover, base, fin), err in errs.items():
            print('L=%d B=%d %dx%d %-5s base=%d fin=%d on %s: max diff %r '
                  '(must be 0)' % (L, B, H, W, cover, base, fin, dev.type,
                                   err))
        if any(errs.values()):
            raise AssertionError('tile_fold differs: %r' % errs)
        print('parity OK: bit-identical to solid_fold_plain')
    if args.time:
        dev = time_device()
        L, B, H, W = FULL
        print('%s; mid fold L=%d B=%d %dx%d' % (
            torch.cuda.get_device_name(dev), L, B, H, W))
        for cover, t in timeit(dev, args.reps).items():
            print('%-5s solid_fold (shipped) %.4f ms; tile_fold %.4f ms; '
                  'plain %.3f ms' % (cover, t['solid_fold'], t['kernel'],
                                     t['plain']))
    return 0


if __name__ == '__main__':
    sys.exit(main())
