"""Interior/edge tile study of the solid fold on the card: the port's
counterpart of ``scripts/fold_interior_study.py``.

The fold of L solid(+gain/offset) layers over an empty base, finalized
to f32, in the four forms of ``study_ops.VARIANTS``: ``current`` (select
masks), ``rank1`` (float row x column masks), ``cond`` (a tile inside a
layer's box takes the unmasked step) and ``switch`` (a tile the box
misses also skips the layer). All four must give the same bits, and the
same bits as the shipped ``cuda_ops.solid_fold_plain``.

    python -m canvas_tpu_torch.studies.fold_interior_study --check [--device cpu]
    python -m canvas_tpu_torch.studies.fold_interior_study --time

``--check`` runs each kernel against its plain version on the card at
the script's check size and at 1080p (with ``--device cpu``, the plain
versions on the CPU). ``--time`` times each form's kernel beside its plain version and
the shipped ``solid_fold`` (finalize to f32) on the same inputs, at
B=32, L=6, 1080x1920.
"""

import argparse
import sys

import numpy as np
import torch

from canvas_tpu_torch.backend import cuda_ms
from canvas_tpu_torch.ops import cuda_ops, study_ops
from canvas_tpu_torch.studies import (check_device, max_diff, on_device,
                                      time_device)

CHECK_SIZE = (240, 512)
FULL_SIZE = (1080, 1920)


def make_inputs(rng, L, B, H, W, r):
    """The script's generator (fold_interior_study.py:175-191): layer 0 a
    full-frame backdrop, the others animated partial boxes (30-80% of
    each side), so tiles lie inside, across and outside the boxes."""
    color = rng.uniform(0.05, 1.0, (L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, (L, B)).astype(np.float32)
    offset = rng.uniform(-0.1, 0.1, (L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    box[0, :, :] = [0, H - 1, 0, W - 1]
    for l in range(1, L):
        h = int(H * rng.uniform(0.3, 0.8))
        w = int(W * rng.uniform(0.3, 0.8))
        for b in range(B):
            y0 = int((H - h) * ((b + l * 7 + r * 13) % 17) / 17)
            x0 = int((W - w) * ((b * 3 + l * 5 + r * 11) % 23) / 23)
            box[l, b] = [y0, y0 + h - 1, x0, x0 + w - 1]
    return color, box, gain, offset


def check(device, L=6, B=32, sizes=None, seed=7):
    """Each form against ``solid_fold_plain`` (and, on a card, each
    kernel against its plain version) on the script's inputs at each
    (H, W) of *sizes*. Returns {(H, W, variant): max diff}; every value
    must be 0."""
    sizes = sizes or ([CHECK_SIZE] if device.type == 'cpu'
                      else [CHECK_SIZE, FULL_SIZE])
    rng = np.random.default_rng(seed)
    out = {}
    for H, W in sizes:
        args = on_device(device, *make_inputs(rng, L, B, H, W, 0))
        ref = cuda_ops.solid_fold_plain(None, None, *args, H, W,
                                        finalize=True)
        for v in study_ops.VARIANTS:
            plain = study_ops.fold_variant_plain(v, *args, H, W)
            err = max_diff(plain, ref)
            if device.type == 'cuda':
                err = max(err, max_diff(study_ops.fold_variant(v, *args, H, W),
                                        plain))
            out[(H, W, v)] = err
        del args, ref, plain
    return out


def timeit(device, L=6, B=32, reps=20, plain_reps=2, seed=7):
    """Device ms at B, L, 1080x1920 on the script's inputs:
    {'solid_fold': the shipped kernel (finalize to f32, timed before and
    after the forms), 'kernel': {variant: ms}, 'plain': {variant: ms}}."""
    H, W = FULL_SIZE
    rng = np.random.default_rng(seed)
    args = on_device(device, *make_inputs(rng, L, B, H, W, 0))
    shipped = lambda: cuda_ops.solid_fold(None, None, *args, H, W,
                                          finalize=True)
    before = cuda_ms(shipped, reps)
    kernel = {v: cuda_ms(lambda: study_ops.fold_variant(v, *args, H, W),
                         reps) for v in study_ops.VARIANTS}
    after = cuda_ms(shipped, reps)
    plain = {v: cuda_ms(lambda: study_ops.fold_variant_plain(
        v, *args, H, W), plain_reps) for v in study_ops.VARIANTS}
    return {'solid_fold': (before + after) / 2, 'kernel': kernel,
            'plain': plain}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--time', action='store_true')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                    help='--check on the CPU (plain versions) with cpu; '
                    'default the card')
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--layers', type=int, default=6)
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not (args.check or args.time):
        ap.error('give --check or --time')
    if args.check:
        dev = check_device(args.device)
        errs = check(dev, args.layers, args.batch)
        for (H, W, v), err in sorted(errs.items()):
            print('%-8s %dx%d B=%d L=%d on %s: max diff %r (must be 0)'
                  % (v, H, W, args.batch, args.layers, dev.type, err))
        if any(errs.values()):
            raise AssertionError('a fold form differs: %r' % errs)
        print('parity OK: all forms bit-identical to solid_fold_plain'
              + (' and each kernel to its plain version'
                 if dev.type == 'cuda' else ''))
    if args.time:
        dev = time_device()
        times = timeit(dev, args.layers, args.batch, args.reps)
        print('%s; B=%d L=%d 1080x1920, finalize f32' % (
            torch.cuda.get_device_name(dev), args.batch, args.layers))
        print('solid_fold (shipped)  %.4f ms' % times['solid_fold'])
        for v, ms in times['kernel'].items():
            print('%-8s kernel       %.4f ms' % (v, ms))
        for v, ms in times['plain'].items():
            print('%-8s plain        %.3f ms' % (v, ms))
    return 0


if __name__ == '__main__':
    sys.exit(main())
