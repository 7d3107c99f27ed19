"""``region_over`` timed on the card at config7's three DV regions, beside
its byte floor (the port's own study; it has no TPU counterpart).

    python -m canvas_tpu_torch.studies.region_over_time [--reps 20]
    PYTHONPATH=<older checkout> python \
        canvas_tpu_torch/studies/region_over_time.py

The package's ``cuda_ops.region_over`` is first held to
``cuda_ops.region_over_plain`` (max diff 0) in f32 and bf16, at the three
regions and on a 150x300 frame that its region overhangs on both edges
(the scalar instantiation), then timed with CUDA events at B=16 over the
three regions, f32 and bf16, beside the byte floor (48 or 24 B a region
pixel over 3.35 TB/s). Run by path with an older checkout's package
first on ``PYTHONPATH``, it times that checkout's kernel on the same
inputs, so two versions compare within one call. A card only; raises
without one.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from canvas_tpu_torch.backend import cuda_ms
from canvas_tpu_torch.ops import cuda_ops
from canvas_tpu_torch.studies import max_diff, time_device

#: config7's three DV regions, (h, w, dy0, dx0), as the planner places
#: them in segment [1, 65) of ``timelines.mixed_timeline`` at 1080p
#: (chip_smoke.py phase 7 reads them from the plan).
REGIONS = ((640, 1024, 0, 0), (704, 1152, 64, 512), (640, 1024, 448, 896))
FRAME = (1080, 1920)
B = 16
#: The scalar form's check: a 128x256 region at (64, 128) of a 150x300
#: frame (W % 8 != 0; it overhangs the bottom and right edges).
SCALAR_CASE = (150, 300, 128, 256, 64, 128)
#: Published H100 SXM device-memory rate, bytes/s.
HBM_BYTES_PER_S = 3.35e12


def inputs(dev, dtype, Hf, Wf, h, w, dy0, dx0, rng, frames=B):
    """Seeded (P, A, layer) in *dtype* and the offsets as int32 values on
    the card."""
    P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
        np.float32)).to(dev, dtype) for s in ((frames, 3, Hf, Wf),
                                              (frames, 1, Hf, Wf),
                                              (frames, 4, h, w))]
    oy, ox = [torch.tensor([v], dtype=torch.int32, device=dev)
              for v in (dy0, dx0)]
    return P, A, layer, oy, ox


def check(fn, dev, seed=15):
    """*fn* (region_over-like) against the plain version at the three
    regions and at SCALAR_CASE, f32 and bf16: the largest difference,
    which must be 0."""
    rng = np.random.default_rng(seed)
    cases = [FRAME + r for r in REGIONS] + [SCALAR_CASE]
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for Hf, Wf, h, w, dy0, dx0 in cases:
            P, A, layer, oy, ox = inputs(dev, dtype, Hf, Wf, h, w, dy0, dx0,
                                         rng, frames=3)
            want = cuda_ops.region_over_plain(P.clone(), A.clone(), layer,
                                              dy0, dx0)
            got = fn(P.clone(), A.clone(), layer, oy, ox)
            err = max(err, max_diff(got, want))
    torch.cuda.synchronize()
    return err


def timeit(fn, dev, reps=20, seed=16):
    """{dtype name: ms of *fn* summed over the three regions} and
    {dtype name: byte floor ms}."""
    rng = np.random.default_rng(seed)
    Hf, Wf = FRAME
    times, floors = {}, {}
    for dtype, per_px in ((torch.float32, 48), (torch.bfloat16, 24)):
        tname = 'bf16' if dtype == torch.bfloat16 else 'f32'
        data = [inputs(dev, dtype, Hf, Wf, *r, rng) for r in REGIONS]
        px = sum(B * min(h, Hf - dy0) * min(w, Wf - dx0)
                 for h, w, dy0, dx0 in REGIONS)
        floors[tname] = px * per_px / HBM_BYTES_PER_S * 1e3
        times[tname] = sum(cuda_ms(lambda: fn(*args), reps)
                           for args in data)
        del data
        torch.cuda.empty_cache()
    return times, floors


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    dev = time_device()
    card = card_line()
    print(card, flush=True)
    err = check(cuda_ops.region_over, dev)
    print('max diff against region_over_plain (must be 0): %r' % err,
          flush=True)
    if err:
        raise AssertionError('region_over differs from plain: %r' % err)
    times, floors = timeit(cuda_ops.region_over, dev, args.reps)
    for tname, ms in times.items():
        print('%s: %.4f ms over the three regions, B=%d; byte floor %.4f '
              'ms; time / floor %.3f [%s]'
              % (tname, ms, B, floors[tname], ms / floors[tname], card),
              flush=True)
    print(json.dumps({'card': card, 'floors_ms': floors, 'ms': times}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
