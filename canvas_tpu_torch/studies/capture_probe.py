"""Which work on another thread invalidates a CUDA graph capture? The
render programs (``render._Program``) capture on a side stream in
``thread_local`` mode while the prepare thread stages segments and other
threads (the pull queue's workers, playback) run batches. This probe
captures a 300-op elementwise body 40 times on a side stream while one
other thread repeats one kind of work, and counts the captures that
failed; each kind runs in a process of its own, so a capture left broken
cannot spoil the next.

The kinds: pinned host allocations (new and cached), pinned and pageable
uploads, device allocations (on another stream and on the default one),
kernels on another stream and on the default one, a matmul, stream
creation, a device-to-host copy, ``empty_cache``, a device-wide
``torch.cuda.synchronize``, ``SlabStager`` segments, and work on a new
pooled stream each time (torch hands its pooled streams out round robin,
32 a priority, so one of them is the capture's own). The side stream is
drawn from the default-priority pool (``pool``) or from the
highest-priority pool (``high``, as ``render._side_stream`` draws it).

Run on a card: ``python -m canvas_tpu_torch.studies.capture_probe``
(about 3 minutes); one JSON line a kind and side stream.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

KINDS = ('none', 'pinned_alloc_new', 'pinned_alloc_cached', 'pinned_upload',
         'pageable_upload', 'device_alloc_new', 'device_alloc_default',
         'eager_side_stream', 'eager_default_stream', 'matmul_side_stream',
         'stream_create', 'to_host', 'empty_cache', 'device_sync', 'stager',
         'new_pool_stream')

#: The kinds also run with the side stream from the default-priority
#: pool (every kind runs with the highest-priority one).
POOL_KINDS = ('stager', 'new_pool_stream')


def _work(kind, device, stop, errors, counts):
    """Repeat one *kind* of work on *device* until *stop* is set."""
    from canvas_tpu_torch import staging
    try:
        own = torch.cuda.Stream(device)
        keep = []
        pinned = torch.empty(4 << 20, dtype=torch.uint8, pin_memory=True)
        pageable = torch.empty(4 << 20, dtype=torch.uint8)
        dst = torch.empty(4 << 20, dtype=torch.uint8, device=device)
        a = torch.randn(512, 512, device=device)
        i = 0
        while not stop.is_set():
            i += 1
            if kind == 'pinned_alloc_new' and len(keep) < 1500:
                keep.append(torch.empty(2 << 20, dtype=torch.uint8,
                                        pin_memory=True))
            elif kind == 'pinned_alloc_cached':
                torch.empty(2 << 20, dtype=torch.uint8, pin_memory=True)
            elif kind in ('pinned_upload', 'pageable_upload'):
                with torch.cuda.stream(own):
                    dst.copy_(pinned if kind == 'pinned_upload'
                              else pageable, non_blocking=True)
                own.synchronize()
            elif kind == 'device_alloc_new' and len(keep) < 1500:
                with torch.cuda.stream(own):
                    keep.append(torch.empty(2 << 20, dtype=torch.uint8,
                                            device=device))
            elif kind == 'device_alloc_default' and len(keep) < 1500:
                keep.append(torch.empty((2 << 20) + i, dtype=torch.uint8,
                                        device=device))
            elif kind in ('eager_side_stream', 'matmul_side_stream'):
                with torch.cuda.stream(own):
                    _b = a @ a if kind == 'matmul_side_stream' else a * 2 + 1
                own.synchronize()
            elif kind == 'eager_default_stream':
                _b = a * 2 + 1
                torch.cuda.current_stream(device).synchronize()
            elif kind == 'stream_create':
                torch.cuda.Stream(device)
            elif kind == 'to_host':
                with torch.cuda.stream(own):
                    dst[:1 << 16].cpu()
            elif kind == 'empty_cache':
                torch.cuda.empty_cache()
            elif kind == 'device_sync':
                torch.cuda.synchronize()
            elif kind == 'stager':
                stager = staging.SlabStager([((64, 1920), np.float32)],
                                            16 + i % 5, device)
                for r in range(stager.n_real):
                    stager.note_row(r)
                stager.finish()
            elif kind == 'new_pool_stream':
                stream = torch.cuda.Stream(device)
                with torch.cuda.stream(stream):
                    dst.copy_(pinned, non_blocking=True)
                stream.synchronize()
            counts[0] += 1
            time.sleep(0.0002)
    except Exception as err:        # the probe reports it
        errors.append('%s: %s' % (type(err).__name__,
                                  str(err).splitlines()[0]))


def probe(kind, side, captures=40):
    """Capture *captures* times on a *side* ('pool' or 'high') stream
    while another thread repeats *kind*; returns the counts."""
    device = torch.device('cuda', 0)
    x = torch.randn(4 << 20, device=device)
    stream = (torch.cuda.Stream(device) if side == 'pool' else
              torch.cuda.Stream(device,
                                priority=torch.cuda.Stream.priority_range()[1]))

    def body(x):
        y = x
        for _ in range(300):
            y = y * 1.0001 + 0.5
        return y

    want = body(x)
    stop, errors, counts = threading.Event(), [], [0]
    worker = threading.Thread(target=_work,
                              args=(kind, device, stop, errors, counts))
    worker.start()
    time.sleep(0.05)
    ok = wrong = 0
    failed = {}
    for _k in range(captures):
        cur = torch.cuda.current_stream(device)
        stream.wait_stream(cur)
        try:
            with torch.cuda.stream(stream):
                body(x)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode='thread_local')
                try:
                    out = body(x)
                finally:
                    graph.capture_end()
            cur.wait_stream(stream)
            graph.replay()
            torch.cuda.synchronize(device)
            ok += 1
            wrong += not torch.equal(out, want)
        except Exception as err:
            msg = '%s: %s' % (type(err).__name__, str(err).splitlines()[0])
            failed[msg] = failed.get(msg, 0) + 1
            try:
                torch.cuda.synchronize(device)
            except Exception:
                pass
    stop.set()
    worker.join(10)
    return dict(kind=kind, side=side, captured=ok, failed=failed,
                wrong=wrong, worker_iterations=counts[0],
                worker_errors=errors[:3])


def main(argv):
    if len(argv) == 3:
        print(json.dumps(probe(argv[1], argv[2])), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit('capture_probe needs a CUDA device')
    print('torch %s, CUDA %s, %s' % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)
    runs = [(k, 'high') for k in KINDS] + [(k, 'pool') for k in POOL_KINDS]
    for kind, side in runs:
        done = subprocess.run([sys.executable, '-m', __spec__.name, kind,
                               side], capture_output=True, text=True,
                              timeout=300)
        lines = done.stdout.strip().splitlines()
        print(lines[-1] if lines else json.dumps(dict(
            kind=kind, side=side, returncode=done.returncode,
            stderr=done.stderr[-400:])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
