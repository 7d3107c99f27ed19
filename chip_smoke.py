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
playback engine), then coded video and the plan cache's replays, then
the export path at 4K, then the editor's projects through its graph
managers, then an editor session through its UI layer, then the eager
pull in the default backend mode, then multi-device rendering over
logical shards, then the render programs (one CUDA graph per signature,
which every path above runs through), then the eviction of programs a
caller holds and the user entry points (``canvas_tpu_torch.tools``).
Each phase
prints one line or more; any failure raises
(traceback, nonzero exit, no result line):

1. card: nvidia-smi's name and power limit, torch's device name;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernels vs plain: each kernel against its plain PyTorch version on
   the card, on seeded inputs, bit-identical (max diff 0), then each
   quality <= 9 form (bf16 accumulators: solid_fold's mid fold storing
   bf16, from a bf16 base, and its finalize from a bf16 base;
   region_over_sep and region_over in bf16) at the same shapes, then
   solid_fold, region_over_sep and region_over in every form at frames
   whose rows are not a multiple of 8 values and through planes that do
   not start at a multiple of 16 bytes (the kernels' scalar
   instantiation; the shapes before took the 16-byte one, some with the
   region overhanging the bottom edge), with the launches of each
   instantiation counted;
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
   cache, which switches the plan cache off too; frames 0..127, batch
   16, one warm pass, best of 3), the device busy time of the same
   batches replayed and the idle share, the replay's device time by
   kernel (torch.profiler),
   and region_over beside its plain version and its byte floor at the
   path's three region shapes, naming the instantiation that ran;
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
   largest difference, at most 1 on at most 0.1% of values), one
   ``yuv420_post`` launch a yuv420 batch and none a bgra_u8 one; the
   conversions' device time on one batch; the fused yuv420 kernel's
   bytes on that batch bit-equal to its plain ops' on the card
   (``color.yuv420_pack_studio_plain``), its time beside theirs and its
   7.5 B/px floor; the headline's cold fps with
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
   then one batch taken apart (render, conversion, fetch, host unpack);
11. coded video and replay: ``timelines.pulldown_clip()`` (benchmarks.py
   config3's DV clip under 2:3 pulldown removal) at 720x480, frames
   0..127 through iter_batches(batch=16), finite f16, frames 0, 1, 2, 3
   and 70 (solid and mixed cadence frames) against the NumPy pull path
   (atol 1e-2, at least 99% bit-equal), and
   ``config3_dv_reconstruct_pulldown_fps`` cold; ``timelines.planar_clip(64)``
   (config8's graph, seeded planes in the decoder's place) at 1080p,
   frames 0..47 at batch 8, frames 0, 1, 20 and 47 against the pull path
   under the same limits, ``config8_1080p_decoded_planar_fps`` cold, decode
   bypassed, and ``planar_recon_rows``'s device time for one batch beside
   its bytes and operations; the mixed timeline with one DV clip under
   pulldown removal (region_over must launch; mixed cadence frame 2
   against the pull path); the replay of the mixed timeline (frames
   0..127, batch 16, caches on): ``config7b_mixed_content_cached_replay_fps``
   and ``config7c_replay_while_editing_elsewhere_fps`` with, per pass,
   the segments planned (0), the coded frames pulled (0) and the
   host-to-device copies, the replay's device busy time and idle share,
   then a pass after ``invalidate_display_cache(0, 10)`` (only the
   segments touching it plan again), and the same for the headline at
   batch 128; ``iter_batches(max_inflight=2)`` over the headline
   bit-equal to the unpaced stream, with the most batches queued ahead of
   the device; the memory guard's estimate beside the measured peak, and
   a batch it refuses before any launch (the estimate must not be below
   the peak); one segment's params uploaded copy by copy beside one
   packed copy a batch;
12. the export path at 4K (benchmarks.py config6 and config6b): frames
   0..63 of the headline at 3840x2160 through iter_batches(batch=8) with
   post='rgba_u8' (``config6_4k_10layer_export_path_fps``) and
   post='yuv420' (``config6b_4k_export_yuv420_transport_fps``), cold,
   the batches left on the card as benchmarks.py leaves them; each
   post's first pass is the checked one (its launches: 2 solid_fold and
   2 region_over_sep a batch, and 1 yuv420_post a yuv420 batch, nothing
   else), then one warm pass, best of
   3; the device busy time and idle share, the post's
   device time per batch, the memory guard's estimate beside the
   measured peak (the estimate must not be below it); frames 0 and 63
   of each post against the CPU's conversion of the card's own f16
   frames (at most 1 on at most 0.1%), frame 0 against the NumPy pull
   path (atol 2e-3); the headline's
   kernels at 4K, batch 8, beside their byte floors. Writing and
   decoding files (``libav``) is not driven here: the card's machine has
   no FFmpeg development files to build ``native/canvas_av.cpp`` against
   (ROADMAP.md queue 1);
13. the editor at 1080p (``canvas_tpu_torch.editor``: projects of Clips
   and Sequences over the port's sources, through the graph managers):
   (a) ``timelines.editor_headline(1024)`` (the headline's ten layers as
   Clips in ten lanes) frames 128..511 via iter_batches(batch=128), plan
   cache off, every batch bit-equal to phase 5's planner over
   build_timeline(1024), with its launches a batch (1 mid fold, 1
   finalize, 2 region_over_sep) and its plan signature, then its cold
   fps, device busy time, idle share and planning ms per segment beside
   phase 5's; (b) with the plan cache on, an AdjustClipLengthCommand on
   an UndoStack trims the white strip to 300 frames: no segment of the
   first pass that ends at or before frame 300 plans again, frames 299
   and 300 within 2e-3 of the pull path, and after undo() frames
   128..511 bit-equal to the first pass; (c) ``timelines.editor_cut(256)``
   (three DV clips in a Sequence with two 12-frame crossfades) frames
   0..127 at batch 16, cold: region_over must launch, frames 0, 58, 70
   and 110 against the pull path under phase 6's gate, cold fps, device
   time and idle share beside config7's; (d) render_display rgb24 of the
   headline project: warm p50/p95 beside phase 10's, frames 0 and 130
   against a CPU planner (at most 1 on at most 0.1%); (e) ``u8_linearize``
   (the libav plugin's RGBA decode op) on a seeded (8, 1080, 1920, 4)
   batch bit-equal to the CPU, its time beside its byte floor. The
   libav plugin's file import is not driven (no FFmpeg there);
14. an editor session through the UI layer (``canvas_tpu_torch.editor.ui``)
   at 1080p: (a) an ``EditorApp`` whose clock is its ``AudioPlayer``
   (audio-master, a ``NullSink`` at 48 kHz) over
   ``editor_headline(1024)`` plus a seeded tone added with
   ``add_asset_to_space``; its space's playback engine
   (``start_playback``, batch 4, 25 fps) warmed and played 3 s: presented
   against the ideal count, skipped, mean batch ms, the samples the sink
   consumed (at least 80% of 3 s) and its peak (the tone's level), the
   presentation time advanced, the launches; presented indices must
   increase, at least half the ideal frames show, no batch fails, and two
   presented frames are u8-equal to a ``device='cpu'`` engine's; (b) 8
   thumbnails (160x90 of [0, 1024), B=1 planned pulls through a
   ``VideoPullQueue`` on the card) alone and while the engine plays
   (three threads rendering on the card): ms to the last delivery, ms
   each, segments planned, launches, each u8-equal to the CPU's; (c)
   ``paint_timeline(1280, 240)`` with those thumbnails u8-equal to a CPU
   app's, its ms; (d) a ``DragController`` drag moves the white strip by
   +40 frames while paused: the segments the engine plans again (inside
   the edit's ``frames_updated`` ranges), the paused frame presented
   again, frames 20 and 1030 u8-equal to the CPU's after the drag and
   bit-equal to before it after ``undo()``; (e) 8 thumbnails of
   ``editor_cut(256)``: region_over launches and no solid_fold, each
   within 1 u8 step of the CPU's on at most 0.1% of values. ``RenderJob``
   and ``EditorApp.import_file`` reach libav (no FFmpeg there): CPU
   tests only.
15. the eager pull on the card (``VideoSource.get_frame_f16`` in the
   default ``'auto'`` backend mode): (a) ``backend.use_torch_for`` is
   True at 1080p with ``eager_device()`` the card, False under
   ``force_backend('numpy')`` and at 160x90; (b) headline frames 128, 300
   and 511 and config7 frames 0 and 70 pulled at 1080p come back as f16
   tensors on the card, within phase 4's (headline) and phase 6's
   (config7) gates of the NumPy arm's pull and of a B=1 planner frame,
   with the share bit-equal; (c) ms per pull by the host clock until the
   host copy (median of 5 after a warm pull) at 1080p and at 160x90:
   the torch arm, the NumPy arm and a B=1 ``RenderPlanner.render``;
   (d) ``process.time_get_frame`` over headline frames 128..255 and
   config7 frames 0..15: the planner branch, whose kernels must launch
   (solid_fold and region_over_sep; region_over), then
   ``force_eager=True`` over 4 frames each with no kernel launch, the
   nanoseconds of each; (e) a ``process.VideoPullQueue`` on the card
   pulling a source without ``plan_cuts``: enqueued from a thread in the
   default mode its frame arrives as a tensor on the card, enqueued under
   ``force_backend('numpy')`` as NumPy, within 2e-3 of each other;
16. multi-device rendering (``canvas_tpu_torch.mesh``,
   ``iter_batches(mesh=)``, ``render_sharded``) over logical shards: a
   mesh may name the one card more than once, each entry one shard.
   (a) ``render_sharded(build_timeline(1024), 1080p, 0, 256,
   device_out=True, batch=128)`` over the default mesh
   (``mesh.local_mesh()``, every visible card; with one it streams
   unsharded), bit-equal to an unsharded planner's stream, and the
   mesh's device count; (b) over ``Mesh([card] * 2, ('frames',))``: the
   headline's frames 128..511 at batch 128, each shard bit-equal to the
   unsharded stream; config7's frames 0..127 at batch 16 with its DV
   planes staged onto the mesh (replicated stacks), within phase 6's
   gate of the unsharded render (its bit-equal share printed: the
   scalers' and chroma einsums run at 8 frames a shard); over a 2x2
   frames x space mesh, ``render_sharded`` of 5 frames with
   ``spatial_axis='space'`` bit-equal to the unsharded frames, and
   ``iter_batches(0, 5, batch=8, mesh, post='yuv420')`` u8-equal to the
   unsharded post, with one ``yuv420_post`` launch a shard of each
   batch; (c) config5's protocol (benchmarks.py:483-546) on the 2-shard
   mesh: sharded and plain fps over frames 0..255 at batch 128,
   cold, and their ratio, the median of three interleaved pairs; host
   enqueue and device busy ms per batch, sharded beside unsharded, and
   the sharded pass's device idle share; the memory guard's per-device
   estimate beside the sharded stream's measured peak (the estimate
   must not be below it), and render_sharded's cumulative estimate
   beside its peak. Rehearse it on the CPU with ``_multi_device(tag,
   box2i(0, 0, 319, 179), {'enqueue_ms': 0.0, 'batches': 1},
   device='cpu')``.
17. the render programs (``render._get_program``: each signature's
   evaluation captured once as one CUDA graph, replayed for every batch;
   the region kernels read their offsets from device memory): (a) every
   path through its programs against the eager run on the same params,
   max diff 0: the headline's frames 128..515 at batch 128 (the tail
   segment [512, 516) its own signature), config7's frames 0..127 at
   batch 16, the ``rgba_u8`` and ``yuv420`` posts (one ``yuv420_post``
   launch a program call of the yuv420 pass, none in the others),
   ``render_display``
   rgb24 at full size and 960x540 (frames 0, 130, 1000), config5 over a
   mesh naming the card twice; (b) from no program, three cold passes of
   the headline capture once per signature (a program's first two calls
   run eagerly, the second captures after it) and replay every later
   batch; (c)
   eager (the programs replaced by ``_Eager`` stand-ins) against
   program, the median of five interleaved passes: fps, host enqueue and
   device busy ms a batch and the idle share for the cold headline, cold
   config7, the config7b replay and config5 on logical shards, the warm
   ``render_display`` p50/p95, each program's capture ms and pool bytes,
   and a cold headline pass's peak memory from no program beside the
   memory guard's estimate (the programs' pools counted; it must not be
   below the peak); (d) both region kernels with their offsets as int32
   values in card memory against their plain versions, f32 and bf16, at
   the main path's shapes (the headline's two rank-1 regions at batch
   128, config7's three DV regions at batch 16) and over the bottom
   edge, each beside its byte floor. Rehearse (a) and (b) on the CPU with
   ``_programs(tag, box2i(0, 0, 319, 179), device='cpu')``.
18. held programs and tools: (a) planner A streams frames 1..64 (one
   segment) with the plan cache off, holding the segment's program across
   its batches, on the headline at batch 8 and config7 at batch 16;
   paused mid-segment, planner B renders frames 200..201 twice and
   evicts A's program, by count (``render._PROGRAMS_KEPT`` 1 inside the
   phase) and by memory (``CANVAS_HBM_MB`` at 1.25x B's batch with its
   pool while B renders); A resumes. Per scenario: captures, replays,
   orphans (must be 0) and evictions; ``_held_bytes`` beside what every
   program made holds (must be equal); the families left once the
   programs are cleared (must be 0); ``explain``'s status (must read
   "not captured" then); A's frames against an uninterrupted pass (max
   diff 0). (b) ``tools.explain --demo`` over frames 128..191 in this
   process before and after two renders of that segment (its status
   lines, "CAPTURED" after, and its wall ms); (c)
   ``tools.decode_raw_image`` in the default mode (the torch arms on the
   card) to a temporary PPM, its ms and its pixels against the same pull
   on the host (at most 1 u8 step); (d) config2
   (``timelines.crossfade_timeline(1024)``, one lerped ``solid`` after
   the mix peephole) frames 0, 1, 500 and 1023 at 1080p against the
   NumPy pull path (atol 2e-3). Rehearse it on the CPU with
   ``_held_programs(tag, box2i(0, 0, 159, 89), device='cpu')`` (~40 s).

A render program's first two calls run its body eagerly (the second
then captures it), and every later call replays it, so every call
launches, or replays, exactly one batch's kernels: the checks of
launches a batch (phases 12, 13a, 14e) hold as they are.

Each path (the headline, the mixed timeline, the studies' timing runs,
the export posts, the display path, the coded composite, the replays,
each post's checked pass of the 4K export, the editor's passes, the
editor session's and phase 15's ``time_get_frame`` planner branches,
phase 16's sharded renders, phase 17's checked paths, phase 18's
held-program passes and its renders before ``explain``; a program's
replay adds the launches its capture recorded)
runs
with every launch counter set to 0 just before it and read just after;
the kernels line
reports each kernel's launches in those runs, its time, its plain
version's, and its bound: the larger of the bytes it must move over the
card's published memory rate and its f32 operations over the published
f32 rate
(PEAK_BYTES_PER_S, PEAK_F32_PER_S), from this run's shapes. The bf16
form of each render kernel has an entry of its own; the fused yuv420
post (``yuv420_post``) has one, timed and held to its plain ops on
phase 9's batch of 128 1080p frames. No single PyTorch
call computes what any of the kernels computes, so ``library_ms`` is
null throughout.
The line before the last is the card's nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root with no
arguments: ``python3 chip_smoke.py``. An import hook refuses JAX, the
JAX package (``canvas_tpu``) and the root scripts (``bench``,
``benchmarks``, ``scripts``): the port runs on its own. Phases 4-14
hold the card against the NumPy pull path, pinned with
``force_backend('numpy')``; phase 15 drives the default-mode pull.
"""

import importlib.abc
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

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

#: The fused yuv420 post per pixel: the R, G and B f16 planes read (6 B)
#: and Y with the 2x2 Cb and Cr written (1.5 B); its f32 operations, Ey
#: (3 multiplies, 2 adds, the /255: 6), Y (2), Cb and Cr before the mean
#: (4 each) and the two 2x2 means (4 each a quad: 2).
YUV420_BYTES = 7.5
YUV420_OPS = 18


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

#: The fused yuv420 export post: one form, one launch a posted batch.
_POST_KERNEL = 'yuv420_post'


def _launch_counts():
    from canvas_tpu_torch.ops import cuda_ops
    out = {}
    for name in _RENDER_KERNELS:
        fn = getattr(cuda_ops, name)
        out[name] = fn.launches
        out[name + '_bf16'] = fn.launches_bf16
    out[_POST_KERNEL] = getattr(cuda_ops, _POST_KERNEL).launches
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
    getattr(cuda_ops, _POST_KERNEL).launches = 0
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
            outP, outA = getattr(cuda_ops, kind)(
                P, A, *args, *_device_offsets(P.device, dy0, dx0))
            getattr(cuda_ops, kind + '_plain')(P2, A2, *args, dy0, dx0)
            if outP is not P or P.dtype != bf:
                raise AssertionError('%s bf16 did not update in place' % kind)
            err[kind] = max(err[kind], _max_diff((P, A), (P2, A2)))
    return err


def _instantiation_counts():
    """Launches of the 16-byte and the scalar instantiation of each
    render kernel."""
    from canvas_tpu_torch.ops import cuda_ops
    return {name: (getattr(cuda_ops, name).launches_vector,
                   getattr(cuda_ops, name).launches_scalar)
            for name in _RENDER_KERNELS}


def _instantiation(name, before):
    """'16-byte' or 'scalar': the instantiation of *name* that launched
    once since the counts *before* (an ``_instantiation_counts`` value);
    raises unless exactly one launch was counted."""
    now = _instantiation_counts()[name]
    moved = (now[0] - before[0], now[1] - before[1])
    if moved not in ((1, 0), (0, 1)):
        raise AssertionError('%s: expected one launch, counted [16-byte, '
                             'scalar] %r' % (name, moved))
    return '16-byte' if moved == (1, 0) else 'scalar'


def _region_over_total(phase, dtype, ms, floor_ms, tag):
    """Phases 7, 10 and 17d: region_over over config7's three regions
    beside its byte floor."""
    print('phase %s region_over %s over config7\'s three DV regions, batch '
          '16: %.4f ms, byte floor %.4f ms, time / floor %.3f %s'
          % (phase, dtype, ms, floor_ms, ms / floor_ms, tag), flush=True)


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
    and bf16 base), region_over_sep and region_over (f32, bf16) against
    their plain versions where the 16-byte instantiation cannot run: a
    270x481 and a 150x300 frame (rows not a multiple of 8 values; the
    region overhangs both edges) and a 96x256 frame whose planes (and
    region_over's layer) start one value into their storage. Returns the
    largest difference (must be 0)."""
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
            cuda_ops.region_over_sep(P, A, *args,
                                     *_device_offsets(P.device, dy0, dx0))
            cuda_ops.region_over_sep_plain(P2, A2, *args, dy0, dx0)
            err = max(err, _max_diff((P, A), (P2, A2)))
            layer = on(rng.uniform(0.0, 1.0, (3, 4, h, w)).astype(
                np.float32))[0].to(dtype)
            if shift:
                layer = _offset_view(layer)
            P2, A2 = P.clone(), A.clone()
            cuda_ops.region_over(P, A, layer,
                                 *_device_offsets(P.device, dy0, dx0))
            cuda_ops.region_over_plain(P2, A2, layer, dy0, dx0)
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
    want = np.stack([_numpy_pull(src, i, window) for i in range(300, 304)])
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


def _numpy_pull(src, i, window, dtype='float16'):
    """Frame *i* of *src* through the NumPy pull path (the eager pull's
    NumPy arm, pinned with ``force_backend('numpy')``: in the default
    mode a frame this size would take the torch arms on the card)."""
    import numpy as np

    from canvas_tpu_torch import backend
    with backend.force_backend('numpy'):
        data = src.get_frame_f16(i, window).data
    if not isinstance(data, np.ndarray):
        raise AssertionError('a NumPy pull returned %s' % type(data))
    return data.astype(dtype)


def _pull_stack(src, window, frames):
    return {i: _numpy_pull(src, i, window) for i in frames}


def _vs_pull(what, picked, want):
    """{frame: (max diff, share bit-equal)} of picked f16 frames against
    the pull path's; raises beyond atol 1e-2 or under 99% bit-equal."""
    import numpy as np
    out = {}
    for i, got in picked.items():
        err = float(np.abs(got.astype(np.float32)
                           - want[i].astype(np.float32)).max())
        share = _bit_share(got, want[i])
        out[i] = (err, share)
        if not np.isfinite(got).all() or err > 1e-2 or share < 0.99:
            raise AssertionError('%s frame %d differs from the pull path by '
                                 '%r (%.5f bit-equal)' % (what, i, err, share))
    return out


def _stream_checked(what, planner, start, stop, batch, frames):
    """Stream [start, stop), check every batch (f16, shape, finite) and
    return the picked *frames* as numpy arrays."""
    import torch
    H, W = planner.window.height, planner.window.width
    picked, n_frames = {}, 0
    for s, n, out in planner.iter_batches(start, stop, batch=batch):
        if (out.dtype != torch.float16 or tuple(out.shape) != (n, 4, H, W)
                or not bool(torch.isfinite(out).all())):
            raise AssertionError('%s batch at %d: %s %s' % (
                what, s, out.dtype, tuple(out.shape)))
        for i in frames:
            if s <= i < s + n:
                picked[i] = out[i - s].cpu().numpy()
        n_frames += n
    if n_frames != stop - start or sorted(picked) != sorted(frames):
        raise AssertionError('%s rendered %d frames' % (what, n_frames))
    return picked


def _mixed_slice(tag, window):
    """Phase 6: the mixed-content timeline through the kernels. Returns
    (the timeline, launches)."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner

    ws = timelines.mixed_timeline(256)
    frames = (0, 1, 70)
    _zero_launch_counts()
    picked = _stream_checked('mixed', RenderPlanner(ws, window), 0, 128, 16,
                             frames)
    launches = _launch_counts()
    if min(launches[k] for k in _RENDER_KERNELS) <= 0:
        raise AssertionError('mixed slice ran with launches %r' % launches)
    vs = _vs_pull('mixed', picked, _pull_stack(ws, window, frames))
    print('phase 6 mixed slice: 128 frames of timelines.mixed_timeline(256) '
          'at 1080p via iter_batches(0, 128, batch=16), finite f16; launches '
          '%s; vs the NumPy pull path frame 0 max diff %.3g (%.5f bit-equal), '
          '1 %.3g (%.5f), 70 %.3g (%.5f) (atol 1e-2, >= 0.99) %s'
          % ((json.dumps(launches),) + vs[0] + vs[1] + vs[70] + (tag,)),
          flush=True)
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
    path's shapes, and config7's fps, device busy ms, batches and idle
    share (a dict)."""
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
    for (h, w), oy, ox in regions:
        # the offsets as the path holds them: int32 values on the card
        dy0, dx0 = int(oy), int(ox)
        P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)).to(dev) for s in ((B, 3, H, W), (B, 1, H, W),
                                            (B, 4, h, w))]
        P2, A2 = P.clone(), A.clone()
        before = _instantiation_counts()['region_over']
        cuda_ops.region_over(P, A, layer, oy, ox)
        inst = _instantiation('region_over', before)
        cuda_ops.region_over_plain(P2, A2, layer, oy, ox)
        err = max(err, float((P - P2).abs().max()),
                  float((A - A2).abs().max()))
        k = lambda: cuda_ops.region_over(P, A, layer, oy, ox)
        p = lambda: cuda_ops.region_over_plain(P2, A2, layer, oy, ox)
        tk, tp = paired_ms(k, p, 20, 3)
        ms += tk
        plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        px_all += px
        nbytes = px * 48
        floor = _bound(nbytes, 0)[0]
        print('phase 7 kernel region_over %dx%d @ (%d, %d), batch %d, %s '
              'instantiation: cuda %.4f ms (%.1f GB/s for %.1f MB; byte '
              'floor %.4f ms, time / floor %.3f), plain torch %.4f ms %s'
              % (h, w, dy0, dx0, B, inst, tk, nbytes / tk / 1e6,
                 nbytes / 1e6, floor, tk / floor, tp, tag), flush=True)
    _region_over_total(7, 'f32', ms, _bound(px_all * 48, 0)[0], tag)
    if err != 0.0:
        raise AssertionError('region_over at the path shapes differs from '
                             'plain by %r' % err)

    # per pixel: the layer read (16 B), P and A read and written (32 B)
    return ((err, ms, plain_ms) + _bound(px_all * 48, px_all * OVER_OPS)
            + (dict(fps=fps, busy_ms=busy_ms, batches=len(work), idle=idle,
                    enqueue_ms=enqueue_ms),))


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


def _headline_kernels(batch_work, H, W, B):
    """The headline's kernels on one batch's params (*batch_work*: the
    signature and its params on the card), each against its plain
    version (max diff, must be 0) and timed beside it in turns: the mid
    fold (L=6), the finalize (L=2, to f16) and the two scalers' rank-1
    regions. Returns the rows (name, ms, plain ms, bytes), the summed
    times and the bytes and operations of each kernel's passes."""
    import torch

    from canvas_tpu_torch.backend import paired_ms
    from canvas_tpu_torch.ops import cuda_ops
    from canvas_tpu_torch.render import _scale_solid_factors

    sig, tparams = batch_work
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
    out = {'rows': [], 'fold_ms': 0.0, 'fold_plain_ms': 0.0, 'reg_ms': 0.0,
           'reg_plain_ms': 0.0, 'fold_bytes': 0, 'fold_ops': 0,
           'reg_bytes': 0, 'reg_ops': 0, 'err_reg': 0.0}
    out['err_main'] = max(
        [float((g - w).abs().max()) for g, w in zip(mid(), mid_p())]
        + [float((fin().float() - fin_p().float()).abs().max())])
    if out['err_main'] != 0.0:
        raise AssertionError('solid_fold at the main path shapes differs '
                             'from plain by %r' % out['err_main'])
    for name, k, p, nbytes, fp in (
            ('mid fold L=6', mid, mid_p, 16, folds[0]),
            ('finalize L=2 f16', fin, fin_p, 24, folds[1])):
        tk, tp = paired_ms(k, p, 10, 2)
        out['fold_ms'] += tk
        out['fold_plain_ms'] += tp
        out['rows'].append((name, tk, tp, B * H * W * nbytes))
        # the mid fold writes P and A (16 B/px); the finalize reads them
        # and writes f16 frames (24 B/px)
        L = fp['color'].shape[0]
        out['fold_bytes'] += B * H * W * nbytes + _fold_params_bytes(L, B)
        out['fold_ops'] += B * H * W * (L * FOLD_OPS_PER_LAYER + (
            FINALIZE_OPS if nbytes == 24 else 0))
    for j, (pl, (color, ry, rx)) in enumerate(regions):
        # the offsets as the path holds them: int32 values on the card
        oy, ox = pl['dy0'], pl['dx0']
        dy0, dx0 = int(oy), int(ox)
        h, w = ry.shape[1], rx.shape[1]
        P1, A1 = baseP.clone(), baseA.clone()
        P2, A2 = baseP.clone(), baseA.clone()
        cuda_ops.region_over_sep(P1, A1, color, ry, rx, oy, ox)
        cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx, oy, ox)
        out['err_reg'] = max(out['err_reg'], float((P1 - P2).abs().max()),
                             float((A1 - A2).abs().max()))
        k = lambda: cuda_ops.region_over_sep(P1, A1, color, ry, rx, oy, ox)
        p = lambda: cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx,
                                                   oy, ox)
        tk, tp = paired_ms(k, p, 20, 3)
        out['reg_ms'] += tk
        out['reg_plain_ms'] += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        out['rows'].append(('region %d %dx%d @ (%d, %d)' % (j, h, w, dy0, dx0),
                            tk, tp, px * 32))
        # P and A read and written in the region; color, ry, rx read
        out['reg_bytes'] += px * 32 + B * (4 + h + w) * 4
        out['reg_ops'] += px * (RANK1_OPS + OVER_OPS)
    if out['err_reg'] != 0.0:
        raise AssertionError('region_over_sep at the main path shapes '
                             'differs from plain by %r' % out['err_reg'])
    return out


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
    the path's launches and the fused yuv420 kernel's (max |diff| against
    its plain ops, ms, plain ms, bound ms, bound by) on one batch."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.render import RenderPlanner

    H, W = window.height, window.width
    start, stop, batch = 128, 384, 128
    planner = RenderPlanner(timelines.build_timeline(1024), window)
    planner.plan_cache_segments = 0     # cold: every pass plans anew
    f16 = {s: out.cpu()
           for s, _n, out in planner.iter_batches(start, stop, batch=batch)}
    sizes = {'bgra_u8': (H, W * 4),
             'yuv420': (H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2),)}
    agree = {}
    _zero_launch_counts()
    for post, size in sizes.items():
        n_diff = n_all = worst = n_batches = 0
        posted = _launch_counts()[_POST_KERNEL]
        for s, n, out in planner.iter_batches(start, stop, batch=batch,
                                              post=post):
            n_batches += 1
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
        posted = _launch_counts()[_POST_KERNEL] - posted
        if posted != (n_batches if post == 'yuv420' else 0):
            raise AssertionError('post %s: %d batches, %d yuv420_post '
                                 'launches' % (post, n_batches, posted))
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
    post_ms = {}
    # bytes a pixel read and written: bgra_u8's gather reads all four f16
    # planes; the fused yuv420 kernel reads R, G and B and writes Y and
    # the 2x2 Cb and Cr
    for post, read, written in (('bgra_u8', 8, 4), ('yuv420', 6, 1.5)):
        ms = post_ms[post] = cuda_ms(lambda: color_ops.POSTS[post](x16), 5)
        print('phase 9 post %s on one batch of %d %dx%d f16 frames: %.3f ms '
              'on the card (%.1f GB/s for the f16 read and the u8 write) %s'
              % (post, batch, W, H, ms, px * (read + written) / ms / 1e6,
                 tag), flush=True)
    # the kernel's bytes against its plain ops' on the same card batch
    posted = _launch_counts()[_POST_KERNEL]
    got = color_ops.yuv420_pack_studio(x16)
    if _launch_counts()[_POST_KERNEL] - posted != 1:
        raise AssertionError('yuv420_pack_studio on the card made %d '
                             'yuv420_post launches' % (
                                 _launch_counts()[_POST_KERNEL] - posted))
    want = color_ops.yuv420_pack_studio_plain(x16)
    err = int((got.int() - want.int()).abs().max())
    if got.shape != want.shape or err != 0:
        raise AssertionError('yuv420_post differs from its plain ops by %d '
                             '(%s, %s)' % (err, tuple(got.shape),
                                           tuple(want.shape)))
    del got, want
    plain_ms = cuda_ms(lambda: color_ops.yuv420_pack_studio_plain(x16), 3)
    kernel = (err, post_ms['yuv420'], plain_ms) + _bound(
        px * YUV420_BYTES, px * YUV420_OPS)
    print('phase 9 yuv420_post kernel %.4f ms, its plain ops %.3f ms, max '
          '|diff| %d against them (must be 0), bound %.4f ms (%s: %.1f B/px '
          'at 3.35 TB/s), %.2fx the bound %s'
          % (post_ms['yuv420'], plain_ms, err, kernel[3], kernel[4],
             YUV420_BYTES, post_ms['yuv420'] / kernel[3], tag), flush=True)
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
    return launches, kernel


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
        oy, ox = pl['dy0'], pl['dx0']       # int32 values on the card
        dy0, dx0 = int(oy), int(ox)
        h, w = ry.shape[1], rx.shape[1]
        P1, A1 = baseP.clone(), baseA.clone()
        P2, A2 = baseP.clone(), baseA.clone()
        cuda_ops.region_over_sep(P1, A1, color, ry, rx, oy, ox)
        cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx, oy, ox)
        err = max(err, _max_diff((P1, A1), (P2, A2)))
        k = lambda: cuda_ops.region_over_sep(P1, A1, color, ry, rx, oy, ox)
        p = lambda: cuda_ops.region_over_sep_plain(P2, A2, color, ry, rx,
                                                   oy, ox)
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
    for (h, w), oy, ox in shapes:
        dy0, dx0 = int(oy), int(ox)         # oy, ox: int32 on the card
        P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)).to(dev).to(bf) for s in ((B, 3, H, W), (B, 1, H, W),
                                                  (B, 4, h, w))]
        P2, A2 = P.clone(), A.clone()
        before = _instantiation_counts()['region_over']
        cuda_ops.region_over(P, A, layer, oy, ox)
        inst = _instantiation('region_over', before)
        cuda_ops.region_over_plain(P2, A2, layer, oy, ox)
        err = max(err, _max_diff((P, A), (P2, A2)))
        k = lambda: cuda_ops.region_over(P, A, layer, oy, ox)
        p = lambda: cuda_ops.region_over_plain(P2, A2, layer, oy, ox)
        tk, tp = paired_ms(k, p, 20, 3)
        ms += tk
        plain_ms += tp
        px = B * min(h, H - dy0) * min(w, W - dx0)
        px_all += px
        floor = _bound(px * 24, 0)[0]
        print('phase 10 kernel region_over bf16 %dx%d @ (%d, %d), batch %d, '
              '%s instantiation: cuda %.4f ms (%.1f GB/s for %.1f MB; byte '
              'floor %.4f ms, time / floor %.3f), plain torch %.4f ms %s'
              % (h, w, dy0, dx0, B, inst, tk, px * 24 / tk / 1e6,
                 px * 24 / 1e6, floor, tk / floor, tp, tag), flush=True)
    _region_over_total(10, 'bf16', ms, _bound(px_all * 24, 0)[0], tag)
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

    rate, seconds = Fraction(60, 1), 3.0
    out = []
    with _Warnings('canvas_tpu_torch.playback',
                   'render batch failed') as failures:
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
                    label, failures.seen[0]))
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
    count nowhere). Returns (launches, the bf16 timings, the latencies
    of ``_display_latency``)."""
    import torch

    from canvas_tpu_torch import timelines

    ws = timelines.build_timeline(1024)
    _zero_launch_counts()
    _display_vs_cpu(tag, ws, window)
    seen = _launch_counts()
    if min(seen['solid_fold'], seen['region_over_sep']) <= 0:
        raise AssertionError('render_display ran with launches %r' % seen)
    latency = _display_latency(tag, ws, window)
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
    return launches, _bf16_timings(tag, p9, mixed5, window), latency



def _cold_fps(make_planner, start, stop, batch):
    """(fps, walls, device busy ms, idle share) of a cold stream: a new
    planner with no stage cache and no plan cache, one warm pass, best of
    3; then the same batches prepared beforehand and replayed back to
    back for the device's busy time."""
    import torch

    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.render import params_to_torch, run

    dev = torch.device('cuda')
    planner = make_planner()
    planner.stage_cache_mb = 0
    planner.plan_cache_segments = 0
    _stream_wall(planner, start, stop, batch)
    walls = [_stream_wall(planner, start, stop, batch) for _rep in range(3)]
    work = []
    for seg in planner.segments(start, stop, min_span=batch):
        _s0, sig, batches = planner._prepare(seg, batch)
        work += [(sig, params_to_torch(pl, dev)) for _p, _t, pl in batches]
    torch.cuda.synchronize()
    busy = cuda_ms(lambda: [run(sg, tp, dev) for sg, tp in work], 3)
    wall = min(walls)
    return (stop - start) / wall, walls, busy, 1.0 - busy / (wall * 1e3), work


def _coded_clips(tag):
    """Phase 11.1-11.3: the pulldown clip, the planar clip, and the mixed
    timeline with one clip under pulldown removal. Returns the launches
    of the composite."""
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.coded import Pulldown23RemovalFilter
    from canvas_tpu_torch.render import RenderPlanner, _eval, box2i

    dev = torch.device('cuda')
    src, window = timelines.pulldown_clip(), timelines.PULLDOWN_WINDOW
    frames = (0, 1, 2, 3, 70)
    picked = _stream_checked('pulldown', RenderPlanner(src, window), 0, 128,
                             16, frames)
    vs = _vs_pull('pulldown', picked, _pull_stack(src, window, frames))
    fps, walls, busy, idle, _work = _cold_fps(
        lambda: RenderPlanner(src, window), 0, 128, 16)
    print('phase 11 pulldown clip: 128 frames of timelines.pulldown_clip() at '
          '%dx%d via iter_batches(0, 128, batch=16), finite f16; vs the NumPy '
          'pull path %s (atol 1e-2, >= 0.99 bit-equal); '
          'config3_dv_reconstruct_pulldown_fps %.1f (best of 3 cold passes, '
          'stage cache and plan cache off; walls %s s); device busy %.3f ms, '
          'device idle share %.3f %s'
          % (window.width, window.height, ', '.join(
              'frame %d max diff %.3g (%.5f)' % ((i,) + vs[i])
              for i in frames), fps, ', '.join('%.4f' % w for w in walls),
             busy, idle, tag), flush=True)

    src, window = timelines.planar_clip(64), box2i(*WINDOW)
    frames = (0, 1, 20, 47)
    picked = _stream_checked('planar', RenderPlanner(src, window), 0, 48, 8,
                             frames)
    vs = _vs_pull('planar', picked, _pull_stack(src, window, frames))
    fps, walls, busy, idle, work = _cold_fps(
        lambda: RenderPlanner(src, window), 0, 48, 8)
    print('phase 11 planar clip: 48 frames of timelines.planar_clip(64) at '
          '%dx%d via iter_batches(0, 48, batch=8), finite f16; vs the NumPy '
          'pull path %s (atol 1e-2, >= 0.99 bit-equal); '
          'config8_1080p_decoded_planar_fps %.1f, decode bypassed (seeded '
          'planes stand in for the decoder; best of 3 cold passes, stage '
          'cache and plan cache off; walls %s s); device busy %.3f ms, device '
          'idle share %.3f %s'
          % (window.width, window.height, ', '.join(
              'frame %d max diff %.3g (%.5f)' % ((i,) + vs[i])
              for i in frames), fps, ', '.join('%.4f' % w for w in walls),
             busy, idle, tag), flush=True)
    # planar_recon_rows alone, on the first batch's params: the root is a
    # 'place' whose only child is the reconstruction
    sig, tparams = work[0]
    if sig[0] != 'place' or sig[3][0][0] != 'planar_recon_rows':
        raise AssertionError('unexpected planar plan %r' % (sig[0],))
    p = tparams[1]
    ms = cuda_ms(lambda: _eval(sig[3][0], iter(tparams[1:]), dev), 5)
    B, (H, W) = p['rows'].shape[0], p['py'].shape[1:]
    ch, cw = p['pcb'].shape[1:]
    read = B * (H * W + 2 * ch * cw) + 4 * (W * cw + H * ch + 9 + B)
    wrote = B * 4 * H * W * 4
    ops = 2 * B * (2 * ch * cw * W + 2 * ch * W * H) + B * H * W * 15
    bound, by = _bound(read + wrote, ops)
    print('phase 11 planar_recon_rows (torch ops: three u8 gathers, two dense '
          'f32 contractions a chroma plane, the 3x3 matrix, the f16 grid, the '
          'transfer table), batch %d of %dx%d 4:2:0: %.3f ms on the card; it '
          'reads %.1f MB and writes %.1f MB and does %.1f GFLOP in its dense '
          'form: bound %.3f ms by %s at the published rates %s'
          % (B, W, H, ms, read / 1e6, wrote / 1e6, ops / 1e9, bound, by, tag),
          flush=True)
    del work, tparams, picked
    torch.cuda.empty_cache()

    # The mixed timeline with the clip of layer 2 under pulldown removal:
    # its placed region is a field_interleave of two scaled DV pulls.
    ws = timelines.mixed_timeline(256)
    clip = next(it for it in ws if it.z == 2).source
    clip.source = Pulldown23RemovalFilter(clip.source, 0)
    window = box2i(*WINDOW)
    planner = RenderPlanner(ws, window)
    if 'field_interleave' not in planner.explain(1, 17):
        raise AssertionError('the composite plans no field_interleave')
    _zero_launch_counts()
    picked = _stream_checked('pulldown composite', planner, 0, 32, 16, (2,))
    launches = _launch_counts()
    if min(launches[k] for k in _RENDER_KERNELS) <= 0:
        raise AssertionError('pulldown composite ran with launches %r'
                             % launches)
    vs = _vs_pull('pulldown composite', picked, _pull_stack(ws, window, (2,)))
    print('phase 11 pulldown composite: frames 0..31 of '
          'timelines.mixed_timeline(256) with the clip of layer 2 under '
          'Pulldown23RemovalFilter(..., 0), batch 16, finite f16; launches '
          '%s; frame 2 (mixed cadence) vs the NumPy pull path max diff %.3g '
          '(%.5f bit-equal) %s' % (json.dumps(launches), vs[2][0], vs[2][1],
                                   tag), flush=True)
    return launches


def _replay(tag, name, metrics, ws, window, start, stop, batch, elsewhere,
            edit, counted):
    """Phase 11.4: a cached replay of [start, stop). The first pass plans
    and stages; three replays (the b metric), three more each after an
    edit at *elsewhere*, outside the range (the c metric), each with its
    segments planned, coded
    frames pulled and host-to-device copies; the replay's device busy time
    and idle share; then an edit inside, at *edit*, and one more pass.
    *metrics* names the b and the c metric; *counted* is the coded source
    class whose pulls count, or None.
    Returns the path's launches."""
    import torch

    from canvas_tpu_torch import backend
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.render import RenderPlanner, run

    dev = torch.device('cuda')
    planner = RenderPlanner(ws, window)
    planned, pulls = [], []
    plan_context = planner._plan_context

    def counting_context(seg, mesh=None):
        planned.append(seg)
        return plan_context(seg, mesh)

    planner._plan_context = counting_context
    get_frame = counted.get_frame if counted is not None else None
    if counted is not None:
        def counting_get_frame(self, frame_index, quality=0):
            pulls.append(frame_index)
            return get_frame(self, frame_index, quality)
        counted.get_frame = counting_get_frame

    def one_pass():
        planned.clear()
        pulls.clear()
        h2d = dict(backend.transfer_stats)
        wall = _stream_wall(planner, start, stop, batch)
        return (wall, list(planned), len(pulls),
                backend.transfer_stats['h2d_calls'] - h2d['h2d_calls'],
                backend.transfer_stats['h2d_bytes'] - h2d['h2d_bytes'])

    try:
        _zero_launch_counts()
        first = one_pass()
        segs = planner.segments(start, stop, min_span=batch)
        if first[1] != segs:
            raise AssertionError('%s first pass planned %r' % (name, first[1]))
        passes = {'b': [one_pass() for _rep in range(3)], 'c': []}
        for _rep in range(3):
            planner.invalidate_display_cache(*elsewhere)
            passes['c'].append(one_pass())
        launches = _launch_counts()
        for kind, runs in passes.items():
            for wall, pl, n_pulls, calls, nbytes in runs:
                if pl or n_pulls:
                    raise AssertionError(
                        '%s replay (%s) planned %r and pulled %d coded frames'
                        % (name, kind, pl, n_pulls))
        work = [(pr.sig, params) for (pr, _b) in planner._plan_cache.values()
                for params in pr.plists]
        busy = cuda_ms(lambda: [run(sg, tp, dev) for sg, tp in work], 3)
        best = {k: min(r[0] for r in runs) for k, runs in passes.items()}
        planner.invalidate_display_cache(*edit)
        after = one_pass()
        touched = [sg for sg in segs if sg[0] <= edit[1] and edit[0] < sg[1]]
        if after[1] != touched or not touched or len(touched) == len(segs):
            raise AssertionError('%s after an edit at %r planned %r, not %r'
                                 % (name, edit, after[1], touched))
    finally:
        if counted is not None:
            counted.get_frame = get_frame
    n = stop - start
    print('phase 11 replay %s: frames %d..%d, batch %d, caches on; first pass '
          '%.4f s (%d segments planned, %d coded frames pulled, %d '
          'host-to-device copies, %.1f MB); replays: %s; device busy %.3f ms '
          'of the best replay\'s %.3f ms wall, device idle share %.3f; after '
          'invalidate_display_cache%r: %.4f s, segments %s planned again of '
          '%s, %d coded frames pulled %s'
          % (name, start, stop - 1, batch, first[0], len(first[1]), first[2],
             first[3], first[4] / 1e6, '; '.join(
                 '%s %.1f fps (best of 3%s; walls %s s; segments planned %s, '
                 'coded frames pulled %s, host-to-device copies %s)'
                 % (metric, n / best[k],
                    ', each after invalidate_display_cache%r' % (elsewhere,)
                    if k == 'c' else '',
                    ', '.join('%.4f' % r[0] for r in passes[k]),
                    [len(r[1]) for r in passes[k]],
                    [r[2] for r in passes[k]], [r[3] for r in passes[k]])
                 for k, metric in zip('bc', metrics)),
             busy, best['b'] * 1e3, 1.0 - busy / (best['b'] * 1e3), edit,
             after[0], after[1], segs, after[2], tag), flush=True)
    planner.close()
    return launches


def _pacing(tag, ws, window):
    """Phase 11.5: iter_batches(max_inflight=2) over the headline.
    Frames 0..511 at batch 128, paced and unpaced in lockstep, bit-equal;
    then frames 0..1023 streamed without looking at the outputs, an event
    recorded after each batch is handed over: the most events not yet
    complete at that moment is the most batches queued ahead of the
    device."""
    import torch

    from canvas_tpu_torch.render import RenderPlanner

    a, b = RenderPlanner(ws, window), RenderPlanner(ws, window)
    n = 0
    for (s1, n1, o1), (s2, n2, o2) in zip(
            a.iter_batches(0, 512, batch=128),
            b.iter_batches(0, 512, batch=128, max_inflight=2)):
        if (s1, n1) != (s2, n2) or not torch.equal(o1, o2):
            raise AssertionError('paced batch at %d differs' % s1)
        n += n1
    if n != 512:
        raise AssertionError('paced stream gave %d frames' % n)
    del o1, o2
    queued = {}
    for depth in (None, 2, 1):
        for _out in b.iter_batches(0, 1024, batch=128):
            pass                                # the plans are cached now
        torch.cuda.synchronize()
        events, most = [], 0
        for _s, _n, _out in b.iter_batches(0, 1024, batch=128,
                                           max_inflight=depth):
            done = torch.cuda.Event()
            done.record()
            events.append(done)
            most = max(most, sum(not e.query() for e in events))
        torch.cuda.synchronize()
        queued[depth] = most
    print('phase 11 pacing: headline frames 0..511 at batch 128 with '
          'max_inflight=2 bit-equal to the unpaced stream; over frames '
          '0..1023 (8 batches, plans cached) the most batches queued ahead '
          'of the device: unpaced %d, max_inflight=2 %d, max_inflight=1 %d '
          '%s' % (queued[None], queued[2], queued[1], tag), flush=True)
    if queued[2] > 2 or queued[1] > 1:
        raise AssertionError('pacing let %r batches queue' % (queued,))


def _guard(tag, ws, window):
    """Phase 11.6: the memory guard's estimate for batch 128 at 1080p,
    post=None, beside the measured peak of that stream; a batch whose
    estimate exceeds the card's memory raises before any launch."""
    import torch

    from canvas_tpu_torch.render import RenderPlanner, _hbm_estimate_bytes

    planner = RenderPlanner(ws, window)
    planner.plan_cache_segments = 0
    px = window.width * window.height
    est = _hbm_estimate_bytes(128, window, None, None)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _stream_wall(planner, 128, 512, 128)
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.mem_get_info()[1]
    batch = total // (40 * px) + 8
    _zero_launch_counts()
    try:
        next(planner.iter_batches(0, batch, batch=batch))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError('the guard let batch %d through' % batch)
    if any(_launch_counts().values()) or 'HBM budget' not in refused:
        raise AssertionError('the guard: %r, launches %r'
                             % (refused, _launch_counts()))
    print('phase 11 guard: batch 128 at %dx%d, post=None: estimate %.3f GB '
          '(3 retained f16 outputs and one 16 B/px working stack) beside a '
          'measured peak of %.3f GB above the %.3f GB allocated before '
          '(torch.cuda.max_memory_allocated over frames 128..511, plan cache '
          'off): estimate / peak %.3f; card total %.3f GB; batch %d refused '
          'before any launch: %s %s'
          % (window.width, window.height, est / 1e9, peak / 1e9, base / 1e9,
             est / peak, total / 1e9, batch, refused[:90], tag), flush=True)
    if est < peak:
        raise AssertionError('the memory guard estimates %d bytes below the '
                             'measured peak of %d' % (est, peak))


def _upload_cost(tag, name, planner, seg, batch):
    """One segment's params to the card, a copy for every array
    (backend.to_device) beside one packed copy a batch (params_to_torch):
    host ms until the copies are done, median of 7, and the copies
    counted."""
    import numpy as np
    import torch

    from canvas_tpu_torch import backend
    from canvas_tpu_torch.render import params_to_torch

    dev = torch.device('cuda')
    _s0, _sig, batches = planner._prepare(seg, batch)
    plists = [pl for _p, _t, pl in batches]

    def copy_each(plist):
        return [{k: (v if isinstance(v, torch.Tensor)
                     else backend.to_device(np.asarray(v), dev))
                 for k, v in p.items()} for p in plist]

    def timed(fn):
        times = []
        for _rep in range(8):
            torch.cuda.synchronize()
            calls = backend.transfer_stats['h2d_calls']
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return (float(np.median(times[1:])),
                backend.transfer_stats['h2d_calls'] - calls)

    each = timed(lambda: [copy_each(pl) for pl in plists])
    packed = timed(lambda: [params_to_torch(pl, dev) for pl in plists])
    print('phase 11 upload %s segment [%d, %d), %d batches of %d: copy by '
          'copy %.3f ms (%d copies), packed %.3f ms (%d copies) (host clock, '
          'each ending in a synchronize) %s'
          % ((name,) + tuple(seg) + (len(plists), batch) + each + packed
             + (tag,)), flush=True)


def _coded_and_replay(tag, window):
    """Phase 11: coded video and replay. Returns the launches of its
    paths (the composite and both replays) summed."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner

    total = _coded_clips(tag)
    torch.cuda.empty_cache()
    mixed = timelines.mixed_timeline(256)
    headline = timelines.build_timeline(1024)
    for launches in (
            _replay(tag, 'mixed',
                    ('config7b_mixed_content_cached_replay_fps',
                     'config7c_replay_while_editing_elsewhere_fps'),
                    mixed, window, 0, 128, 16, (500, 600), (0, 10),
                    timelines.RolledDV),
            _replay(tag, 'headline',
                    ('headline_cached_replay_fps',
                     'headline_replay_while_editing_elsewhere_fps'),
                    headline, window, 128, 512, 128, (600, 700), (130, 140),
                    None)):
        total = {k: total[k] + launches[k] for k in total}
    torch.cuda.empty_cache()
    _pacing(tag, headline, window)
    torch.cuda.empty_cache()
    _guard(tag, headline, window)
    _upload_cost(tag, 'headline', RenderPlanner(headline, window),
                 (128, 256), 128)
    _upload_cost(tag, 'mixed', RenderPlanner(mixed, window), (1, 65), 16)
    print('phase 11 coded video and replay: launches %s %s'
          % (json.dumps(total), tag), flush=True)
    return total


def _export_4k(tag):
    """Phase 12: config6 and config6b, the headline exported at 4K
    (benchmarks.py:549-602): frames 0..63 of timelines.build_timeline(1024)
    at timelines.CONFIG6_WINDOW through iter_batches(batch=8,
    post='rgba_u8') and (post='yuv420'), plan cache off, the batches left
    on the card as benchmarks.py leaves them (device_out=True: nothing is
    fetched); one warm pass, best of 3. Beside each: the device busy time
    of the same batches replayed and the idle share, the post's device
    time per batch, the replay's device time by kernel (torch.profiler),
    the memory guard's estimate beside the measured peak,
    frames 0 and 63 against the CPU's conversion of the card's own f16
    frames, and one f16 frame against the NumPy pull path; then the
    headline's kernels at 4K, batch 8, beside their byte floors. Returns
    the launches of each post's first pass summed: the counters are set
    to 0 just before it and read just after, before the walls, the
    replays and the profiler launch the kernels again."""
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.render import (RenderPlanner, _hbm_estimate_bytes,
                                         params_to_torch, run)

    dev = torch.device('cuda')
    window = timelines.CONFIG6_WINDOW
    H, W = window.height, window.width
    start, stop, batch = 0, 64, 8
    ws = timelines.build_timeline(1024)
    planner = RenderPlanner(ws, window)
    planner.plan_cache_segments = 0     # cold, as benchmarks.py
    picked = {}
    for s, n, out in planner.iter_batches(start, stop, batch=batch):
        for i in (0, 63):
            if s <= i < s + n:
                picked[i] = out[i - s].clone()
    want0 = _numpy_pull(ws, 0, window)
    err_pull = float(np.abs(picked[0].cpu().numpy().astype(np.float32)
                            - want0.astype(np.float32)).max())
    if not bool(torch.isfinite(picked[0]).all()) or err_pull > 2e-3:
        raise AssertionError('4K frame 0 differs from the pull path by %r'
                             % err_pull)
    work = []
    for seg in planner.segments(start, stop, min_span=batch):
        _s0, sig, batches = planner._prepare(seg, batch)
        work += [(sig, params_to_torch(pl, dev)) for _p, _t, pl in batches]
    # frame 0 is a segment of its own (an item's plan cut at frame 1):
    # the kernels are timed on the first batch of 8
    full = next(w for w in work if w[1][1]['color'].shape[1] == batch)
    metrics = {'rgba_u8': 'config6_4k_10layer_export_path_fps',
               'yuv420': 'config6b_4k_export_yuv420_transport_fps'}
    launches = dict.fromkeys(_launch_counts(), 0)
    for post, metric in metrics.items():
        agree = {}
        n_batches = 0
        # the main path's counts: this pass alone, read before the walls,
        # the replays and the profiler launch the kernels again
        _zero_launch_counts()
        for s, n, out in planner.iter_batches(start, stop, batch=batch,
                                              post=post):
            n_batches += 1
            for i in (0, 63):
                if s <= i < s + n:
                    got = out[i - s:i - s + 1].cpu().int()
                    want = color_ops.POSTS[post](picked[i][None].cpu()).int()
                    d = (got - want).abs()
                    agree[i] = (float((d != 0).float().mean()), int(d.max()))
        seen = _launch_counts()
        # the headline folds its solids in two runs, one under and one
        # over its two scalers: 2 solid_fold and 2 region_over_sep a batch
        want_seen = dict.fromkeys(seen, 0)
        want_seen.update(solid_fold=2 * n_batches,
                         region_over_sep=2 * n_batches)
        want_seen[_POST_KERNEL] = n_batches if post == 'yuv420' else 0
        if seen != want_seen:
            raise AssertionError('4K export post=%r ran %d batches with '
                                 'launches %r' % (post, n_batches, seen))
        launches = {k: launches[k] + seen[k] for k in launches}
        if any(wd > 1 or sh > 1e-3 for sh, wd in agree.values()):
            raise AssertionError('%s differs from the CPU: %r' % (post, agree))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _stream_wall(planner, start, stop, batch, post)
        walls = [_stream_wall(planner, start, stop, batch, post)
                 for _rep in range(3)]
        peak = torch.cuda.max_memory_allocated() - base
        wall = min(walls)

        def replay():
            for sg, tp in work:
                run(sg, tp, dev, post)

        busy = cuda_ms(replay, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        kernels, device_ms = _profile_kernels(replay)
        x16 = run(*full, dev)
        post_ms = cuda_ms(lambda: color_ops.POSTS[post](x16), 5)
        del x16
        est = _hbm_estimate_bytes(batch, window, post, None)[0]
        print('phase 12 %s %.1f (headline at %dx%d, frames %d..%d, '
              'iter_batches(batch=%d, post=%r), batches left on the card, '
              'plan cache off; best of 3 after one warm pass; walls %s s; '
              'the checked pass: %d batches, launches %s); '
              'the %d batches replayed back to back: %.3f ms (CUDA events), '
              'host enqueue %.3f ms, device time %.3f ms (torch.profiler), '
              'device idle share %.3f; the post %.3f ms a batch of %d on the '
              'card; memory guard estimate %.3f GB beside a measured peak of '
              '%.3f GB (ratio %.3f); frames 0 and 63 vs the CPU conversion of '
              'the card\'s f16 frames %s (at most 1 on at most 0.1%%) %s'
              % (metric, (stop - start) / wall, W, H, start, stop - 1, batch,
                 post, ', '.join('%.4f' % w for w in walls), n_batches,
                 json.dumps(seen), len(work), busy,
                 enqueue_ms, device_ms, 1.0 - device_ms / (wall * 1e3),
                 post_ms, batch, est / 1e9, peak / 1e9, est / peak, ', '.join(
                     'frame %d %.4g differ, max %d' % ((i,) + agree[i])
                     for i in sorted(agree)), tag), flush=True)
        if est < peak:
            raise AssertionError('the memory guard estimates %d bytes for '
                                 'post=%r below the measured peak of %d'
                                 % (est, post, peak))
        for name, ms, calls in kernels[:6]:
            print('phase 12 %s replay kernel %.3f ms (%.1f%%), %d calls: %s'
                  % (post, ms, 100.0 * ms / device_ms, calls, name[:120]),
                  flush=True)
    print('phase 12 4K frame 0 vs the NumPy pull path: max diff %.3g (atol '
          '2e-3); launches of the two checked passes %s %s'
          % (err_pull, json.dumps(launches), tag), flush=True)
    kern = _headline_kernels(full, H, W, batch)
    for name, tk, tp, nbytes in kern['rows']:
        floor = _bound(nbytes, 0)[0]
        print('phase 12 kernel %s at %dx%d, batch %d: cuda %.4f ms (byte '
              'floor %.4f ms, time / floor %.2f), plain torch %.4f ms %s'
              % (name, W, H, batch, tk, floor, tk / floor, tp, tag),
              flush=True)
    return launches


def _editor_headline(tag, window, head, p5):
    """Phase 13(a): the editor's headline project (``editor_headline``:
    ten Clips in ten lanes, through the editor's graph managers) over
    frames 128..511, iter_batches(batch=128), plan cache off, every batch
    bit-equal to *head* (phase 5's planner over build_timeline(1024)) in
    this run, with the same launches a batch and the same plan signature;
    then its cold fps (phase 5's protocol), device busy time, idle share
    and planning ms per segment beside the headline's. The headline's
    comparison pass runs first and counts apart. Returns the project's
    (asset list, space asset, video stream) and the launches of the
    checked pass."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.render import (RenderPlanner, params_to_torch, run,
                                         signature)

    dev = torch.device('cuda')
    start, stop, batch = 128, 512, 128
    _zero_launch_counts()
    want = [(s, n, out.clone()) for s, n, out in
            head.iter_batches(start, stop, batch=batch)]
    head_seen = _launch_counts()
    assets, space_asset = timelines.editor_headline(1024)
    video = timelines.editor_video(space_asset)
    planner = RenderPlanner(video, window)
    planner.plan_cache_segments = 0     # cold, as phase 5
    _zero_launch_counts()
    got = [(s, n, out.clone()) for s, n, out in
           planner.iter_batches(start, stop, batch=batch)]
    seen = _launch_counts()
    if [(s, n) for s, n, _o in got] != [(s, n) for s, n, _o in want]:
        raise AssertionError('editor headline batches %r, headline %r' % (
            [(s, n) for s, n, _o in got], [(s, n) for s, n, _o in want]))
    for (s, _n, g), (_s, _n2, w) in zip(got, want):
        if g.dtype != torch.float16 or not torch.equal(g, w):
            raise AssertionError('editor headline batch at %d differs from '
                                 'the headline by %r' % (
                                     s, float((g.float() - w.float())
                                              .abs().max())))
    n_batches = len(got)
    per_batch = dict.fromkeys(seen, 0)
    per_batch.update(solid_fold=2 * n_batches,
                     region_over_sep=2 * n_batches)
    if seen != head_seen or seen != per_batch:
        raise AssertionError('editor headline launches %r, headline %r'
                             % (seen, head_seen))
    del got, want
    segs = planner.segments(start, stop, min_span=batch)
    if segs != head.segments(start, stop, min_span=batch):
        raise AssertionError('editor headline segments %r' % (segs,))
    plan_ms = {'editor': [], 'headline': []}
    for seg in segs:
        sigs = []
        for key, p in (('editor', planner), ('headline', head)):
            t0 = time.perf_counter()
            node = p._plan(seg)
            plan_ms[key].append((time.perf_counter() - t0) * 1e3)
            sigs.append(signature(node))
        if sigs[0] != sigs[1]:
            raise AssertionError('editor headline segment %r plans another '
                                 'signature' % (seg,))
    _stream_wall(planner, start, stop, batch)
    walls = [_stream_wall(planner, start, stop, batch) for _rep in range(3)]
    wall = min(walls)
    work = []
    for seg in segs:
        _s0, sig, batches = planner._prepare(seg, batch)
        work += [(sig, params_to_torch(pl, dev)) for _p, _t, pl in batches]
    torch.cuda.synchronize()
    busy = cuda_ms(lambda: [run(sg, tp, dev) for sg, tp in work], 3)
    del work
    print('phase 13a editor headline: editor_headline(1024) frames %d..%d '
          'via iter_batches(batch=%d), plan cache off: %d batches bit-equal '
          'to phase 5\'s planner over build_timeline(1024) (max diff 0), '
          'launches %s beside the headline\'s %s (1 mid fold + 1 finalize + '
          '2 region_over_sep a batch), the same plan signature on segments '
          '%s %s' % (start, stop - 1, batch, n_batches, json.dumps(seen),
                     json.dumps(head_seen), segs, tag), flush=True)
    print('phase 13a editor headline timing: %.1f fps cold (best of 3 after '
          'one warm pass; walls %s s) beside phase 5\'s '
          '1080p_10layer_composite_fps_per_chip %.1f; device busy %.3f ms of '
          '%.3f ms wall (phase 5 %.3f ms), device idle share %.3f (phase 5 '
          '%.3f); planning ms per segment %s beside the headline\'s %s %s'
          % ((stop - start) / wall, ', '.join('%.4f' % w for w in walls),
             p5['fps'], busy, wall * 1e3, p5['busy_ms'],
             1.0 - busy / (wall * 1e3), p5['idle'],
             ', '.join('%.2f' % m for m in plan_ms['editor']),
             ', '.join('%.2f' % m for m in plan_ms['headline']), tag),
          flush=True)
    planner.close()
    return assets, space_asset, video, seen


def _editor_edit(tag, window, space_asset, video):
    """Phase 13(b): an undoable edit on the card, plan cache on. A first
    pass over frames 0..511 (batch 128); AdjustClipLengthCommand trims
    the white strip's clip to 300 frames (dirty range [300, 1023]): the
    next pass plans again no segment that ends at or before frame 300,
    and its frames 299 and 300 are within 2e-3 of the edited project's
    NumPy pull; undo(), and frames 128..511 are bit-equal to the first
    pass's. Returns the launches of the three passes."""
    import numpy as np
    import torch

    from canvas_tpu_torch.editor import model
    from canvas_tpu_torch.render import RenderPlanner

    start, stop, batch = 0, 512, 128
    planner = RenderPlanner(video, window)
    planned = []
    plan_context = planner._plan_context

    def counting_context(seg, mesh=None):
        planned.append(seg)
        return plan_context(seg, mesh)

    planner._plan_context = counting_context
    _zero_launch_counts()

    def one_pass(keep):
        planned.clear()
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s, n, o in planner.iter_batches(start, stop, batch=batch):
            if keep(s, n):
                out.append((s, n, o.clone()))
        torch.cuda.synchronize()
        return out, list(planned), time.perf_counter() - t0

    first, first_planned, first_wall = one_pass(lambda s, n: s + n > 128)
    strip = next(it for it in space_asset.space
                 if it.source.asset_path == 'strip')
    stack = model.UndoStack()
    stack.push(model.AdjustClipLengthCommand(strip, 300 - strip.length))
    edited, again, edited_wall = one_pass(
        lambda s, n: s <= 300 and s + n > 299)
    # the first pass's segments that end at or before frame 300 hold no
    # dirty frame: none may plan again (the trim adds a cut at 300, so
    # the segment that now ends there is new and plans once)
    early = [sg for sg in first_planned if sg[1] <= 300]
    if set(early) & set(again) or not again or not early:
        raise AssertionError('after the trim the planner planned %r again '
                             '(first pass %r)' % (again, first_planned))
    errs = {}
    for f in (299, 300):
        s, n, out = next(b for b in edited if b[0] <= f < b[0] + b[1])
        got = out[f - s].float().cpu().numpy()
        want = _numpy_pull(video, f, window, 'float32')
        errs[f] = float(np.abs(got - want).max())
        if not np.isfinite(got).all() or errs[f] > 2e-3:
            raise AssertionError('edited frame %d differs from the pull path '
                                 'by %r' % (f, errs[f]))
    del edited
    stack.undo()
    back, back_planned, back_wall = one_pass(lambda s, n: s + n > 128)
    seen = _launch_counts()
    if [(s, n) for s, n, _o in back] != [(s, n) for s, n, _o in first]:
        raise AssertionError('after undo the batches are %r' % (
            [(s, n) for s, n, _o in back],))
    for (s, n, g), (_s, _n, w) in zip(back, first):
        lo = max(128 - s, 0)
        if not torch.equal(g[lo:n], w[lo:n]):
            raise AssertionError('after undo the batch at %d differs from '
                                 'the first pass' % s)
    print('phase 13b undoable edit, plan cache on: first pass over frames '
          '%d..%d %.4f s (segments planned %s); AdjustClipLengthCommand '
          'trims the strip to 300 frames: %.4f s, segments planned %s (none '
          'of the first pass\'s that end at or before frame 300), frames '
          '299 and 300 vs the '
          'edited project\'s NumPy pull max diff %.3g and %.3g (atol 2e-3); '
          'undo(): %.4f s, segments planned %s, frames 128..511 bit-equal to '
          'the first pass %s'
          % (start, stop - 1, first_wall, first_planned, edited_wall, again,
             errs[299], errs[300], back_wall, back_planned, tag), flush=True)
    planner.close()
    return seen


def _editor_cut(tag, window, c7):
    """Phase 13(c): ``editor_cut(256)`` (a Sequence of three DV clips
    with two 12-frame crossfades between the headline's background and
    white strip), frames 0..127 via iter_batches(batch=16), cold (no
    stage cache, so no plan cache): region_over must launch; frames 0,
    58 (in a crossfade), 70 and 110 against the NumPy pull path with
    phase 6's gate; then cold fps, device busy time and idle share, and
    device time per batch beside phase 7's config7. Returns the launches
    of the checked pass."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner

    video = timelines.editor_video(timelines.editor_cut(256)[1])
    frames = (0, 58, 70, 110)
    planner = RenderPlanner(video, window)
    planner.stage_cache_mb = 0
    _zero_launch_counts()
    picked = _stream_checked('editor cut', planner, 0, 128, 16, frames)
    seen = _launch_counts()
    ro = seen['region_over']
    if ro <= 0:
        raise AssertionError('the editor cut launched no region_over')
    vs = _vs_pull('editor cut', picked, _pull_stack(video, window, frames))

    def make():
        return RenderPlanner(video, window)

    fps, walls, busy, idle, work = _cold_fps(make, 0, 128, 16)
    print('phase 13c editor cut: editor_cut(256) frames 0..127 via '
          'iter_batches(batch=16), stage and plan cache off; region_over '
          'launches %d; vs the NumPy pull path %s (atol 1e-2, >= 0.99); '
          '%.1f fps cold (best of 3; walls %s s) beside phase 7\'s '
          'config7_mixed_content_10layer_fps %.1f; device busy %.3f ms, '
          '%.3f ms a batch of 16 (config7 %.3f), device idle share %.3f '
          '(config7 %.3f) %s'
          % (ro, ', '.join('frame %d max diff %.3g (%.5f bit-equal)'
                           % ((i,) + vs[i]) for i in frames),
             fps, ', '.join('%.4f' % w for w in walls), c7['fps'], busy,
             busy / len(work), c7['busy_ms'] / c7['batches'], idle,
             c7['idle'], tag), flush=True)
    del work
    torch.cuda.empty_cache()
    return seen


def _editor_scrub(tag, window, video, p10):
    """Phase 13(d): render_display of the headline project's stream,
    rgb24 at full size: warm p50 and p95 over frames 1..63 of a cached
    segment beside phase 10's headline numbers; frames 0 and 130 against
    a device='cpu' planner's pull (at most 1 on at most 0.1% of u8
    values). Returns the launches of the card's pulls."""
    import numpy as np

    from canvas_tpu_torch.render import RenderPlanner

    planner = RenderPlanner(video, window)
    kw = dict(transport='rgb24', intent=1.25, display_size=None)
    _zero_launch_counts()
    planner.render_display(1, **kw)

    def pull(i):
        t0 = time.perf_counter()
        planner.render_display(i, **kw)
        return (time.perf_counter() - t0) * 1e3

    warm = [pull(i) for i in range(1, 64)]
    cpu = RenderPlanner(video, window, device='cpu')
    agree = {}
    for f in (0, 130):
        got = planner.render_display(f, **kw).astype(np.int32)
        if f == 130:
            seen = _launch_counts()
        want = cpu.render_display(f, **kw).astype(np.int32)
        if got.shape != (window.height, window.width, 4) or \
                want.shape != got.shape:
            raise AssertionError('editor scrub frame %d: %s vs %s'
                                 % (f, got.shape, want.shape))
        d = np.abs(got - want)
        agree[f] = (int(d.max()), float(np.mean(d != 0)))
        if agree[f][0] > 1 or agree[f][1] > 1e-3:
            raise AssertionError('editor scrub frame %d differs from the CPU '
                                 'by %r' % (f, agree[f]))
    print('phase 13d editor scrub: render_display rgb24 %dx%d of the '
          'headline project: warm p50 %.3f p95 %.3f ms (frames 1..63, '
          'segment cached; host clock) beside phase 10\'s headline p50 %.3f '
          'p95 %.3f; frames 0 and 130 vs a device=\'cpu\' planner %s (at '
          'most 1 on at most 0.1%% of u8 values) %s'
          % (window.width, window.height, float(np.percentile(warm, 50)),
             float(np.percentile(warm, 95)), p10[0], p10[1], ', '.join(
                 'frame %d max |diff| %d on %.3g' % ((f,) + agree[f])
                 for f in sorted(agree)), tag), flush=True)
    planner.close()
    cpu.close()
    return seen


def _u8_linearize_on_card(tag, window):
    """Phase 13(e): a seeded (8, 1080, 1920, 4) u8 batch through the
    port's _eval on a ``u8_linearize`` node, on the card and on the CPU,
    bit-equal; its device time beside its byte floor (4 B/px in, 8 out:
    the planar f16-valued frames the planner keeps)."""
    import numpy as np
    import torch

    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.ir import Node, tile_window
    from canvas_tpu_torch.render import (_eval, flat_params, params_to_torch,
                                         signature)

    dev, cpu = torch.device('cuda'), torch.device('cpu')
    B, H, W = 8, window.height, window.width
    rng = np.random.default_rng(SEED + 13)
    node = Node('u8_linearize', params={
        'data': rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8)},
        windows=tile_window(window, B))
    sig = signature(node)
    on_card = params_to_torch(flat_params(node), dev)
    got = _eval(sig, iter(on_card), dev)
    want = _eval(sig, iter(params_to_torch(flat_params(node), cpu)), cpu)
    err = float((got.cpu() - want).abs().max())
    if got.shape != (B, 4, H, W) or err != 0.0:
        raise AssertionError('u8_linearize on the card differs from the CPU '
                             'by %r (%s)' % (err, tuple(got.shape)))
    ms = cuda_ms(lambda: _eval(sig, iter(on_card), dev), 5)
    floor = _bound(12 * B * H * W, 0)[0]
    print('phase 13e u8_linearize: (%d, %d, %d, 4) u8 -> (%d, 4, %d, %d) on '
          'the card, max diff vs the CPU %r (must be 0); %.4f ms on the card '
          'beside a byte floor of %.4f ms (12 B/px, %.1f MB, time / floor '
          '%.1f) %s' % (B, H, W, B, H, W, err, ms, floor, 12 * B * H * W / 1e6,
                        ms / floor, tag), flush=True)


def _editor(tag, window, head, earlier):
    """Phase 13, the editor on the card. Each of its passes (a)'s checked
    pass after the headline's comparison pass, (b)'s three passes, (c)'s
    checked pass and (d)'s pulls on the card, runs with the launch
    counters set to 0 just before it and read just after; their sum is
    the editor path's launches, which this returns. *earlier* holds the
    numbers printed beside phase 13's: phase 5's and config7's fps,
    device busy ms, batches and idle share, and phase 10's full-size
    latencies."""
    import torch

    assets, space_asset, video, seen = _editor_headline(
        tag, window, head, earlier['phase5'])
    parts = [seen]
    torch.cuda.empty_cache()
    parts.append(_editor_edit(tag, window, space_asset, video))
    torch.cuda.empty_cache()
    parts.append(_editor_cut(tag, window, earlier['config7']))
    parts.append(_editor_scrub(tag, window, video, earlier['display']))
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    torch.cuda.empty_cache()
    _u8_linearize_on_card(tag, window)
    print('phase 13 not driven: the libav plugin\'s file import (the card\'s '
          'machine has no FFmpeg development files to build '
          'native/canvas_av.cpp against; ROADMAP.md queue 1) %s' % tag,
          flush=True)
    print('phase 13 editor path: launches %s (a) %s, (b) %s, (c) %s, (d) %s '
          '%s' % ((json.dumps(launches),) + tuple(json.dumps(p)
                                                   for p in parts) + (tag,)),
          flush=True)
    if min(launches[k] for k in _RENDER_KERNELS) <= 0:
        raise AssertionError('the editor path did not launch every render '
                             'kernel: %r' % launches)
    del assets
    return launches


#: Phase 14's editor session: the audio clock's rate, the play time, the
#: thumbnails (count, size, the window they pull) and the edit's shift.
SESSION_RATE = 48000
SESSION_SECONDS = 3.0
THUMBS = 8
THUMB_SIZE = (160, 90)
SESSION_SHIFT = 40


class _Warnings:
    """Collects the messages of *logger* that hold *text*, for
    the duration of a ``with`` block."""

    def __init__(self, logger, text):
        import logging
        self.logger = logging.getLogger(logger)
        self.text = text
        self.seen = []
        handler = logging.Handler()

        def emit(record):
            # the message, with the exception's last lines where one came
            if text in record.getMessage():
                tail = ''
                if record.exc_info:
                    tail = ': ' + ' | '.join(traceback.format_exception(
                        *record.exc_info)[-3:]).replace('\n', ' ')
                self.seen.append(record.getMessage() + tail)

        handler.emit = emit
        self._handler = handler

    def __enter__(self):
        self.logger.addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self._handler)


class _PullPlans:
    """On the pull queue's worker threads ('canvas-pull*'), for the
    duration of a ``with`` block: the ``RenderPlanner._plan`` calls
    (the segments the thumbnails plan, apart from the playback
    engine's) and the ms spent planning and in ``backend.to_host``
    (the fetch of each rendered frame, which first waits for the
    device to finish it)."""

    def __enter__(self):
        import threading

        from canvas_tpu_torch import backend, render
        self.count = 0
        self.plan_ms = self.fetch_ms = 0.0
        lock = threading.Lock()

        def timed(fn, field):
            def call(*args):
                if not threading.current_thread().name.startswith(
                        'canvas-pull'):
                    return fn(*args)
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    with lock:
                        setattr(self, field, getattr(self, field)
                                + (time.perf_counter() - t0) * 1e3)
                        if field == 'plan_ms':
                            self.count += 1
            return call
        self._undo = [(render.RenderPlanner, '_plan',
                       render.RenderPlanner._plan),
                      (backend, 'to_host', backend.to_host)]
        render.RenderPlanner._plan = timed(render.RenderPlanner._plan,
                                           'plan_ms')
        backend.to_host = timed(backend.to_host, 'fetch_ms')
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)


def _thumbnails(video, window, length, device, card):
    """THUMBS thumbnails of *video* over [0, length) through a
    ``ThumbnailPainter`` on a ``VideoPullQueue(device=device)``. Returns
    (thumbnails, ms from the request to the last delivery, segments the
    pulls planned, launches of the run when *card*, the median ms of a
    pull (plan, render, fetch: a worker) and of a delivery (the NumPy
    scale and gamma: the dispatch thread), and a pull's mean ms planning
    and fetching). A failed pull raises (the queue logs it and delivers
    None)."""
    import numpy as np

    from canvas_tpu_torch.editor.ui import ThumbnailPainter
    from canvas_tpu_torch.pullqueue import VideoPullQueue

    def timed(fn, into):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                into.append((time.perf_counter() - t0) * 1e3)
        return call

    pull_ms, deliver_ms = [], []
    queue = VideoPullQueue(device=device)
    queue._render = timed(queue._render, pull_ms)
    try:
        painter = ThumbnailPainter(video, window=window, size=THUMB_SIZE,
                                   count=THUMBS, queue=queue)
        painter._deliver = timed(painter._deliver, deliver_ms)
        painter.set_range(0, length)
        landed = {}
        painter.thumbnail_ready.connect(
            lambda slot, bgra: landed.__setitem__(slot, time.perf_counter()))
        with _Warnings('canvas_tpu_torch.pullqueue', 'frame pull failed') \
                as failed, _PullPlans() as plans:
            if card:
                _zero_launch_counts()
            t0 = time.perf_counter()
            painter.request_all()
            deadline = t0 + 60.0
            while (len(landed) < THUMBS and not failed.seen
                   and time.perf_counter() < deadline):
                time.sleep(0.002)
            launches = _launch_counts() if card else None
        if failed.seen or len(landed) < THUMBS:
            raise AssertionError('thumbnails: %d of %d arrived in 60 s (%s)'
                                 % (len(landed), THUMBS, failed.seen[:1]))
        thumbs = [painter.thumbnail(s) for s in range(THUMBS)]
        if any(t is None for t in thumbs):
            raise AssertionError('a thumbnail is None')
        return (thumbs, (max(landed.values()) - t0) * 1e3, plans.count,
                launches, float(np.median(pull_ms)),
                float(np.median(deliver_ms)), plans.plan_ms / THUMBS,
                plans.fetch_ms / THUMBS)
    finally:
        queue.close()


def _cpu_presented(video, rate, window, frames):
    """{frame: BGRA} the playback engine presents on the CPU for each of
    *frames*: a ``device='cpu'`` engine (batch 1) on a paused clock
    seeked to each frame in turn."""
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.playback import VideoPlaybackEngine
    from canvas_tpu_torch.process import get_frame_time

    seen = {}
    clock = SystemPresentationClock()
    clock.seek(get_frame_time(rate, frames[0]))
    engine = VideoPlaybackEngine(video, clock, rate, window,
                                 lambda i, f: seen.__setitem__(i, f),
                                 batch=1, device='cpu')
    try:
        for i in frames:
            clock.seek(get_frame_time(rate, i))
            deadline = time.perf_counter() + 60.0
            while i not in seen and time.perf_counter() < deadline:
                time.sleep(0.005)
            if i not in seen:
                raise AssertionError('the CPU engine did not present frame %d'
                                     % i)
    finally:
        engine.stop()
    return seen


def _u8_share(got, want):
    """(largest |difference|, share of values that differ) of two u8
    arrays."""
    import numpy as np
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def _session_audio(np_rng):
    """A seeded tone as an editor asset (``RuntimeSourceAsset`` over the
    port's audio sources, as tests/test_editor_ui.py:1086-1144 builds
    one): its frequency and level drawn from *np_rng*."""
    import numpy as np

    from canvas_tpu_torch import audio
    from canvas_tpu_torch.editor import model, plugins

    freq = float(np_rng.uniform(220.0, 880.0))
    level = float(np_rng.uniform(0.2, 0.5))

    class Tone(audio.AudioSource):
        def _render(self, frame):
            t = np.arange(frame.full_min_sample,
                          frame.full_max_sample + 1) / float(SESSION_RATE)
            tone = level * np.sin(2.0 * np.pi * freq * t)
            frame.data = np.repeat(tone[:, None], frame.channels,
                                   axis=1).astype(np.float32)
            frame.current_min_sample = frame.full_min_sample
            frame.current_max_sample = frame.full_max_sample

    stream = plugins.AudioStream(Tone(), range=(0, SESSION_RATE * 60),
                                 name='audio')
    return model.RuntimeSourceAsset(model.RuntimeSource('tone',
                                                        {'audio': stream})), \
        freq, level


def _editor_session(tag, window, device=None):
    """Phase 14: an editor session through the UI layer's entry points
    (``canvas_tpu_torch.editor.ui``), on *device* (None: the card; the
    CPU for a rehearsal, where nothing launches and the card-vs-CPU
    checks compare the CPU with itself). Each counted pass ((a)'s play,
    (b)'s thumbnails alone and beside playback, (d)'s edit, (e)'s
    thumbnails) runs with the launch counters set to 0 just before it
    and read just after; returns their sum."""
    from fractions import Fraction

    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.audioout import NullSink
    from canvas_tpu_torch.editor.ui import EditorApp
    from canvas_tpu_torch.process import get_time_frame

    card = device is None
    started = time.perf_counter()
    print('phase 14 editor session: EditorApp (audio-master clock, NullSink '
          'at %d Hz) over editor_headline(1024) plus a seeded tone, its '
          'playback engine, thumbnails through a VideoPullQueue while it '
          'plays, paint_timeline, a drag through the scene model, the cut\'s '
          'thumbnails; RenderJob and EditorApp.import_file reach libav, which '
          'needs FFmpeg\'s development files that the card\'s machine lacks: '
          'they run in the CPU tests only (tests/test_torch_editor_ui.py) %s'
          % (SESSION_RATE, tag), flush=True)
    parts = {}

    class Sink(NullSink):
        """The NullSink, counting what it consumed and its peak level."""

        def __init__(self, rate):
            NullSink.__init__(self, rate)
            self.consumed = 0
            self.peak = 0.0

        def write(self, samples):
            n = NullSink.write(self, samples)
            self.consumed += n
            if n:
                self.peak = max(self.peak, float(np.abs(samples[:n]).max()))
            return n

    sink = Sink(SESSION_RATE)
    app = EditorApp(load_plugins=False, audio_master=True,
                    audio_rate=SESSION_RATE, audio_channels=2,
                    audio_sink=sink, device=device)
    engine = None
    try:
        assets, _space = timelines.editor_headline(1024)
        app.set_asset_list(assets)
        assets['tone'], freq, level = _session_audio(
            np.random.default_rng(SEED + 14))
        editor = app.open_space('headline')
        app.add_asset_to_space(editor, 'tone', x=0, length=SESSION_RATE * 60)
        if editor.undo_stack.count() != 1:
            raise AssertionError('add_asset_to_space left %d undo entries'
                                 % editor.undo_stack.count())
        # re-open, as tests/test_editor_ui.py's audio-master test does:
        # the clock takes the space's updated audio graph
        editor = app.open_space('headline')
        rate = Fraction(editor.space.video_format.frame_rate)
        video = editor.video_stream

        # (a) playback under the audio-master clock
        presented, order, batch_ms = {}, [], []

        def present(i, frame):
            presented[i] = frame
            order.append(i)

        engine = editor.start_playback(present, window, batch=4)
        render_batch = engine._render_batch

        def timed(start, stop):
            t0 = time.perf_counter()
            try:
                return render_batch(start, stop)
            finally:
                batch_ms.append((time.perf_counter() - t0) * 1e3)
        engine._render_batch = timed
        engine.warm(0)
        with _Warnings('canvas_tpu_torch.playback',
                       'render batch failed') as failed:
            t0 = app.clock.get_presentation_time()
            c0 = sink.consumed
            if card:
                _zero_launch_counts()
            app.play(1)
            time.sleep(SESSION_SECONDS)
            app.stop()
            parts['a'] = _launch_counts() if card else None
            t1 = app.clock.get_presentation_time()
        consumed = sink.consumed - c0
        last = get_time_frame(rate, t1)
        shown = list(order)
        ideal = last + 1
        skipped = sorted(set(range(ideal)) - set(shown))
        print('phase 14a playback under the audio clock: %d of %d ideal '
              'frames presented (%s fps, %.0f s; %d skipped %s), %d render '
              'batches of 4 at %dx%d, mean %.2f ms; the sink consumed %d '
              'samples against %d (%.3f), peak %.3f (tone %.1f Hz at %.3f); '
              'presentation time advanced %.3f s; launches %s %s'
              % (len(shown), ideal, rate, SESSION_SECONDS, len(skipped),
                 skipped[:12] + (['...'] if len(skipped) > 12 else []),
                 len(batch_ms), window.width, window.height,
                 float(np.mean(batch_ms)), consumed,
                 int(SESSION_SECONDS * SESSION_RATE),
                 consumed / (SESSION_SECONDS * SESSION_RATE), sink.peak, freq,
                 level, (t1 - t0) / 1e9, json.dumps(parts['a']), tag),
              flush=True)
        if any(a >= b for a, b in zip(shown, shown[1:])):
            raise AssertionError('playback presented %r' % shown)
        if 2 * len(shown) < ideal:
            raise AssertionError('playback presented %d of %d frames'
                                 % (len(shown), ideal))
        if consumed < 0.8 * SESSION_SECONDS * SESSION_RATE:
            raise AssertionError('the sink consumed %d samples in %.0f s'
                                 % (consumed, SESSION_SECONDS))
        if abs(sink.peak - level) > 0.01:
            raise AssertionError('the sink heard a peak of %r, the tone is %r'
                                 % (sink.peak, level))
        if failed.seen:
            raise AssertionError('playback: %s' % failed.seen[0])
        if card and min(parts['a']['solid_fold'],
                        parts['a']['region_over_sep']) <= 0:
            raise AssertionError('playback launched %r' % parts['a'])
        picks = [shown[len(shown) // 3], shown[2 * len(shown) // 3]]
        want = _cpu_presented(video, rate, window, picks)
        for i in picks:
            if not np.array_equal(presented[i], want[i]):
                raise AssertionError('presented frame %d differs from the '
                                     'CPU by %r' % (i, _u8_share(
                                         presented[i], want[i])))
        print('phase 14a presented frames %s u8-equal to a device=\'cpu\' '
              'engine\'s %s' % (picks, tag), flush=True)

        # (b) thumbnails alone, then while the engine plays
        full = window
        (thumbs, idle_ms, idle_plans, parts['b idle'], idle_pull,
         idle_deliver, idle_plan_ms, idle_fetch_ms) = _thumbnails(
            video, full, 1024, device, card)
        n0 = len(order)
        f0 = get_time_frame(rate, app.clock.get_presentation_time())
        app.play(1)
        time.sleep(0.5)
        (busy, busy_ms, busy_plans, parts['b busy'], busy_pull,
         busy_deliver, busy_plan_ms, busy_fetch_ms) = _thumbnails(
            video, full, 1024, device, card)
        time.sleep(max(0.0, SESSION_SECONDS - 0.5 - busy_ms / 1e3))
        app.stop()
        playing = order[n0:]
        ideal = get_time_frame(rate, app.clock.get_presentation_time()) - f0
        cpu_thumbs = _thumbnails(video, full, 1024, 'cpu', False)[0]
        for label, got in (('alone', thumbs), ('beside playback', busy)):
            for s, (g, w) in enumerate(zip(got, cpu_thumbs)):
                if g.shape != (THUMB_SIZE[1], THUMB_SIZE[0], 4) or \
                        not np.array_equal(g, w):
                    raise AssertionError('thumbnail %d (%s) differs from the '
                                         'CPU\'s by %r' % (
                                             s, label, _u8_share(g, w)))
        print('phase 14b thumbnails (%d at %dx%d of [0, 1024) from %dx%d, B=1 '
              'planned pulls on two workers): alone %.1f ms to the last '
              'delivery (%.2f ms each; median pull %.2f ms, of which %.2f '
              'planning and %.2f in the fetch, which waits for the device, '
              'on average; median delivery (NumPy scale) %.2f ms), %d '
              'segments planned, launches %s; while the engine plays '
              '%.1f ms (%.2f ms each; pull %.2f, planning %.2f, fetching '
              '%.2f, delivery %.2f), %d segments planned, launches with '
              'playback\'s %s, playback presenting %d of %d ideal frames '
              'over its %.0f s; all u8-equal to the CPU\'s %s'
              % (THUMBS, THUMB_SIZE[0], THUMB_SIZE[1], full.width, full.height,
                 idle_ms, idle_ms / THUMBS, idle_pull, idle_plan_ms,
                 idle_fetch_ms, idle_deliver, idle_plans,
                 json.dumps(parts['b idle']), busy_ms, busy_ms / THUMBS,
                 busy_pull, busy_plan_ms, busy_fetch_ms, busy_deliver,
                 busy_plans,
                 json.dumps(parts['b busy']), len(playing), ideal,
                 SESSION_SECONDS, tag),
              flush=True)
        if any(a >= b for a, b in zip(playing, playing[1:])):
            raise AssertionError('playback beside the thumbnails presented %r'
                                 % playing)

        # (c) the timeline as the editor paints it
        clips = sorted((c for c in editor.space if c.type() == 'video'),
                       key=lambda c: c.y)
        mapping = {c: thumbs[k % THUMBS] for k, c in enumerate(clips)}
        t0 = time.perf_counter()
        painted = editor.paint_timeline(1280, 240, thumbnails=mapping)
        paint_ms = (time.perf_counter() - t0) * 1e3
        cpu_app = EditorApp(load_plugins=False, device='cpu')
        cpu_app.set_asset_list(app.asset_list)
        cpu_editor = cpu_app.open_space('headline')
        cpu_app.seek(app.clock.get_presentation_time())
        cpu_painted = cpu_editor.paint_timeline(1280, 240, thumbnails={
            c: cpu_thumbs[k % THUMBS] for k, c in enumerate(clips)})
        if painted.shape != (240, 1280, 4) or \
                not np.array_equal(painted, cpu_painted):
            raise AssertionError('paint_timeline differs from the CPU\'s '
                                 'by %r' % (_u8_share(painted, cpu_painted),))
        print('phase 14c paint_timeline(1280, 240) with %d clip thumbnails: '
              '%.2f ms (host NumPy), u8-equal to the CPU run\'s %s'
              % (len(mapping), paint_ms, tag), flush=True)

        # (d) an edit through the scene model while paused
        probe = (20, 1030)
        for i in probe:
            engine.display_frame(i)
        before = {i: presented[i].copy() for i in probe}
        strip = [c for c in editor.space
                 if getattr(c.source, 'asset_path', None) == 'strip'][0]
        planner = engine._planner
        plans, ranges = [], []
        plan = planner._plan
        planner._plan = lambda seg: (plans.append(tuple(seg)), plan(seg))[1]
        video.frames_updated.connect(lambda *a: ranges.append(tuple(a[-2:])))
        playhead = engine._playhead
        n0 = len(order)
        x0 = strip.x
        if card:
            _zero_launch_counts()
        t0 = time.perf_counter()
        editor.drag.start(strip, x0 / float(rate), strip.y + 0.5)
        editor.drag.move_to_space((x0 + SESSION_SHIFT) / float(rate),
                                  strip.y + 0.5)
        editor.drag.drop()
        deadline = t0 + 30.0
        while len(order) == n0 and time.perf_counter() < deadline:
            time.sleep(0.002)
        edit_ms = (time.perf_counter() - t0) * 1e3
        parts['d'] = _launch_counts() if card else None
        replanned = list(plans)
        planner._plan = plan
        if strip.x != x0 + SESSION_SHIFT or editor.undo_stack.count() != 1:
            raise AssertionError('the drag left the strip at %d with %d undo '
                                 'entries' % (strip.x,
                                              editor.undo_stack.count()))
        if order[n0:n0 + 1] != [playhead]:
            raise AssertionError('after the edit the engine presented %r, '
                                 'not the paused frame %d'
                                 % (order[n0:], playhead))
        lo = min(-1 if r[0] is None else r[0] for r in ranges)
        hi = max(1 << 30 if r[1] is None else r[1] for r in ranges)
        if not replanned or any(s1 <= lo or s0 > hi for s0, s1 in replanned):
            raise AssertionError('segments planned again %r outside the '
                                 'edit\'s ranges %r' % (replanned, ranges))
        for i in probe:
            engine.display_frame(i)
        moved = {i: presented[i].copy() for i in probe}
        want = _cpu_presented(video, rate, window, list(probe))
        for i in probe:
            if not np.array_equal(moved[i], want[i]):
                raise AssertionError('frame %d after the drag differs from '
                                     'the CPU by %r'
                                     % (i, _u8_share(moved[i], want[i])))
            if np.array_equal(moved[i], before[i]):
                raise AssertionError('frame %d did not change with the drag'
                                     % i)
        editor.undo_stack.undo()
        for i in probe:
            engine.display_frame(i)
            if strip.x != x0 or not np.array_equal(presented[i], before[i]):
                raise AssertionError('frame %d after undo() differs from '
                                     'before the drag' % i)
        print('phase 14d drag: DragController moved the strip by +%d frames '
              '(one undo entry); frames_updated %s; the paused engine planned '
              'again %s and presented frame %d again %.1f ms after the drop; '
              'launches %s; frames %s after the drag u8-equal to the CPU, '
              'after undo() bit-equal to before the drag %s'
              % (SESSION_SHIFT, ranges, replanned, playhead, edit_ms,
                 json.dumps(parts['d']), list(probe), tag), flush=True)

        engine.stop()
        engine = None
        # (e) the cut's thumbnails. Its Sequence spans frames 0..167
        # (three CUT_CLIP clips, two CUT_TRANSITION overlaps): a sampled
        # frame inside it composites one placed region (region_over; a
        # crossfade mixes its two clips into that one region), a frame
        # past it only the two solids (one solid_fold).
        cut_assets, cut_space = timelines.editor_cut(256)
        cut = timelines.editor_video(cut_space)
        seq = [c for c in cut_space.space if hasattr(c, '__len__')][0]
        span = seq.x + seq.length
        sampled = [(256 - 1) * s // (THUMBS - 1) for s in range(THUMBS)]
        inside = sum(1 for f in sampled if seq.x <= f < span)
        (got, cut_ms, cut_plans, parts['e'], cut_pull, cut_deliver,
         cut_plan_ms, cut_fetch_ms) = _thumbnails(cut, full, 256, device,
                                                  card)
        want = _thumbnails(cut, full, 256, 'cpu', False)[0]
        shares = [_u8_share(g, w) for g, w in zip(got, want)]
        print('phase 14e cut thumbnails: %d of editor_cut(256) (frames %s; '
              'its sequence spans %d..%d) in %.1f ms (%.2f ms each; median '
              'pull %.2f ms, planning %.2f, fetching %.2f, delivery %.2f '
              'ms), %d segments planned, launches %s (%d region_over inside '
              'the sequence, %d solid_fold past it); against the CPU\'s: '
              'largest difference %d, share differing %.2e (at most 1 on at '
              'most 0.1%%) %s'
              % (THUMBS, sampled, seq.x, span - 1, cut_ms, cut_ms / THUMBS,
                 cut_pull, cut_plan_ms, cut_fetch_ms, cut_deliver, cut_plans,
                 json.dumps(parts['e']),
                 inside, THUMBS - inside,
                 max(m for m, _s in shares), max(s for _m, s in shares), tag),
              flush=True)
        if any(m > 1 or s > 1e-3 for m, s in shares):
            raise AssertionError('a cut thumbnail differs from the CPU\'s: '
                                 '%r' % shares)
        if card and (parts['e']['region_over'] != inside
                     or parts['e']['solid_fold'] != THUMBS - inside
                     or parts['e']['region_over_sep'] != 0):
            raise AssertionError('the cut\'s thumbnails launched %r, not %d '
                                 'region_over and %d solid_fold'
                                 % (parts['e'], inside, THUMBS - inside))
    finally:
        if engine is not None:
            engine.stop()
        app.close()
    if not card:
        return None
    launches = {k: sum(p[k] for p in parts.values()) for k in parts['a']}
    print('phase 14 editor session: %.1f s; launches %s (%s) %s'
          % (time.perf_counter() - started, json.dumps(launches), ', '.join(
              '%s %s' % (k, json.dumps(v)) for k, v in parts.items()), tag),
          flush=True)
    torch.cuda.empty_cache()
    return launches


#: Phase 15's small pull: 14,400 pixels, under the eager pull's
#: 16,384-pixel threshold.
SMALL_PULL = (160, 90)


class _EagerOnly:
    """A source without ``plan_cuts``: a pull queue pulls it eagerly,
    through this delegate's ``get_frame_f16``."""

    def __init__(self, source):
        self.source = source

    def get_frame_f16(self, frame_index, window):
        return self.source.get_frame_f16(frame_index, window)


def _median_ms(fn, reps=5):
    """Median host-clock ms of *fn* over *reps* runs after one warm run."""
    import numpy as np
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _gate(what, got, want, atol, min_share):
    """(max diff, share bit-equal) of two f16 frames; raises beyond
    *atol* or under *min_share* bit-equal."""
    import numpy as np
    err = float(np.abs(got.astype(np.float32)
                       - want.astype(np.float32)).max())
    share = _bit_share(got, want)
    if not np.isfinite(got).all() or err > atol or share < min_share:
        raise AssertionError('%s: max diff %r, %.5f bit-equal (atol %r, '
                             '>= %r)' % (what, err, share, atol, min_share))
    return err, share


def _queue_pull(queue, source, frame_index, window, mode):
    """The frame a pull queue delivers for a pull enqueued from a new
    thread, under backend mode *mode* (None: that thread's default)."""
    import threading

    from canvas_tpu_torch import backend
    done = threading.Event()
    got = {}

    def deliver(_i, frame, _data):
        got['frame'] = frame
        done.set()

    def enqueue():
        if mode is None:
            queue.enqueue(source, frame_index, window, deliver)
        else:
            with backend.force_backend(mode):
                queue.enqueue(source, frame_index, window, deliver)

    t = threading.Thread(target=enqueue)
    t.start()
    t.join()
    if not done.wait(120) or got['frame'] is None:
        raise AssertionError('the pull queue delivered %r' % (got,))
    return got['frame']


def _eager_pull(tag, window, device=None):
    """Phase 15: the eager pull on the card. (a) the dispatch's branches;
    (b) default-mode pulls of the headline and config7 at full size
    against the NumPy arm and a planner frame; (c) ms per pull at full
    size and at 160x90, three ways; (d) ``process.time_get_frame``'s
    planner branch (its kernels must launch) and eager branch (none may);
    (e) a ``process.VideoPullQueue`` delivering eager pulls captured in
    the default mode and under 'numpy'. Returns (d)'s planner-branch
    launches. ``device='cpu'`` rehearses it on the host (launches not
    checked, None returned)."""
    import numpy as np
    import torch

    from canvas_tpu_torch import backend, process, timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i

    card = device is None
    started = time.perf_counter()
    H, W = window.height, window.width
    head = timelines.build_timeline(1024)
    mixed = timelines.mixed_timeline(256)
    with backend.force_backend('auto', device):
        # (a) dispatch, each branch asserted
        dev = backend.eager_device()
        assert backend.get_backend() == 'auto'
        assert backend.use_torch_for((4, H, W)) is True
        assert dev.type == ('cuda' if card else 'cpu')
        with backend.force_backend('numpy'):
            assert backend.use_torch_for((4, H, W)) is False
        assert backend.use_torch_for((4, SMALL_PULL[1], SMALL_PULL[0])) \
            is False
        print('phase 15a dispatch: default mode %r, use_torch_for((4, %d, '
              '%d)) True on %s, False under force_backend(\'numpy\'), False '
              'at %dx%d (%d pixels, threshold %d) %s'
              % (backend.get_backend(), H, W, dev, SMALL_PULL[0],
                 SMALL_PULL[1], SMALL_PULL[0] * SMALL_PULL[1],
                 backend.device_pixel_threshold, tag), flush=True)

        # (b) default-mode pulls on the card against the NumPy arm and
        # the planner
        cases = ([('headline', head, f, 2e-3, 0.0) for f in (128, 300, 511)]
                 + [('config7', mixed, f, 1e-2, 0.99) for f in (0, 70)])
        rows = []
        for name, src, f, atol, min_share in cases:
            frame = src.get_frame_f16(f, window)
            if (not isinstance(frame.data, torch.Tensor)
                    or frame.data.device.type != dev.type
                    or frame.data.dtype != torch.float16):
                raise AssertionError('%s frame %d pulled as %r'
                                     % (name, f, type(frame.data)))
            got = backend.to_host(frame.data).numpy()
            planner = RenderPlanner(src, window, device=dev)
            planned = planner.render(f, f + 1)[0]
            planner.close()
            rows.append((name, f)
                        + _gate('%s %d vs the NumPy arm' % (name, f), got,
                                _numpy_pull(src, f, window), atol, min_share)
                        + _gate('%s %d vs the planner' % (name, f), got,
                                planned, atol, min_share))
        print('phase 15b eager pulls at %dx%d in the default mode (data on '
              '%s): %s; [max diff, share bit-equal] vs the NumPy arm, then '
              'vs a B=1 planner frame (headline atol 2e-3; config7 atol '
              '1e-2, >= 0.99 bit-equal) %s'
              % (W, H, dev, '; '.join(
                  '%s %d [%.3g, %.5f] [%.3g, %.5f]' % r for r in rows), tag),
              flush=True)

        # (c) ms per pull, host clock until the host copy
        small = box2i(0, 0, SMALL_PULL[0] - 1, SMALL_PULL[1] - 1)
        timing = {}
        for name, src, f in (('headline', head, 300), ('config7', mixed, 70)):
            for size, win in (('%dx%d' % (W, H), window),
                              ('%dx%d' % SMALL_PULL, small)):
                def torch_pull():
                    with backend.force_backend('torch', device):
                        backend.to_host(src.get_frame_f16(f, win).data)

                def numpy_pull():
                    with backend.force_backend('numpy'):
                        src.get_frame_f16(f, win)

                planner = RenderPlanner(src, win, device=dev)
                timing[name, size] = (
                    _median_ms(torch_pull), _median_ms(numpy_pull),
                    _median_ms(lambda: planner.render(f, f + 1)))
                planner.close()
        print('phase 15c ms per pull (host clock until the host copy, median '
              'of 5 after one warm pull), [torch arm, NumPy arm, B=1 '
              'RenderPlanner.render]: %s %s'
              % ('; '.join('%s frame %s %s [%.3f, %.3f, %.3f]'
                           % ((k[0], dict(headline=300, config7=70)[k[0]],
                               k[1]) + v) for k, v in timing.items()), tag),
              flush=True)
        if card:
            # one full-size torch-arm pull taken apart: the device's
            # share of the pull's median wall time
            parts = []
            for name, src, f in (('headline', head, 300),
                                 ('config7', mixed, 70)):
                rows, dev_ms = _profile_kernels(
                    lambda: backend.to_host(
                        src.get_frame_f16(f, window).data))
                wall = timing[name, '%dx%d' % (W, H)][0]
                parts.append('%s %.3f ms in %d kernels, idle share %.3f '
                             'of %.3f ms (top: %s)' % (
                                 name, dev_ms, sum(r[2] for r in rows),
                                 1.0 - dev_ms / wall, wall, '; '.join(
                                     '%s %.3f ms x%d' % (k[:60], ms, n)
                                     for k, ms, n in rows[:3])))
            print('phase 15c a torch-arm pull at %dx%d taken apart '
                  '(torch.profiler, device time): %s %s'
                  % (W, H, ' | '.join(parts), tag), flush=True)

        # (d) time_get_frame: the planner branch through the kernels, the
        # eager branch through the torch arms alone
        ns = {}
        launches = {}
        for name, src, lo, hi in (('headline', head, 128, 255),
                                  ('config7', mixed, 0, 15)):
            _zero_launch_counts()
            ns[name] = process.time_get_frame(src, lo, hi, window)
            launches[name] = _launch_counts()
        _zero_launch_counts()
        for name, src, lo in (('headline', head, 128), ('config7', mixed, 0)):
            ns[name + ' eager'] = process.time_get_frame(
                src, lo, lo + 3, window, force_eager=True)
        eager_launches = _launch_counts()
        print('phase 15d time_get_frame at %dx%d: headline 128..255 planner '
              'branch %d ns, launches %s; config7 0..15 planner branch %d ns, '
              'launches %s; force_eager over 4 frames: headline %d ns, '
              'config7 %d ns, launches %s %s'
              % (W, H, ns['headline'], json.dumps(launches['headline']),
                 ns['config7'], json.dumps(launches['config7']),
                 ns['headline eager'], ns['config7 eager'],
                 json.dumps(eager_launches), tag), flush=True)
        if card and (launches['headline']['solid_fold'] <= 0
                     or launches['headline']['region_over_sep'] <= 0
                     or launches['config7']['region_over'] <= 0
                     or any(eager_launches.values())):
            raise AssertionError('time_get_frame launched %r (eager %r)'
                                 % (launches, eager_launches))

    # (e) the pull queue: eager pulls under the captured mode
    queue = process.VideoPullQueue(device=device)
    try:
        src = _EagerOnly(head)
        on_card = _queue_pull(queue, src, 300, window, None)
        on_host = _queue_pull(queue, src, 300, window, 'numpy')
    finally:
        queue.close()
    if (not isinstance(on_card.data, torch.Tensor)
            or on_card.data.device.type != dev.type):
        raise AssertionError('the queue\'s default-mode pull arrived as %r'
                             % type(on_card.data))
    if not isinstance(on_host.data, np.ndarray):
        raise AssertionError('the queue\'s numpy-mode pull arrived as %r'
                             % type(on_host.data))
    qerr = _gate('queue pull', backend.to_host(on_card.data).numpy(),
                 on_host.data, 2e-3, 0.0)
    print('phase 15e VideoPullQueue on %s, a source without plan_cuts, '
          'headline frame 300: enqueued in the default mode -> %s data on '
          '%s, under force_backend(\'numpy\') -> %s; max diff %.3g (%.5f '
          'bit-equal, atol 2e-3) %s'
          % (queue.device, type(on_card.data).__name__, on_card.data.device,
             type(on_host.data).__name__, qerr[0], qerr[1], tag), flush=True)
    total = {k: launches['headline'][k] + launches['config7'][k]
             for k in launches['headline']}
    print('phase 15 eager pull: %.1f s; launches %s %s'
          % (time.perf_counter() - started, json.dumps(total), tag),
          flush=True)
    return total if card else None


def _sharded_equal(what, got, want):
    """Raise unless every shard of *got* (a ``ShardedFrames``) equals its
    frames of the unsharded tensor *want*, bit for bit, on the card."""
    import torch
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError('%s: sharded %r against unsharded %r'
                             % (what, got.shape, tuple(want.shape)))
    for t, b in got.shards:
        ref = want[tuple(slice(lo, hi) for lo, hi in b)]
        if not torch.equal(t, ref):
            raise AssertionError('%s: the shard of block %r differs from '
                                 'the unsharded frames' % (what, b))


def _device_gate(what, got, want, atol, min_share):
    """(max diff, share bit-equal) of two f16 tensors on the card; raises
    beyond *atol* or under *min_share* bit-equal (phase 6's gate)."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    share = float((got.view(torch.int16) == want.view(torch.int16))
                  .float().mean())
    if not bool(torch.isfinite(got).all()) or err > atol \
            or share < min_share:
        raise AssertionError('%s: max diff %r, %.6f bit-equal (atol %r, '
                             '>= %r)' % (what, err, share, atol, min_share))
    return err, share


def _unsharded(ws, window, start, stop, batch, post=None, device=None):
    """The unsharded frames [start, stop) of *ws* as one tensor on the
    card (a fresh planner, plan cache off)."""
    import torch

    from canvas_tpu_torch.render import RenderPlanner
    planner = RenderPlanner(ws, window, device=device)
    planner.plan_cache_segments = 0
    outs = [out.clone() for _s, _n, out in planner.iter_batches(
        start, stop, batch=batch, post=post)]
    planner.close()
    return torch.cat(outs, dim=0)


def _shard_work(ws, window, start, stop, batch, mesh):
    """The batches of [start, stop) prepared twice, unsharded
    ([(sig, params on the card)]) and over *mesh*'s frames axis
    ([(shard sig, params of each shard)]), for replays with the
    planning and copies done beforehand."""
    from canvas_tpu_torch.render import RenderPlanner, params_to_torch
    devices = mesh.axis_devices('frames')
    planner = RenderPlanner(ws, window, device=devices[0])
    plain, sharded = [], []
    for seg in planner.segments(start, stop, min_span=batch):
        _s0, sig, batches = planner._prepare(seg, batch)
        for (_pos, _take, plist) in batches:
            plain.append((sig, params_to_torch(plist, devices[0])))
        prep = planner._prepared(seg, batch, None, False, mesh, 'frames')
        for k in range(len(prep.spans)):
            sharded.append((prep.sig, prep.shard_params(k, devices)))
    _sync(devices[0])
    planner.close()
    return plain, sharded


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _empty_cache():
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _multi_device(tag, window, config7, device=None):
    """Phase 16: multi-device rendering on logical shards of the one card.
    (a) render_sharded over the default mesh; (b) the headline, config7
    and the frames x space reshard over logical meshes, with the
    sharded yuv420 post; (c) config5's protocol on the 2-shard mesh,
    enqueue and device time beside the unsharded path's, the memory
    guard's per-device estimate beside the peak. Returns the sharded
    path's launches.

    ``device='cpu'`` rehearses the phase on the CPU (a mesh of ``cpu``
    entries, the kernels' plain versions; no device time, memory or
    launches): ``_multi_device(tag, box2i(0, 0, 319, 179),
    {'enqueue_ms': 0.0, 'batches': 1}, device='cpu')``."""
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.mesh import (Mesh, Replicated, ShardedFrames,
                                       local_mesh)
    from canvas_tpu_torch.render import (RenderPlanner, _get_program,
                                         _hbm_estimate_bytes, render_sharded)

    t_phase = time.perf_counter()
    card = (torch.device(device) if device is not None
            else torch.device('cuda', torch.cuda.current_device()))
    on_card = card.type == 'cuda'
    ws = timelines.build_timeline(1024)
    launches = {k: 0 for k in _launch_counts()}

    def planner_of(src):
        return RenderPlanner(src, window, device=card)

    def counted(fn):
        _zero_launch_counts()
        out = fn()
        _sync(card)
        for k, v in _launch_counts().items():
            launches[k] += v
        return out

    # (a) the default mesh: every visible card; with one it streams
    # unsharded, as the JAX package's does
    default = local_mesh() if on_card else Mesh([card], ('frames',))
    got = counted(lambda: render_sharded(
        ws, window, 0, 256, mesh=None if on_card else default,
        device_out=True, batch=128))
    want = _unsharded(ws, window, 0, 256, 128, device=card)
    if isinstance(got, ShardedFrames):
        _sharded_equal('render_sharded default mesh', got, want)
    elif default.size != 1 or not torch.equal(got, want):
        raise AssertionError('render_sharded over the default mesh of %d '
                             'device(s) gave %r, not the unsharded stream'
                             % (default.size, type(got)))
    print('phase 16a default mesh: local_mesh() holds %d device(s) %s; '
          'render_sharded(build_timeline(1024), 1080p, 0, 256, device_out='
          'True, batch=128) -> %s %s, bit-equal to the unsharded stream %s'
          % (default.size, [str(d) for d in default.devices.flat],
             type(got).__name__, tuple(got.shape), tag), flush=True)
    del got, want
    _empty_cache()

    # (b) logical shards: two entries of the one card
    mesh = Mesh([card, card], ('frames',))
    shards = []

    def headline_sharded():
        planner = planner_of(ws)
        planner.plan_cache_segments = 0
        for s, n, out in planner.iter_batches(128, 512, batch=128,
                                              mesh=mesh):
            if not isinstance(out, ShardedFrames) or len(out.shards) != 2:
                raise AssertionError('batch at %d: %r' % (s, out))
            shards.append((s, n, out))
        planner.close()

    before = dict(launches)
    counted(headline_sharded)
    head_launches = {k: launches[k] - before[k] for k in launches}
    want = _unsharded(ws, window, 128, 512, 128, device=card)
    for s, n, out in shards:
        _sharded_equal('headline sharded batch at %d' % s, out,
                       want[s - 128:s - 128 + n])
    print('phase 16b headline sharded: frames 128..511 via iter_batches('
          'batch=128, mesh=Mesh([%s, %s], (\'frames\',))), %d batches of 2 '
          'shards of 64 frames, each shard bit-equal to the unsharded '
          'stream; launches %s %s'
          % (card, card, len(shards), json.dumps(head_launches), tag),
          flush=True)
    del shards[:], want
    _empty_cache()

    mixed = timelines.mixed_timeline(256)
    mixed_out = []
    staged = []

    def mixed_sharded():
        planner = planner_of(mixed)
        planner.plan_cache_segments = 0
        for s, n, out in planner.iter_batches(0, 128, batch=16, mesh=mesh):
            mixed_out.append(out)
        staged.extend(e['value'] for k, e in
                      planner.persistent_cache._entries.items()
                      if k[0] == 'dvplanes')
        planner.close()

    before = dict(launches)
    counted(mixed_sharded)
    mix_launches = {k: launches[k] - before[k] for k in launches}
    if not staged or not all(isinstance(s, Replicated) and
                             list(s.copies) == [card]
                             for e in staged for s in e['stacks']):
        raise AssertionError('config7 DV planes were not staged onto the '
                             'mesh: %r' % (staged[:1],))
    if on_card and min(mix_launches[k] for k in _RENDER_KERNELS) <= 0:
        raise AssertionError('sharded config7 launches %r' % mix_launches)
    want = _unsharded(mixed, window, 0, 128, 16, device=card)
    got = torch.cat([t for out in mixed_out for t, _b in out.shards])
    err, share = _device_gate('config7 sharded', got, want, 1e-2, 0.99)
    print('phase 16b config7 sharded: frames 0..127 of mixed_timeline(256) '
          'via iter_batches(batch=16, mesh) (2 shards of 8), DV planes '
          'staged onto the mesh (%d replicated stacks on %s); against the '
          'unsharded render max diff %.4g, %.6f bit-equal (phase 6 gate: '
          'atol 1e-2, >= 0.99); launches %s %s'
          % (sum(len(e['stacks']) for e in staged), card, err, share,
             json.dumps(mix_launches), tag), flush=True)
    del mixed_out[:], staged[:], got, want
    _empty_cache()

    grid = Mesh([[card, card], [card, card]], ('frames', 'space'))
    got = counted(lambda: render_sharded(ws, window, 0, 5, mesh=grid,
                                         spatial_axis='space',
                                         device_out=True))
    want = _unsharded(ws, window, 0, 5, 8, device=card)
    _sharded_equal('frames x space reshard', got, want)
    blocks = [b[0] + b[2] for _t, b in got.shards]

    posted = []

    def sharded_post():
        planner = planner_of(ws)
        parts = []
        for s, _n, out in planner.iter_batches(0, 5, batch=8, mesh=mesh,
                                               post='yuv420'):
            posted.append(s)
            parts += [t for t, _b in out.shards]
        planner.close()
        return torch.cat(parts)

    before = launches[_POST_KERNEL]
    post = counted(sharded_post)
    # every shard of a batch posts on its own card, one launch each, also
    # a shard that the batch's cut to its valid frames leaves out
    if launches[_POST_KERNEL] - before != (len(posted) * mesh.size
                                           if on_card else 0):
        raise AssertionError('the sharded yuv420 post: %d yuv420_post '
                             'launches for %d batches over %d shards' % (
                                 launches[_POST_KERNEL] - before,
                                 len(posted), mesh.size))
    want_u8 = _unsharded(ws, window, 0, 5, 8, post='yuv420', device=card)
    if not torch.equal(post, want_u8):
        raise AssertionError('the sharded yuv420 post differs from the '
                             'unsharded post')
    print('phase 16b frames x space: render_sharded(0, 5, mesh=2x2 of %s, '
          'spatial_axis=\'space\') blocks [f0, f1, r0, r1] %s bit-equal to '
          'the unsharded frames; iter_batches(0, 5, batch=8, mesh, '
          'post=\'yuv420\') %s u8 equal to the unsharded post %s'
          % (card, blocks, tuple(post.shape), tag), flush=True)
    del got, want, post, want_u8
    _empty_cache()

    # (c) times: config5's protocol on the logical 2-shard mesh
    plain_planner = planner_of(timelines.build_timeline(1024))
    plain_planner.plan_cache_segments = 0
    plain_planner.pipeline_chunk = max(plain_planner.pipeline_chunk, 128)

    def run_sharded():
        _sync(card)
        t0 = time.perf_counter()
        out = render_sharded(ws, window, 0, 256, mesh=mesh,
                             device_out=True, batch=128)
        _sync(card)
        del out
        return 256 / (time.perf_counter() - t0)

    def run_plain():
        _sync(card)
        t0 = time.perf_counter()
        for _out in plain_planner.iter_batches(0, 256, batch=128):
            pass
        _sync(card)
        return 256 / (time.perf_counter() - t0)

    counted(run_sharded)
    run_plain()
    pairs = []
    for _rep in range(3):
        pairs.append((counted(run_sharded), run_plain()))
    ratios = sorted(s / p for s, p in pairs)
    sharded_fps = sorted(s for s, _p in pairs)[1]
    plain_fps = sorted(p for _s, p in pairs)[1]
    print('phase 16c config5 on logical shards: config5_sharded_fps %.1f, '
          'plain %.1f, sharded/plain %.3f (median of 3 interleaved cold '
          'pairs over frames 0..255, batch 128, mesh of 2 entries of %s; '
          'pairs %s) %s'
          % (sharded_fps, plain_fps, ratios[1], card,
             ', '.join('(%.1f, %.1f)' % sp for sp in pairs), tag), flush=True)

    def mixed_pass(planner, m):
        _sync(card)
        t0 = time.perf_counter()
        for _out in planner.iter_batches(0, 128, batch=16, mesh=m):
            pass
        _sync(card)
        return 128 / (time.perf_counter() - t0)

    cold = [planner_of(mixed), planner_of(mixed)]
    for planner in cold:
        planner.stage_cache_mb = 0      # cold: no stage cache, no plans
    counted(lambda: mixed_pass(cold[0], mesh))
    mixed_pass(cold[1], None)
    mpairs = []
    for _rep in range(3):
        mpairs.append((counted(lambda: mixed_pass(cold[0], mesh)),
                       mixed_pass(cold[1], None)))
    mratios = sorted(a / b for a, b in mpairs)
    print('phase 16c config7 on logical shards: sharded %.1f fps, plain '
          '%.1f, sharded/plain %.3f (median of 3 interleaved cold pairs '
          'over frames 0..127, batch 16; pairs %s; phase 7: %.1f) %s'
          % (sorted(a for a, _b in mpairs)[1], sorted(b for _a, b in
                                                     mpairs)[1],
             mratios[1], ', '.join('(%.1f, %.1f)' % ab for ab in mpairs),
             config7.get('fps', 0.0), tag), flush=True)
    for planner in cold:
        planner.close()

    plain, sharded = _shard_work(ws, window, 0, 512, 128, mesh)
    devices = mesh.axis_devices('frames')

    def replay_plain():
        for sig, params in plain:
            _get_program(sig, card)(params)

    def replay_sharded():
        for sig, params in sharded:
            RenderPlanner._run_shards(sig, params, devices, mesh, 'frames',
                                      None)

    enq = {'plain': [], 'sharded': []}
    for name, fn in (('plain', replay_plain),
                     ('sharded', replay_sharded)) * 2:
        _sync(card)
        t0 = time.perf_counter()
        fn()
        enq[name].append((time.perf_counter() - t0) * 1e3 / len(plain))
        _sync(card)
    if on_card:
        busy_plain = cuda_ms(replay_plain, 3) / len(plain)
        busy_sharded = cuda_ms(replay_sharded, 3) / len(sharded)
        idle = 1.0 - busy_sharded * 2 / (256 / sharded_fps * 1e3)
        device_times = ('device busy per batch unsharded %.3f ms, sharded '
                        '%.3f ms; the sharded config5 pass\'s device idle '
                        'share %.3f' % (busy_plain, busy_sharded, idle))
    else:
        device_times = 'device time not measured (CPU rehearsal)'
    print('phase 16c enqueue per 128-frame batch (host clock, no sync, '
          'frames 0..511, two turns each): unsharded %s ms, sharded %s ms '
          '(%s ms a shard); %s; phase 7\'s config7 enqueue %.3f ms a '
          '16-frame batch unsharded %s'
          % (', '.join('%.3f' % v for v in enq['plain']),
             ', '.join('%.3f' % v for v in enq['sharded']),
             ', '.join('%.3f' % (v / 2) for v in enq['sharded']),
             device_times, config7['enqueue_ms'] / config7['batches'], tag),
          flush=True)
    del plain, sharded
    print('phase 16 launches on the sharded path (16a-16c): %s %s'
          % (json.dumps(launches), tag), flush=True)
    if not on_card:
        print('phase 16c guard: not measured (CPU rehearsal); phase 16 '
              '%.1f s %s' % (time.perf_counter() - t_phase, tag), flush=True)
        return launches

    # the memory guard's per-device estimate beside the measured peak
    planner = planner_of(ws)
    planner.plan_cache_segments = 0
    est = _hbm_estimate_bytes(128, window, None, None)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _out in planner.iter_batches(128, 512, batch=128, mesh=mesh):
        pass
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    planner.close()
    cum_est = _hbm_estimate_bytes(256, window, None, 2, working_bpp=0)[0]
    torch.cuda.empty_cache()
    base2 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = render_sharded(ws, window, 0, 256, mesh=mesh, device_out=True,
                         batch=128)
    torch.cuda.synchronize()
    cum_peak = torch.cuda.max_memory_allocated() - base2
    del out
    torch.cuda.empty_cache()
    print('phase 16c guard: iter_batches(batch=128, mesh of 2 entries of '
          '%s): the per-device estimate %.3f GB (both shards on the one '
          'card) beside a measured peak of %.3f GB: estimate / peak %.3f; '
          'render_sharded(0, 256)\'s cumulative estimate %.3f GB beside its '
          'peak %.3f GB (%.3f); phase 16 %.1f s %s'
          % (card, est / 1e9, peak / 1e9, est / peak, cum_est / 1e9,
             cum_peak / 1e9, cum_est / cum_peak,
             time.perf_counter() - t_phase, tag), flush=True)
    if est < peak:
        raise AssertionError('the memory guard estimates %d bytes below the '
                             'sharded stream\'s measured peak of %d'
                             % (est, peak))
    return launches


def _device_offsets(device, dy0, dx0):
    """A region kernel's offsets: int32 values in *device* memory."""
    import torch
    return [torch.tensor([v], dtype=torch.int32, device=device)
            for v in (dy0, dx0)]


def _captures():
    """Render programs captured so far (``render.program_stats``)."""
    from canvas_tpu_torch.render import program_stats
    return program_stats()['captures']


def _drop_programs():
    """Evict every render program (a cold program cache)."""
    from canvas_tpu_torch import render
    with render._program_lock:
        progs = list(render._program_cache.values())
        render._program_cache.clear()
    render._evict(progs)


class _Eager:
    """The eager arm of phase 17's comparison, in a render program's
    place: ``run`` (``display_run`` for a display pull, its u8 bytes
    fetched) over the batch's params, a host list uploaded in one packed
    copy as before the programs."""

    def __init__(self, sig, device, post=None, display=None):
        self.sig, self.device, self.post = sig, device, post
        self.display = display

    def __call__(self, plist):
        import torch

        from canvas_tpu_torch import backend, render
        params = (plist if isinstance(plist, render._DeviceParams)
                  else render.params_to_torch(plist, self.device))
        if self.display is None:
            return render.run(self.sig, params, self.device, self.post)
        order, intent, size, transport = self.display
        # a frame's params are views into its segment's: contiguous, as
        # the eager display pull cut them (render._frame_slice)
        params = [{k: (v.contiguous() if isinstance(v, torch.Tensor)
                       else v) for k, v in p.items()} for p in params]
        mats = None
        if size is not None:
            mats = (params[-1]['dy'], params[-1]['dx'])
            params = params[:-1]
        return backend.to_host(render.display_run(
            self.sig, params, self.device, mats, order, intent, transport))


class _EagerPrograms:
    """Inside the block every render program is an ``_Eager`` stand-in:
    the path runs as it did before the programs (one packed upload a
    batch, every op enqueued from Python)."""

    def __enter__(self):
        from canvas_tpu_torch import render
        self.saved = (render._get_program, render._get_sharded_program,
                      render._get_display_program)
        render._get_program = (
            lambda sig, device, post=None, reserve=0, family=None:
            _Eager(sig, device, post))
        render._get_sharded_program = (
            lambda sig, devices, post=None, reserve=0, family=None:
            [_Eager(sig, d, post) for d in devices])
        render._get_display_program = (
            lambda sig1, device, order, intent, size, transport, reserve=0,
            family=None: _Eager(sig1, device,
                                display=(order, intent, size, transport)))
        return self

    def __exit__(self, *exc):
        from canvas_tpu_torch import render
        (render._get_program, render._get_sharded_program,
         render._get_display_program) = self.saved
        return False


def _median(values):
    import numpy as np
    return float(np.median(values))


def _programs(tag, window, device=None):
    """Phase 17: the render programs, one CUDA graph per signature.
    (a) every path through programs against the eager run on the same
    params, max diff 0: the headline's frames 128..515 at batch 128 (the
    tail segment [512, 516) its own signature), config7's frames 0..127
    at batch 16, the rgba_u8 and yuv420 posts, render_display rgb24 at
    full size and 960x540, config5 over a mesh naming the card twice;
    (b) with no program left, three cold passes of the headline capture
    once per signature (at a program's second call, after its eager
    run) and replay every later batch; (c) eager against program
    side by side, the median of five interleaved passes: host enqueue and
    device busy ms a batch, idle share and fps for the cold headline, cold
    config7, the config7b replay and config5 on logical shards, the warm
    render_display p50/p95, each program's capture ms and pool bytes, and
    the peak memory of a cold headline pass (its capture included)
    beside the memory guard's estimate; (d) both region kernels with
    their offsets in device memory against their plain versions, f32 and
    bf16, at the main path's shapes and over an edge, beside their byte
    floors. Returns the launches of (a) and (b).

    ``device='cpu'`` rehearses (a) and (b) on the CPU (the kernels' plain
    versions; no graphs, times, memory or kernels):
    ``_programs(tag, box2i(0, 0, 319, 179), device='cpu')``."""
    import numpy as np
    import torch

    from canvas_tpu_torch import backend, timelines
    from canvas_tpu_torch.backend import cuda_ms, paired_ms
    from canvas_tpu_torch.mesh import Mesh
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.ops import cuda_ops
    from canvas_tpu_torch.render import (RenderPlanner, _get_program,
                                         _hbm_estimate_bytes, _frame_slice,
                                         _param_sharding, display_run,
                                         params_to_torch, program_stats,
                                         render_sharded, run)

    t_phase = time.perf_counter()
    card = (torch.device(device) if device is not None
            else torch.device('cuda', torch.cuda.current_device()))
    on_card = card.type == 'cuda'
    ws = timelines.build_timeline(1024)
    mixed = timelines.mixed_timeline(256)
    launches = dict.fromkeys(_launch_counts(), 0)
    H, W = window.height, window.width
    # the phase starts from no program: the earlier phases' pools go
    _drop_programs()
    _empty_cache()

    def counted(fn):
        _zero_launch_counts()
        out = fn()
        _sync(card)
        for k, v in _launch_counts().items():
            launches[k] += v
        return out

    def diff(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float('inf')
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    # (a) every path through its programs against the eager run: two
    # passes from no program (each program's first call runs eagerly, its
    # second captures), then the compared pass, every call of it a replay
    def vs_eager(what, src, start, stop, batch, post=None, mesh=None,
                 cold=None):
        _drop_programs()

        def one_pass():
            planner = RenderPlanner(src, window, device=card)
            planner.plan_cache_segments = 0
            if cold == 'stage':
                planner.stage_cache_mb = 0
            got = counted(lambda: [(s, n, out) for s, n, out in
                                   planner.iter_batches(start, stop,
                                                        batch=batch,
                                                        post=post,
                                                        mesh=mesh)])
            return planner, got

        for _warm in range(2):
            planner, _got = one_pass()
            planner.close()
            del _got
        before = program_stats()
        posted = launches[_POST_KERNEL]
        planner, got = one_pass()
        posted = launches[_POST_KERNEL] - posted
        after = program_stats()
        calls = after['calls'] - before['calls']
        replays = after['replays'] - before['replays']
        # one yuv420_post launch a program call that posts yuv420 on a card
        if posted != (calls if post == 'yuv420' and on_card else 0):
            raise AssertionError('%s: %d yuv420_post launches over %d '
                                 'program calls' % (what, posted, calls))
        worst, i, sigs = 0.0, 0, set()
        devices = mesh.axis_devices('frames') if mesh is not None else None
        for seg in planner.segments(start, stop, min_span=batch):
            prep = planner._prepared(seg, batch, post, False, mesh, 'frames')
            sigs.add(prep.sig)
            for k, (pos, take) in enumerate(prep.spans):
                s, n, out = got[i]
                i += 1
                if (s, n) != (prep.seg_start + pos, take):
                    raise AssertionError('%s: batch %r against %r' % (
                        what, (s, n), (prep.seg_start + pos, take)))
                if mesh is None:
                    want = run(prep.sig, prep.device_params(k, card), card,
                               post)[:take]
                    worst = max(worst, diff(out, want))
                    continue
                # a tail batch cut to its valid frames keeps each shard's
                # leading ones
                for (t, _b), d, p in zip(out.shards, devices,
                                         prep.shard_params(k, devices)):
                    want = run(prep.sig, p, d, post)
                    worst = max(worst, diff(t, want[:t.shape[0]]))
        planner.close()
        if worst != 0.0 or i != len(got):
            raise AssertionError('%s: programs against the eager run: max '
                                 'diff %r over %d of %d batches'
                                 % (what, worst, i, len(got)))
        if not replays or replays != calls:
            raise AssertionError('%s: the compared pass made %d program '
                                 'calls, %d of them replays (all must be)'
                                 % (what, calls, replays))
        return dict(batches=len(got), calls=calls, replays=replays,
                    signatures=len(sigs))

    checked = {
        'headline 128..515 batch 128': vs_eager('headline', ws, 128, 516,
                                                128),
        'config7 0..127 batch 16': vs_eager('config7', mixed, 0, 128, 16,
                                            cold='stage'),
        'post rgba_u8 128..383': vs_eager('rgba_u8', ws, 128, 384, 128,
                                          post='rgba_u8'),
        'post yuv420 128..383': vs_eager('yuv420', ws, 128, 384, 128,
                                         post='yuv420'),
        'config5 Mesh([card] * 2) 0..255 batch 128': vs_eager(
            'config5', ws, 0, 256, 128, mesh=Mesh([card, card],
                                                  ('frames',))),
    }
    # render_display: four frames of one segment a size and start, so
    # that its display program runs eagerly, captures and replays; each
    # pull against the eager display run of the same frame
    _drop_programs()
    planner = RenderPlanner(ws, window, device=card)
    worst = 0.0
    for size in (None, VIEWPORT):
        for start in (4, 130, 1000):
            replays = program_stats()['replays']
            for i in range(start, start + 4):
                got = planner.render_display(i, transport='rgb24',
                                             display_size=size)
                seg = planner._display_seg
                pos = i - seg['lo']
                params = [{k: (v if _param_sharding(op, k) is None
                               else _frame_slice(v, _param_sharding(op, k),
                                                 pos))
                           for k, v in p.items()}
                          for p, op in zip(seg['params'], seg['ops'])]
                mats = planner._display_matrices(size)
                flat = backend.to_host(display_run(
                    seg['sig1'], params, card, mats, (2, 1, 0, 3), None,
                    'rgb24'))
                want = torch.from_numpy(color_ops.rgb24_unpack(
                    flat[0], (2, 1, 0, 3)))
                worst = max(worst, diff(torch.from_numpy(got), want))
            replays = program_stats()['replays'] - replays
            if replays < 2:
                raise AssertionError('render_display %s frames %d..%d: %d '
                                     'replays (want at least 2)'
                                     % (size, start, start + 3, replays))
            checked['render_display rgb24 %s frames %d..%d' % (
                'full' if size is None else '%dx%d' % size, start,
                start + 3)] = dict(pulls=4, replays=replays)
    planner.close()
    if worst != 0.0:
        raise AssertionError('render_display through its program differs '
                             'from the eager display run by %r' % worst)
    print('phase 17a programs against the eager run on the same params, max '
          'diff 0 on every path, every compared call a replay: %s %s'
          % ('; '.join('%s %s' % (k, json.dumps(v))
                       for k, v in checked.items()), tag), flush=True)

    # (b) a cold program cache: one capture per signature over three cold
    # passes, every batch a replay
    _drop_programs()
    planner = RenderPlanner(ws, window, device=card)
    planner.plan_cache_segments = 0
    sigs = {planner._prepared(seg, 128, None, False).sig
            for seg in planner.segments(128, 512, min_span=128)}
    before = program_stats()
    n_batches = counted(lambda: sum(
        1 for _rep in range(3)
        for _out in planner.iter_batches(128, 512, batch=128)))
    after = program_stats()
    planner.close()
    captures = after['captures'] - before['captures']
    replays = after['replays'] - before['replays']
    # each program's first two calls run eagerly, the second captures
    if captures != len(sigs) or replays != n_batches - 2 * len(sigs):
        raise AssertionError('three cold passes: %d captures for %d '
                             'signatures, %d replays for %d batches'
                             % (captures, len(sigs), replays, n_batches))
    print('phase 17b capture and replay: three cold passes of the headline '
          '(frames 128..511, batch 128, plan cache off) from no program: %d '
          'captures for %d signatures, %d replays for %d batches (each '
          'program\'s first two calls eager, the second captures); '
          'programs %s %s'
          % (captures, len(sigs), replays, n_batches,
                     json.dumps([{k: p[k] for k in ('key', 'frames',
                                                    'replays', 'capture_ms',
                                                    'pool_bytes')}
                                 for p in after['programs']]), tag),
          flush=True)
    if not on_card:
        print('phase 17c, 17d: not measured (CPU rehearsal); phase 17 %.1f '
              's %s' % (time.perf_counter() - t_phase, tag), flush=True)
        return launches

    # (c) eager against program, side by side
    def work_of(planner, start, stop, batch):
        work = []
        for seg in planner.segments(start, stop, min_span=batch):
            _s0, sig, batches = planner._prepare(seg, batch)
            work += [(sig, params_to_torch(pl, card)) for _p, _t, pl
                     in batches]
        torch.cuda.synchronize()
        return work

    def enqueue_busy(work, eager):
        """(host ms a batch to enqueue the prepared batches, device busy
        ms a batch)."""
        if eager:
            def go():
                for sig, tp in work:
                    run(sig, tp, card)
        else:
            progs = [_get_program(sig, card) for sig, _tp in work]

            def go():
                for prog, (_sig, tp) in zip(progs, work):
                    prog(tp)
        go()
        go()                    # programs: eager, then eager and captured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        host = (time.perf_counter() - t0) * 1e3 / len(work)
        torch.cuda.synchronize()
        return host, cuda_ms(go, 3) / len(work)

    def wall_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def side_by_side(name, make, frames, pass_fn, work=None):
        """Five interleaved passes of each arm (eager first in even
        turns): the median wall, fps, enqueue and busy ms a batch, idle
        share. *make* makes the arm's state, *pass_fn(state)* one pass."""
        out = {}
        states = {}
        for arm in ('eager', 'program'):
            ctx = _EagerPrograms() if arm == 'eager' else _Null()
            with ctx:
                states[arm] = make()
                # programs: eager, then eager and captured
                for _warm in range(2):
                    pass_fn(states[arm])
        walls = {'eager': [], 'program': []}
        for rep in range(5):
            for arm in (('eager', 'program') if rep % 2 == 0
                        else ('program', 'eager')):
                ctx = _EagerPrograms() if arm == 'eager' else _Null()
                with ctx:
                    walls[arm].append(wall_of(lambda: pass_fn(states[arm])))
        for arm in ('eager', 'program'):
            wall = _median(walls[arm])
            row = dict(fps=frames / wall, wall_ms=wall * 1e3)
            if work is not None:
                host, busy = enqueue_busy(work, arm == 'eager')
                row.update(enqueue_ms=host, busy_ms=busy,
                           idle=1.0 - busy * len(work) / (wall * 1e3))
            out[arm] = row
        print('phase 17c %s, median of 5 interleaved passes: %s %s'
              % (name, '; '.join(
                  '%s %s' % (arm, ', '.join('%s %.4f' % kv
                                            for kv in sorted(row.items())))
                  for arm, row in out.items()), tag), flush=True)
        return out

    def first_pass(name, make, frames, pass_fn):
        """A one-shot pass from no program (its captures included)
        against the eager pass, five interleaved pairs: the median wall
        and fps, the captures the pass made and how many of its calls
        replayed, and the median capture split."""
        walls = {'eager': [], 'program': []}
        made = {'captures': [], 'replays': [], 'calls': []}
        split = {}
        for rep in range(5):
            for arm in (('eager', 'program') if rep % 2 == 0
                        else ('program', 'eager')):
                if arm == 'program':
                    _drop_programs()
                    before = program_stats()
                ctx = _EagerPrograms() if arm == 'eager' else _Null()
                with ctx:
                    state = make()
                    walls[arm].append(wall_of(lambda: pass_fn(state)))
                state.close()
                if arm == 'eager':
                    continue
                after = program_stats()
                for k in made:
                    made[k].append(after[k] - before[k])
                for prog in after['programs']:
                    if ((prog['capture_index'] or 0) > before['captures']
                            and prog['capture_split']):
                        for k, v in prog['capture_split'].items():
                            split.setdefault(k, []).append(v)
        row = {arm: dict(wall_ms=_median(w) * 1e3,
                         fps=frames / _median(w)) for arm, w in walls.items()}
        print('phase 17c %s, one-shot pass from no program, median of 5 '
              'interleaved pairs: %s; program pass: captures %s, calls %s, '
              'replays %s; capture split (median ms) %s %s'
              % (name, '; '.join('%s wall %.4f ms, fps %.4f'
                                 % (arm, r['wall_ms'], r['fps'])
                                 for arm, r in row.items()),
                 made['captures'], made['calls'], made['replays'],
                 json.dumps({k: round(_median(v), 4)
                             for k, v in split.items()}), tag), flush=True)
        return row

    def headline_planner():
        planner = RenderPlanner(ws, window, device=card)
        planner.plan_cache_segments = 0
        return planner

    def headline_pass(planner):
        for _out in planner.iter_batches(128, 512, batch=128):
            pass

    hp = headline_planner()
    head_work = work_of(hp, 128, 512, 128)
    hp.close()
    cells = {}
    cells['headline'] = side_by_side(
        'cold headline (frames 128..511, batch 128)', headline_planner, 384,
        headline_pass, head_work)
    del head_work
    cells['headline first'] = first_pass(
        'headline (frames 128..511, batch 128)', headline_planner, 384,
        headline_pass)

    def mixed_planner(cold=True):
        def make():
            planner = RenderPlanner(mixed, window, device=card)
            if cold:
                planner.stage_cache_mb = 0
            return planner
        return make

    def mixed_pass(planner):
        for _out in planner.iter_batches(0, 128, batch=16):
            pass

    mp = RenderPlanner(mixed, window, device=card)
    mp.stage_cache_mb = 0
    mixed_work = work_of(mp, 0, 128, 16)
    mp.close()
    cells['config7'] = side_by_side(
        'cold config7 (frames 0..127, batch 16)', mixed_planner(True), 128,
        mixed_pass, mixed_work)
    cells['config7 first'] = first_pass(
        'config7 (frames 0..127, batch 16, stage cache off)',
        mixed_planner(True), 128, mixed_pass)
    cells['config7b'] = side_by_side(
        'config7b replay (the same range, caches on)', mixed_planner(False),
        128, mixed_pass, mixed_work)
    del mixed_work
    mesh = Mesh([card, card], ('frames',))

    def config5_pass(_state):
        out = render_sharded(ws, window, 0, 256, mesh=mesh, device_out=True,
                             batch=128)
        del out

    cells['config5'] = side_by_side(
        'config5 on logical shards (render_sharded over Mesh([card] * 2), '
        'frames 0..255, batch 128)', lambda: None, 256, config5_pass)
    plain, sharded = _shard_work(ws, window, 0, 512, 128, mesh)
    devices = mesh.axis_devices('frames')
    for arm in ('eager', 'program'):
        ctx = _EagerPrograms() if arm == 'eager' else _Null()
        with ctx:
            def go():
                for sig, params in sharded:
                    RenderPlanner._run_shards(sig, params, devices, mesh,
                                              'frames', None)
            go()
            go()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            cells['config5'][arm]['enqueue_ms'] = (
                (time.perf_counter() - t0) * 1e3 / len(sharded))
            busy = cuda_ms(go, 3) / len(sharded)
            cells['config5'][arm]['busy_ms'] = busy
            cells['config5'][arm]['idle'] = 1.0 - busy * 2 / cells[
                'config5'][arm]['wall_ms']
    del plain, sharded
    print('phase 17c config5 enqueue and device busy a 128-frame batch of 2 '
          'shards: %s %s' % ('; '.join(
              '%s enqueue %.4f ms, busy %.4f ms, idle %.4f' % (
                  arm, cells['config5'][arm]['enqueue_ms'],
                  cells['config5'][arm]['busy_ms'],
                  cells['config5'][arm]['idle'])
              for arm in ('eager', 'program')), tag), flush=True)

    display = {}
    frames = {}
    for arm in ('eager', 'program'):
        ctx = _EagerPrograms() if arm == 'eager' else _Null()
        with ctx:
            planner = RenderPlanner(ws, window, device=card)
            for size in (None, VIEWPORT):
                kw = dict(transport='rgb24', display_size=size)
                planner.render_display(1, **kw)

                def pull(i):
                    t0 = time.perf_counter()
                    got = planner.render_display(i, **kw)
                    ms = (time.perf_counter() - t0) * 1e3
                    # a digest, not the frame: frames kept alive would
                    # make every later pull fault in fresh host pages
                    frames[(arm, size, i)] = hashlib.blake2b(
                        np.ascontiguousarray(got).data,
                        digest_size=16).digest()
                    return ms

                warm = [pull(i) for i in range(1, 64)]
                display[(arm, size)] = (float(np.percentile(warm, 50)),
                                        float(np.percentile(warm, 95)))
            planner.close()
    # the program arm's frames against the eager arm's
    differ = [(size, i) for size in (None, VIEWPORT) for i in range(1, 64)
              if frames[('program', size, i)] != frames[('eager', size, i)]]
    if differ:
        raise AssertionError('render_display warm: the program arm\'s '
                             'frames differ from the eager arm\'s at %r'
                             % differ[:8])
    # cold pulls at full size: frame 1 of eight 128-frame strides, each on
    # a fresh planner (its display segment uncached), the arms alternating
    # a pull; each pull split into planning the segment with its upload
    # (``_plan_display_seg``) and the pull on the cached segment (the
    # program's call or the eager run, and the fetch)
    cold = {'eager': [], 'program': []}
    captures = program_stats()['captures']
    for k, i in enumerate(range(1, 1024, 128)):
        for arm in (('eager', 'program') if k % 2 == 0
                    else ('program', 'eager')):
            ctx = _EagerPrograms() if arm == 'eager' else _Null()
            with ctx:
                planner = RenderPlanner(ws, window, device=card)
                t0 = time.perf_counter()
                planner._plan_display_seg(i)
                t1 = time.perf_counter()
                planner.render_display(i, transport='rgb24')
                t2 = time.perf_counter()
                planner.close()
            cold[arm].append(((t2 - t0) * 1e3, (t1 - t0) * 1e3,
                              (t2 - t1) * 1e3))
    captures = program_stats()['captures'] - captures
    print('phase 17c render_display rgb24 1920x1080 cold (frame 1 of eight '
          '128-frame strides, a fresh planner a pull, arms alternating; '
          'host clock) p50 ms total / planning and upload / the pull on the '
          'cached segment: %s; the program arm captured %d times %s'
          % ('; '.join('%s %.3f / %.3f / %.3f (totals %s)' % (
              arm, _median([c[0] for c in rows]),
              _median([c[1] for c in rows]), _median([c[2] for c in rows]),
              ', '.join('%.2f' % c[0] for c in rows))
              for arm, rows in cold.items()), captures, tag), flush=True)
    print('phase 17c render_display rgb24 warm (frames 1..63 of a cached '
          'segment, host clock to the host copy; the program arm\'s frames '
          'equal to the eager arm\'s) p50/p95 ms: %s %s'
          % ('; '.join('%s %s %.3f/%.3f' % (arm, 'full' if size is None
                                             else '%dx%d' % size, p50, p95)
                       for (arm, size), (p50, p95) in display.items()), tag),
          flush=True)

    # peak memory of a cold headline pass from no program, its captures
    # included, beside the memory guard's estimates: before the pass (no
    # program live) and at its last capture (the batch, the new pool and
    # the pools already live), which must not be below the peak
    _drop_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    est = _hbm_estimate_bytes(128, window, None, None, device=card)[0]
    since = _captures()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    planner = headline_planner()
    headline_pass(planner)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    planner.close()
    stats = program_stats()
    at_capture = max([p['guard_bytes'] for p in stats['programs']
                      if p['capture_index'] and p['capture_index'] > since]
                     + [est])
    print('phase 17c programs: %s; a cold headline pass from no program: '
          'peak %.3f GB above its start beside the guard\'s estimate %.3f '
          'GB before it and %.3f GB at its last capture (estimate / peak '
          '%.3f, %.3f); %d live programs hold %.3f GB on the card %s'
          % (json.dumps([{k: p[k] for k in ('key', 'frames', 'replays',
                                             'capture_ms', 'pool_bytes',
                                             'held_bytes', 'guard_bytes',
                                             'slot_bytes')}
                         for p in stats['programs']]),
             peak / 1e9, est / 1e9, at_capture / 1e9, est / peak,
             at_capture / peak, stats['live'],
             sum(p['held_bytes'] for p in stats['programs']) / 1e9, tag),
          flush=True)
    if at_capture < peak:
        raise AssertionError('the memory guard counted %d bytes at the '
                             'pass\'s last capture, below its peak of %d'
                             % (at_capture, peak))

    # (d) the region kernels with device offsets: the main path's shapes
    # and an edge overhang, f32 and bf16, beside their byte floors
    hp = headline_planner()
    _s0, sig, batches = hp._prepare((128, 256), 128)
    tparams = params_to_torch(batches[0][2], card)
    hp.close()
    from canvas_tpu_torch.render import _scale_solid_factors
    seps = []
    for cs, cp in _children_params(sig, tparams):
        if cs[0] == 'placed' and cs[3][0][0].startswith('scale_solid'):
            inner = cs[3][0]
            seps.append((cp[0]['dy0'], cp[0]['dx0'],
                         _scale_solid_factors(inner[0], inner[1], cp[1])))
    mp = RenderPlanner(mixed, window, device=card)
    mp.stage_cache_mb = 0
    _s0, msig, mbatches = mp._prepare((1, 65), 16)
    mparams = params_to_torch(mbatches[0][2], card)
    mp.close()
    overs = [(cs[1], cp[0]['dy0'], cp[0]['dx0'])
             for cs, cp in _children_params(msig, mparams)
             if cs[0] == 'placed'
             and not cs[3][0][0].startswith('scale_solid')]
    if len(seps) != 2 or len(overs) != 3:
        raise AssertionError('expected the headline\'s 2 rank-1 regions and '
                             'config7\'s 3 DV regions, got %d and %d'
                             % (len(seps), len(overs)))
    rng = np.random.default_rng(SEED + 17)
    rows = []
    worst = 0.0

    cases = []
    for oy, ox, (color, ry, rx) in seps:
        cases.append(('region_over_sep', 128, ry.shape[1], rx.shape[1], oy,
                      ox, (color, ry, rx)))
    for (h, w), oy, ox in overs:
        cases.append(('region_over', 16, h, w, oy, ox, None))
    n_path = len(cases)
    # region_over over config7's three regions: [ms, byte floor ms]
    over_total = {'f32': [0.0, 0.0], 'bf16': [0.0, 0.0]}
    # over the bottom edge: the last block row (rows 1024..1087) of a
    # 1080-row frame
    for kind, B in (('region_over_sep', 128), ('region_over', 16)):
        oy, ox = _device_offsets(card, 1024, 1792)
        cases.append((kind, B, 64, 128, oy, ox, None))
    for i, (kind, B, h, w, oy, ox, factors) in enumerate(cases):
        dy0, dx0 = int(oy), int(ox)
        for dtype in (torch.float32, torch.bfloat16):
            P, A = [torch.from_numpy(rng.uniform(0, 1, s).astype(
                np.float32)).to(card, dtype) for s in ((B, 3, H, W),
                                                         (B, 1, H, W))]
            if kind == 'region_over_sep':
                args = factors or [torch.from_numpy(rng.uniform(
                    0, 1, s).astype(np.float32)).to(card)
                    for s in ((B, 4), (B, h), (B, w))]
            else:
                args = [torch.from_numpy(rng.uniform(0, 1, (B, 4, h, w))
                                         .astype(np.float32)).to(card, dtype)]
            P2, A2 = P.clone(), A.clone()
            fn = getattr(cuda_ops, kind)
            plain = getattr(cuda_ops, kind + '_plain')
            before = _instantiation_counts()[kind]
            fn(P, A, *args, oy, ox)
            inst = _instantiation(kind, before)
            plain(P2, A2, *args, dy0, dx0)
            worst = max(worst, _max_diff((P, A), (P2, A2)))
            tk, tp = paired_ms(lambda: fn(P, A, *args, oy, ox),
                               lambda: plain(P2, A2, *args, dy0, dx0), 20, 3)
            px = B * min(h, H - dy0) * min(w, W - dx0)
            per_px = ((32 if kind == 'region_over_sep' else 48)
                      // (2 if dtype == torch.bfloat16 else 1))
            floor = _bound(px * per_px, 0)[0]
            dname = 'bf16' if dtype == torch.bfloat16 else 'f32'
            rows.append('%s %s %dx%d @ (%d, %d) batch %d, %s instantiation: '
                        'cuda %.4f ms, plain %.4f ms, byte floor %.4f ms (%d '
                        'B/px), time / floor %.2f' % (
                            kind, dname, h, w, dy0, dx0, B, inst, tk, tp,
                            floor, per_px, tk / floor))
            if kind == 'region_over' and i < n_path:
                over_total[dname][0] += tk
                over_total[dname][1] += floor
            del P, A, P2, A2
    print('phase 17d region kernels with device offsets (int32 values in '
          'card memory) against their plain versions, max diff %r (must be '
          '0): %s %s' % (worst, '; '.join(rows), tag), flush=True)
    for dname, (ms, floor_ms) in over_total.items():
        _region_over_total('17d', dname, ms, floor_ms, tag)
    if worst != 0.0:
        raise AssertionError('a region kernel with device offsets differs '
                             'from plain by %r' % worst)
    del tparams, mparams
    torch.cuda.empty_cache()
    print('phase 17 launches (17a, 17b): %s; phase 17 %.1f s %s'
          % (json.dumps(launches), time.perf_counter() - t_phase, tag),
          flush=True)
    return launches


def _segment_status(text):
    """The ``segment ...`` lines of an ``explain`` report."""
    return [line for line in text.splitlines() if line.startswith('segment')]


def _held_program_case(tag, name, src, window, batch, pause, route, want,
                       card):
    """One scenario of phase 18 (a): planner A streams frames 1..64 of
    *src* (one segment) at *batch* with the plan cache off and holds the
    segment's program across the batches; after *pause* batches planner
    B renders frames 200..201 twice, which evicts A's program by count
    (``_PROGRAMS_KEPT`` 1) or by memory (``CANVAS_HBM_MB`` at 1.25x B's
    batch with its pool, so the guard must drop A's program to fit it);
    then A resumes. *want* is an uninterrupted pass's [(start, n, out)].
    Returns the launches counted."""
    import torch

    from canvas_tpu_torch import render
    from canvas_tpu_torch.render import RenderPlanner

    made = []
    init = render._Program.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    _drop_programs()
    _empty_cache()
    a = RenderPlanner(src, window, device=card)
    a.plan_cache_segments = 0
    b = RenderPlanner(src, window, device=card)
    kept, hbm = render._PROGRAMS_KEPT, os.environ.get('CANVAS_HBM_MB')
    before = render.program_stats()
    render._Program.__init__ = recording
    _zero_launch_counts()
    try:
        batches = a.iter_batches(1, 65, batch=batch)
        got = [next(batches) for _k in range(pause)]
        held = [p for p in made if p.captured]
        if len(held) != 1:
            raise AssertionError('%s: %d captured programs before the pause'
                                 % (name, len(held)))
        held_a = held[0].held_bytes
        try:
            if route == 'count':
                render._PROGRAMS_KEPT = 1
            else:
                need = render._check_hbm_footprint(2, window, None, 1,
                                                   card)[card]
                os.environ['CANVAS_HBM_MB'] = repr(1.25 * need / (1 << 20))
            for _rep in range(2):
                b.render(200, 202, device_out=True)
        finally:
            render._PROGRAMS_KEPT = kept
            if hbm is None:
                os.environ.pop('CANVAS_HBM_MB', None)
            else:
                os.environ['CANVAS_HBM_MB'] = hbm
        if not held[0].evicted:
            raise AssertionError('%s: B did not evict A\'s program by %s'
                                 % (name, route))
        got += list(batches)
        _sync(card)
    finally:
        render._Program.__init__ = init
    launches = _launch_counts()
    after = render.program_stats()
    moved = {k: after[k] - before[k] for k in (
        'captures', 'replays', 'orphans', 'evictions')}
    guard = render._held_bytes(card)
    every = sum(p.held_bytes for p in made)
    cached = sum(p.held_bytes for p in made
                 if render._program_cache.get(p.key) is p)
    outside = [p for p in made if p.captured
               and render._program_cache.get(p.key) is not p]
    err = max(float((g.float() - w.float()).abs().max())
              for (_s, _n, g), (_s2, _n2, w) in zip(got, want))
    if [(s, n) for s, n, _o in got] != [(s, n) for s, n, _o in want]:
        raise AssertionError('%s: batches %r' % (name, [(s, n) for s, n, _o
                                                        in got]))
    live = _segment_status(a.explain(1, 65))
    family = (render.signature(a._plan((1, 65))), card)
    live_family = family in render._compiled_families
    _drop_programs()
    left = sum(1 for p in made
               if (p.family, p.device) in render._compiled_families)
    status = _segment_status(a.explain(1, 65))
    a.close()
    b.close()
    print('phase 18 held program, %s by %s: A paused after %d of %d batches '
          'of %d, its program holding %d bytes; captures %d, replays %d, '
          'orphans %d, evictions %d; _held_bytes %d beside %d held by every '
          'program made (%d in the cache, %d captured outside it); '
          'families left after the '
          'programs are cleared %d (segment family live before: %s); '
          'explain %r while live, %r after; A\'s resumed frames vs an '
          'uninterrupted pass max diff %r %s'
          % (name, route, pause, len(got), batch, held_a, moved['captures'],
             moved['replays'], moved['orphans'], moved['evictions'], guard,
             every, cached, len(outside), left, live_family, live, status,
             err, tag), flush=True)
    if (moved['orphans'] or outside or guard != every or left or err != 0.0
            or moved['evictions'] <= 0
            or not all(line.endswith('program not captured')
                       for line in status)):
        raise AssertionError('%s by %s: a held program outlived its eviction'
                             % (name, route))
    return launches


def _held_programs(tag, window, device=None):
    """Phase 18: held programs and the tools.
    (a) the eviction of a program a caller holds (``_held_program_case``)
    on the headline at batch 8 and on config7 at batch 16, by count and
    by memory: no capture outside the cache (no orphan), the guard's
    ``_held_bytes`` equal to what every program made holds, no family
    left once the programs are cleared, ``explain`` then "not captured",
    A's resumed frames bit-equal to an uninterrupted pass; (b)
    ``tools.explain --demo`` over frames 128..191 before and after a
    render of that segment captures its program, with its status lines and
    wall ms; (c) ``tools.decode_raw_image`` to a temporary PPM in the
    default mode (the torch arms on the card), its ms, and its pixels
    against the same pull on the host (``force_backend('numpy')``),
    which may differ by 1 u8 step; (d) frames 0, 1, 500 and 1023 of
    ``timelines.crossfade_timeline(1024)`` (config2) through
    ``iter_batches`` against the NumPy pull path at the headline's 2e-3.
    Returns the launches of (a) and (b).

    ``device='cpu'`` rehearses it on the CPU at a small window:
    ``_held_programs(tag, box2i(0, 0, 159, 89), device='cpu')``."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from canvas_tpu_torch import backend, timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    from canvas_tpu_torch.tools import decode_raw_image, explain, on_device

    t_phase = time.perf_counter()
    card = (torch.device(device) if device is not None
            else torch.device('cuda', torch.cuda.current_device()))
    launches = dict.fromkeys(_launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the eviction of held programs
    for name, src, batch, pause in (
            ('headline', timelines.build_timeline(1024), 8, 3),
            ('config7', timelines.mixed_timeline(256), 16, 2)):
        ref = RenderPlanner(src, window, device=card)
        ref.plan_cache_segments = 0
        _zero_launch_counts()
        want = list(ref.iter_batches(1, 65, batch=batch))
        add(_launch_counts())
        ref.close()
        for route in ('count', 'memory'):
            add(_held_program_case(tag, name, src, window, batch, pause,
                                   route, want, card))
        del want
    _drop_programs()
    _empty_cache()

    # (b) tools.explain --demo before and after a render of 128..191
    argv = ['--demo', '--start', '128', '--stop', '192']
    if card.type != 'cuda':
        argv += ['--device', 'cpu']
    lines = {}
    for when in ('before', 'after'):
        if when == 'after':
            # the demo's timeline at the demo's window: the same family
            planner = RenderPlanner(timelines.build_timeline(1024),
                                    box2i(0, 0, 1919, 1079), device=card)
            _zero_launch_counts()
            for _rep in range(2):        # eagerly, then captured
                planner.render(128, 192, device_out=True)
            _sync(card)
            add(_launch_counts())
            planner.close()
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            if explain.main(argv) != 0:
                raise AssertionError('explain --demo failed')
        ms = (time.perf_counter() - t0) * 1e3
        lines[when] = _segment_status(said.getvalue())
        print('phase 18 tools.explain --demo frames 128..191 %s a render: '
              '%s, %.1f ms wall %s' % (when, lines[when], ms, tag),
              flush=True)
    if (not lines['before'] or lines['before'][-1].endswith('CAPTURED')
            or not lines['after'][-1].endswith('program CAPTURED')):
        raise AssertionError('explain --demo: %r' % lines)
    _drop_programs()

    # (c) tools.decode_raw_image in the default mode
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'raw_image.ppm')
        argv = [path] + (['--device', 'cpu'] if card.type != 'cuda' else [])
        with on_device(device):
            on_torch = (backend.use_torch_for((4, 480, 720)),
                        backend.eager_device().type)
        with contextlib.redirect_stdout(io.StringIO()):
            decode_raw_image.main(argv)          # warm
            t0 = time.perf_counter()
            decode_raw_image.main(argv)
            ms = (time.perf_counter() - t0) * 1e3
        with open(path, 'rb') as f:
            ppm = f.read()
    header = b'P6\n720 480\n255\n'
    with backend.force_backend('numpy'):
        host = decode_raw_image.render_rgb()
    got = np.frombuffer(ppm[len(header):], np.uint8).reshape(host.shape)
    du8 = np.abs(got.astype(np.int16) - host.astype(np.int16))
    print('phase 18 tools.decode_raw_image: %.1f ms a run (the pull takes '
          'the torch arms: %s, on %s), PPM header %r, max u8 diff against '
          'the host pull %d on %d of %d values %s'
          % (ms, on_torch[0], on_torch[1], ppm[:len(header)],
             int(du8.max()), int(np.count_nonzero(du8)), du8.size, tag),
          flush=True)
    if (ppm[:len(header)] != header or int(du8.max()) > 1
            or not on_torch[0] or on_torch[1] != card.type):
        raise AssertionError('decode_raw_image: header %r, max u8 diff %d, '
                             'arm %r' % (ppm[:len(header)], int(du8.max()),
                                         on_torch))

    # (d) config2's crossfade against the NumPy pull path
    fade = timelines.crossfade_timeline(1024)
    planner = RenderPlanner(fade, window, device=card)
    picked = {}
    for start in (0, 500, 1020):
        for s, n, out in planner.iter_batches(start, start + 4, batch=4):
            for i in range(s, s + n):
                if i in (0, 1, 500, 1023):
                    picked[i] = out[i - s].cpu().numpy()
    planner.close()
    errs = {}
    for i in sorted(picked):
        want = _numpy_pull(fade, i, window)
        errs[i] = (float(np.abs(picked[i].astype(np.float32)
                                - want.astype(np.float32)).max()),
                   _bit_share(picked[i], want))
    print('phase 18 config2 crossfade at %dx%d: frames %s vs the NumPy pull '
          'path [max diff, bit-equal share] %s (atol 2e-3) %s'
          % (window.width, window.height, sorted(picked), json.dumps(errs),
             tag), flush=True)
    if sorted(picked) != [0, 1, 500, 1023] or any(
            not np.isfinite(picked[i]).all() or e > 2e-3
            for i, (e, _s) in errs.items()):
        raise AssertionError('config2 frames differ from the pull path: %r'
                             % errs)
    print('phase 18 held programs and tools: %.1f s, launches %s %s'
          % (time.perf_counter() - t_phase, json.dumps(launches), tag),
          flush=True)
    return launches


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_program_notes = []


def _note_programs(phases):
    """Note the render programs' totals after *phases* (``_print_programs``
    reports what each stretch of phases captured and replayed)."""
    from canvas_tpu_torch.render import program_stats
    stats = program_stats()
    since = _program_notes[-1][1]['captures'] if _program_notes else 0
    split = {}
    for prog in stats['programs']:
        if (prog['capture_index'] or 0) > since and prog['capture_split']:
            split.setdefault('capture_ms', []).append(prog['capture_ms'])
            for k, v in prog['capture_split'].items():
                split.setdefault(k, []).append(v)
    _program_notes.append((phases, {k: stats[k] for k in (
        'calls', 'captures', 'replays', 'replayed_captures', 'evictions',
        'orphans')},
        {k: [round(min(v), 3), round(_median(v), 3), round(max(v), 3)]
         for k, v in split.items()}))


def _print_programs(tag):
    """Per stretch of phases: program calls, captures, replays, first
    replays (of a capture made then or before) and evictions, with the
    min/median/max capture ms and its split over the captures still live
    at its end; and over the run, how many captures a later call ever
    replayed."""
    rows, last = [], None
    for phases, totals, split in _program_notes:
        rows.append('%s %s %s' % (phases, json.dumps(
            {k: v - (last or {}).get(k, 0) for k, v in totals.items()}),
            json.dumps(split)))
        last = totals
    print('programs by phase: %s; over the run %d of %d captures replayed '
          'at least once %s' % ('; '.join(rows), last['replayed_captures'],
                                last['captures'], tag), flush=True)


def main():
    sys.meta_path.insert(0, _Refuse())
    import numpy as np
    import torch

    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import cuda_ms
    from canvas_tpu_torch.ops import _build, cuda_ops
    from canvas_tpu_torch.render import (RenderPlanner, box2i,
                                         params_to_torch, run)

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
        outP, outA = cuda_ops.region_over(P, A, layer,
                                          *_device_offsets(dev, dy0, dx0))
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
        cuda_ops.region_over_sep(P, A, color, ry, rx,
                                 *_device_offsets(dev, dy0, dx0))
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
          'planes at 96x256, region_over_sep and region_over (f32, bf16) '
          '128x256 @ (64, 128) of 150x300 and 64x128 @ (64, 128) of shifted '
          '96x256 planes (and layer), B=3, max diff %r (must be 0); '
          'launches [16-byte, scalar] in the checks above and here: %s %s'
          % (err_scalar, json.dumps(by_inst), tag), flush=True)
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
        want = _numpy_pull(ws, i, window)
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
    planner.invalidate_display_cache()
    planner.plan_cache_segments = 0     # cold: every pass plans anew
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
    phase5 = dict(fps=fps, busy_ms=busy_ms, batches=len(work), idle=idle)
    print('phase 5 timing: 1080p_10layer_composite_fps_per_chip %.1f '
          '(best of 3 cold passes over frames %d..%d, batch %d, plan cache '
          'off; walls %s s); device busy %.3f ms of %.3f ms wall, device '
          'idle share %.3f %s'
          % (fps, start, stop - 1, batch,
             ', '.join('%.4f' % w for w in walls), busy_ms, wall * 1e3,
             idle, tag), flush=True)

    # Kernels at the main path's shapes: the first timed batch's params.
    kern = _headline_kernels(work[0], H, W, batch)
    err_main = kern['err_main']
    err_reg = max(err_reg, kern['err_reg'])
    fold_ms, fold_plain_ms = kern['fold_ms'], kern['fold_plain_ms']
    reg_ms, reg_plain_ms = kern['reg_ms'], kern['reg_plain_ms']
    fold_bytes, fold_ops = kern['fold_bytes'], kern['fold_ops']
    reg_bytes, reg_ops = kern['reg_bytes'], kern['reg_ops']
    for name, tk, tp, nbytes in kern['rows']:
        floor = _bound(nbytes, 0)[0]
        print('phase 5 kernel %s, batch %d: cuda %.4f ms (%.1f GB/s for %.1f '
              'MB; byte floor %.4f ms, time / floor %.2f), plain torch %.4f '
              'ms %s' % (name, batch, tk, nbytes / tk / 1e6, nbytes / 1e6,
                         floor, tk / floor, tp, tag), flush=True)

    del work, kern
    torch.cuda.empty_cache()

    # 6-7. the mixed-content path
    _note_programs('1-5')
    mixed, mixed_launches = _mixed_slice(tag, window)
    (err_ro_path, ro_ms, ro_plain_ms, ro_bound, ro_by,
     config7) = _mixed_timing(
        tag, mixed, window)

    _note_programs('6-7')
    # 8. the fold studies and the roofline probe
    del mixed
    torch.cuda.empty_cache()
    study_kernels = _studies(tag)

    # 9. the export conversions of the headline
    torch.cuda.empty_cache()
    post_launches, yuv420_kernel = _posts(tag, window)

    _note_programs('8-9')
    # 10. the editor's display path
    torch.cuda.empty_cache()
    display_launches, bf16, latency = _display_path(tag, window)

    _note_programs('10')
    # 11. coded video and replay
    torch.cuda.empty_cache()
    replay_launches = _coded_and_replay(tag, window)

    _note_programs('11')
    # 12. config6 and config6b: the export path at 4K
    torch.cuda.empty_cache()
    export_launches = _export_4k(tag)

    _note_programs('12')
    # 13. the editor on the card; phase 5's planner is the headline its
    # headline project is held to
    torch.cuda.empty_cache()
    editor_launches = _editor(tag, window, planner, dict(
        phase5=phase5, config7=config7, display=latency[None]))

    _note_programs('13')
    # 14. an editor session through the UI layer
    del planner
    torch.cuda.empty_cache()
    session_launches = _editor_session(tag, window)

    _note_programs('14')
    # 15. the eager pull on the card
    torch.cuda.empty_cache()
    eager_launches = _eager_pull(tag, window)

    _note_programs('15')
    # 16. multi-device rendering on logical shards of the card
    torch.cuda.empty_cache()
    sharded_launches = _multi_device(tag, window, config7)

    _note_programs('16')
    # 17. the render programs: one CUDA graph per signature
    torch.cuda.empty_cache()
    program_launches = _programs(tag, window)
    _note_programs('17')
    # 18. held programs under eviction, and the tools
    torch.cuda.empty_cache()
    held_launches = _held_programs(tag, window)
    _note_programs('18')
    _print_programs(tag)

    total = {k: (launches[k] + mixed_launches[k] + post_launches[k]
                 + display_launches[k] + replay_launches[k]
                 + export_launches[k] + editor_launches[k]
                 + session_launches[k] + eager_launches[k]
                 + sharded_launches[k] + program_launches[k]
                 + held_launches[k])
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
    ] + [
        {'name': _POST_KERNEL, 'route': 'cuda',
         'source': 'canvas_tpu_torch/csrc/yuv420_post.cu',
         'replaces': 'canvas_tpu/ops/color.py:628',
         'launches': total[_POST_KERNEL],
         'max_abs_err': yuv420_kernel[0],
         'ms': yuv420_kernel[1], 'plain_ms': yuv420_kernel[2],
         'bound_ms': yuv420_kernel[3], 'bound_by': yuv420_kernel[4],
         'library_ms': None},
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
