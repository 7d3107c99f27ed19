"""Differential fuzz of the port's planner against the JAX package's, on
the CPU: tests/test_render_fuzz.py's random workspaces (solid runs,
damage regions, scalers, mixes, sequences, gaps, empty layers, pulldown,
transfers, nested workspaces, opaque pruning), built once with each
package's classes from one seed, rendered by each package's
``RenderPlanner``. The port's frames go through its render programs
(``render._get_program``), the JAX package's through its compiled
programs.

Tolerances: at quality 10 the frames are bit-equal (both evaluate the
same plan with the same f32 op order; the kernels' plain versions round
where the Pallas fallbacks do); at quality 9 (bf16 accumulators) within
the JAX fuzz's atol 3e-2 (one bf16 ulp is ~0.02 at the graphs' values).

The generator is a copy of tests/test_render_fuzz.py's, written over a
table of classes (``PORT``, ``_ref_lib()``), not an import of that test.
This module imports no JAX at its top, so tests/test_torch_gpu.py can
build the same graphs on a card.
"""

import numpy as np
import pytest

from canvas_tpu_torch import coded as port_coded
from canvas_tpu_torch import framefuncs as port_framefuncs
from canvas_tpu_torch import render as port
from canvas_tpu_torch import sources as port_sources
from canvas_tpu_torch.backend import force_backend
from canvas_tpu_torch.basetypes import box2i

WINDOW = (0, 0, 191, 143)
LENGTH = 64

#: The port's classes the generator builds from.
PORT = dict(box2i=box2i, sources=port_sources, coded=port_coded,
            framefuncs=port_framefuncs)


def _ref_lib():
    """The JAX package's classes (imported here: the card's tests build
    the port's graphs only)."""
    from canvas_tpu import coded, framefuncs, sources
    from canvas_tpu.basetypes import box2i as ref_box2i
    return dict(box2i=ref_box2i, sources=sources, coded=coded,
                framefuncs=framefuncs)


def random_color(rng):
    c = rng.rand(4)
    c[3] = rng.choice([1.0, rng.rand()])
    return tuple(float(v) for v in c)


def random_window(lib, rng):
    if rng.rand() < 0.15:
        return None                              # infinite
    x0 = rng.randint(-40, 160)
    y0 = rng.randint(-40, 120)
    return lib['box2i'](x0, y0, x0 + rng.randint(8, 180),
                        y0 + rng.randint(8, 140))


def random_leaf(lib, rng):
    src, ff = lib['sources'], lib['framefuncs']
    kind = rng.rand()
    if kind < 0.1:
        return src.EmptyVideoSource()
    color = (random_color(rng) if rng.rand() < 0.5 else
             ff.LerpFunc(random_color(rng), random_color(rng), LENGTH))
    return src.SolidColorVideoSource(color, window=random_window(lib, rng))


def random_source(lib, rng, depth=0):
    src, ff = lib['sources'], lib['framefuncs']
    r = rng.rand()
    if depth >= 2 or r < 0.35:
        return random_leaf(lib, rng)
    if r < 0.45:
        return src.VideoPassThroughFilter(
            random_source(lib, rng, depth + 1),
            offset=int(rng.randint(-10, 10)),
            start_frame=(int(rng.randint(0, 10))
                         if rng.rand() < 0.5 else None),
            end_frame=(int(rng.randint(20, 60))
                       if rng.rand() < 0.5 else None))
    if r < 0.5:
        return src.VideoGainOffsetFilter(
            random_source(lib, rng, depth + 1),
            gain=ff.LinearFrameFunc(float(rng.rand()) / LENGTH,
                                    float(rng.rand())),
            offset=0.0)
    if r < 0.55:
        return src.VideoColorTransferFilter(
            random_source(lib, rng, depth + 1),
            str(rng.choice(['rec709_to_linear_scene', 'linear_to_rec709',
                            'linear_to_srgb'])))
    if r < 0.62:
        return lib['coded'].Pulldown23RemovalFilter(
            random_source(lib, rng, depth + 1), int(rng.randint(0, 5)))
    if r < 0.75:
        return src.VideoMixFilter(random_source(lib, rng, depth + 1),
                                  random_source(lib, rng, depth + 1),
                                  ff.LerpFunc((0.0,), (1.0,), LENGTH))
    if r < 0.9:
        w = rng.randint(16, 64)
        h = rng.randint(16, 64)
        base = src.SolidColorVideoSource(
            random_color(rng), window=lib['box2i'](0, 0, w - 1, h - 1))
        # sometimes CROP with source_rect smaller than the content window
        if rng.rand() < 0.4:
            rect = lib['box2i'](int(rng.randint(0, w // 2)),
                                int(rng.randint(0, h // 2)),
                                int(rng.randint(w // 2, w)),
                                int(rng.randint(h // 2, h)))
        else:
            rect = lib['box2i'](0, 0, w - 1, h - 1)
        return src.VideoScaler(
            base,
            target_point=ff.LerpFunc(
                (int(rng.randint(0, 120)), int(rng.randint(0, 90))),
                (int(rng.randint(0, 120)), int(rng.randint(0, 90))),
                LENGTH),
            source_point=(0.0, 0.0),
            scale_factors=ff.LerpFunc(
                (float(0.5 + rng.rand()), float(0.5 + rng.rand())),
                (float(0.5 + rng.rand()), float(0.5 + rng.rand())),
                LENGTH),
            source_rect=rect)
    if r < 0.95:
        seq = src.VideoSequence()
        for _ in range(rng.randint(1, 4)):
            seq.append((random_leaf(lib, rng), int(rng.randint(0, 5)),
                        int(rng.randint(4, 20))))
        return seq
    # nested workspace (the editor's space-as-asset pattern)
    inner = src.VideoWorkspace()
    for z in range(rng.randint(1, 3)):
        inner.add(source=random_leaf(lib, rng), x=int(rng.randint(-4, 10)),
                  length=int(rng.randint(8, 40)), z=z)
    return inner


def random_workspace(lib, rng):
    ws = lib['sources'].VideoWorkspace()
    for z in range(rng.randint(1, 7)):
        ws.add(source=random_source(lib, rng),
               x=int(rng.randint(-8, 20)),
               length=int(rng.randint(10, LENGTH)),
               offset=int(rng.randint(0, 6)),
               z=z)
    return ws


def fuzz_case(lib, seed, max_len=24):
    """(workspace, start, stop) of *seed*, as tests/test_render_fuzz.py
    draws them (quality 10: ``max_len`` 24; quality 9: 16)."""
    rng = np.random.RandomState(seed)
    ws = random_workspace(lib, rng)
    start = int(rng.randint(0, 8))
    return ws, start, start + int(rng.randint(4, max_len))


def _both(seed, quality, max_len):
    """(the port's frames through its programs, the JAX package's) of
    *seed* at *quality*."""
    from canvas_tpu import backend as ref_backend
    from canvas_tpu import render as ref_render
    ws, start, stop = fuzz_case(PORT, seed, max_len)
    ref_ws, s2, e2 = fuzz_case(_ref_lib(), seed, max_len)
    assert (start, stop) == (s2, e2)
    before = port.program_stats()['calls']
    planner = port.RenderPlanner(ws, box2i(*WINDOW), quality=quality,
                                 device='cpu')
    # the planners' host staging pulls through each package's NumPy arm
    with force_backend('numpy'):
        got = planner.render(start, stop)
    planner.close()
    assert port.program_stats()['calls'] > before
    ref = ref_render.RenderPlanner(ref_ws, _ref_lib()['box2i'](*WINDOW),
                                   quality=quality)
    with ref_backend.force_backend('numpy'):
        want = np.asarray(ref.render(start, stop))
    return got, want


@pytest.mark.parametrize('seed', range(12))
def test_random_graph_matches_jax_planner(seed):
    got, want = _both(seed, 10, 24)
    assert got.shape == want.shape and got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16),
                                  err_msg='seed %d' % seed)


@pytest.mark.parametrize('seed', range(6))
def test_random_graph_quality9_matches_jax_planner(seed):
    got, want = _both(10_000 + seed, 9, 16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=3e-2,
                               err_msg='seed %d' % seed)


def test_generator_builds_the_same_graph_in_both_packages():
    """One seed gives the same plan in both packages: the signatures of
    every segment equal."""
    from canvas_tpu import render as ref_render
    ws, start, stop = fuzz_case(PORT, 3)
    ref_ws, _s, _e = fuzz_case(_ref_lib(), 3)
    planner = port.RenderPlanner(ws, box2i(*WINDOW), device='cpu')
    rwin = _ref_lib()['box2i'](*WINDOW)
    ref = ref_render.RenderPlanner(ref_ws, rwin)
    with force_backend('numpy'):
        segs = planner.segments(start, stop)
        assert segs == ref.segments(start, stop)
        for seg in segs:
            node = planner._plan(seg)
            rnode = ref_render.PlanContext(ref, np.arange(*seg),
                                           rwin).plan(ref_ws)
            assert port.signature(node) == rnode.signature()
    planner.close()
