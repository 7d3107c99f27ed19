"""The plain reference against canvas_tpu_torch on the CPU, at small
windows of the benchmark's configurations."""

import json
import os

import numpy as np
import pytest
import torch

from canvas_tpu_torch import backend, process, timelines
from canvas_tpu_torch.ir import signature
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.render import RenderPlanner

from gpubench import cells, graph, inputs
from gpubench.reference import compose, post, tables

#: Small windows that hold a part of every kind of layer: the cards, a
#: scaler, the crossfade, DV clips, the strip.
WINDOWS = [(560, 240, 879, 419), (1440, 60, 1759, 239),
           (1600, 900, 1919, 1079)]


def _config(name, window):
    with open(os.path.join(cells.HERE, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    cfg['window'] = list(window)
    return cfg


@pytest.mark.parametrize('name', ['headline_1080p', 'mixed_dv_1080p'])
@pytest.mark.parametrize('window', WINDOWS)
def test_reference_matches_the_planner(name, window):
    cfg = _config(name, window)
    seed = 123456789012
    start = int(inputs.rng(seed, 0).integers(cfg['length'] - 3))
    planner = RenderPlanner(graph.build(cfg, seed), graph.window(cfg),
                            device='cpu')
    got = planner.render(start, start + 3)
    ref = compose.Renderer(cfg, seed, 'cpu')
    for i in range(3):
        want = ref.frame(start + i).numpy()
        diff = np.abs(got[i].astype(np.float32) - want.astype(np.float32))
        # the planner folds premultiplied accumulators where the pull
        # path divides the alpha out after every layer: over DV content,
        # where a translucent layer lies on top, a few in a hundred
        # values land an ulp or two apart
        assert float(diff.max()) <= 2 ** -8
        assert float(np.mean(got[i].view(np.int16)
                             != want.view(np.int16))) <= 0.05


@pytest.mark.parametrize('name', ['headline_1080p', 'mixed_dv_1080p'])
def test_reference_matches_the_pull_path(name):
    cfg = _config(name, WINDOWS[0])
    seed = 77
    frame = int(inputs.rng(seed, 0).integers(cfg['length']))
    source = graph.build(cfg, seed)
    with backend.force_backend('numpy'):
        pulled = source.get_frame_f16(frame, graph.window(cfg)).data
    want = compose.Renderer(cfg, seed, 'cpu').frame(frame).numpy()
    diff = np.abs(pulled.astype(np.float32) - want.astype(np.float32))
    # the NumPy arm's DV matrix products sum in another order than the
    # plain torch form's: a value in ten thousand an ulp apart
    assert float(diff.max()) <= 2 ** -9
    assert float(np.mean(pulled.view(np.int16) != want.view(np.int16))) \
        <= 1e-3


def test_yuv420_matches_the_ports_post():
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((2, 4, 36, 64), generator=g) * 1.2 - 0.1).to(
        torch.float16)
    x[0, :, 0, :8] = torch.tensor([0.0, -0.0, 1.0, 65504.0, -1.0,
                                   float('nan'), float('inf'), 1e-7])
    assert torch.equal(post.yuv420(x), color_ops.POSTS['yuv420'](x))


def test_tables_match_the_ports():
    assert np.array_equal(
        tables.rec709_to_linear_scene().view(np.uint16),
        color_ops.get_lut('rec709_to_linear_scene').view(np.uint16))
    levels = color_ops._levels_table(None, 'cpu').numpy()
    assert np.array_equal(tables.gamma45_levels(), levels)


def test_headline_config_is_the_ports_headline():
    """The configuration file plans what ``timelines.build_timeline``
    plans: the same signature and params."""
    cfg = _config('headline_1080p', (0, 0, 1919, 1079))
    win = graph.window(cfg)
    ours = RenderPlanner(graph.build(cfg, 1), win, device='cpu')
    theirs = RenderPlanner(timelines.build_timeline(cfg['length']), win,
                           device='cpu')
    seg = (2100000, 2100016)
    a, b = ours._plan(seg), theirs._plan(seg)
    assert signature(a) == signature(b)
    pa, pb = a.flat_params([]), b.flat_params([])
    assert all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
               for x, y in zip(pa, pb) for k in x)


def test_mixed_config_is_config7_but_for_its_planes():
    cfg = _config('mixed_dv_1080p', (0, 0, 1919, 1079))
    ours = graph.build(cfg, 1)
    theirs = timelines.mixed_timeline(cfg['length'])
    assert len(ours) == len(theirs) == 10
    for a, b in zip(sorted(ours, key=lambda i: i.z),
                    sorted(theirs, key=lambda i: i.z)):
        assert type(a.source) is type(b.source)
        if isinstance(a.source, process.VideoScaler):
            assert type(a.source.source) is type(b.source.source)


def test_dv_planes_differ_every_frame_and_follow_the_seed():
    base = inputs.dv_base_planes(5, 0)
    assert [p.shape for p in base] == list(inputs.DV_SHAPES)
    assert base[0].min() >= 16 and base[0].max() <= 235
    f0 = inputs.dv_frame_planes(base, 100)
    f1 = inputs.dv_frame_planes(base, 101)
    assert not np.array_equal(f0[0], f1[0])
    assert np.array_equal(inputs.dv_base_planes(5, 0)[1], base[1])
    assert not np.array_equal(inputs.dv_base_planes(6, 0)[0], base[0])
    assert not np.array_equal(inputs.dv_base_planes(5, 1)[0], base[0])
