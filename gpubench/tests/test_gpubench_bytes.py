"""The render kernels' byte counts (``metrics/bytes.py``) against
PERF.md's per-kernel table, and at the plans of the headline and of
config7."""

import json
import os

import pytest

from canvas_tpu_torch.render import RenderPlanner

from gpubench import cells, drive, graph
from gpubench.metrics import bytes as kbytes

PEAK = 3.35e12
KERNELS = cells.kernels()


def _only(*names):
    return [k for k in KERNELS if k['name'] in names]


def _tree(*children, H=1080, W=1920):
    """An ``explain`` text: one segment whose root folds *children*."""
    lines = ['segment [0, 128)  128 frames  program not captured',
             '  over_stack  static=(%d, %d)  cover=100%%' % (H, W)]
    for op, static, inner in children:
        lines.append('    %s  static=%r  cover=10%%' % (op, static))
        if inner:
            lines.append('      %s  static=(3, 3) ' % inner)
    lines.append('stage cache: 0 entries')
    return '\n'.join(lines)


HEADLINE_LIKE = _tree(('solid_stack', (6, 1080, 1920), None),
                      ('placed', (448, 768), 'scale_solid_dyn'),
                      ('placed', (448, 768), 'scale_solid_dyn'),
                      ('solid_stack', (2, 1080, 1920), None))


def _ms(nbytes, batch):
    return round(nbytes * batch / PEAK * 1e3, 4)


def test_the_kernels_are_found_by_name():
    assert sorted(k['name'] for k in KERNELS) == [
        'region_over', 'region_over_sep', 'solid_fold']
    for k in KERNELS:
        assert k['symbol'] == k['name'] + '_kernel'
        assert os.path.exists(os.path.join(cells.ROOT, k['source']))


def test_floors_of_perf_md_table():
    """Batch 128 at 1080p: solid_fold's mid fold 1.2677 ms (16 B/px) and
    finalize 1.9015 ms (24 B/px), region_over_sep 0.4207 ms a 448x768
    region (32 B/px)."""
    first = _tree(('solid_stack', (6, 1080, 1920), None),
                  ('placed', (448, 768), 'scale_solid_dyn'))
    assert _ms(kbytes.frame_bytes(first, _only('solid_fold')), 128) \
        == 1.2677
    solid = kbytes.frame_bytes(HEADLINE_LIKE, _only('solid_fold'))
    assert _ms(solid - 16 * 1920 * 1080, 128) == 1.9015
    sep = kbytes.frame_bytes(HEADLINE_LIKE, _only('region_over_sep'))
    assert _ms(sep / 2, 128) == 0.4207


def test_region_over_moves_48_bytes_a_pixel():
    text = _tree(('solid_stack', (2, 1080, 1920), None),
                 ('placed', (640, 1024), 'scale_taps_dyn'),
                 ('gain_offset', (), None),
                 ('solid_stack', (2, 1080, 1920), None))
    assert kbytes.frame_bytes(text, _only('region_over')) == 48 * 640 * 1024
    # a fold over a base reads the accumulators too
    assert kbytes.frame_bytes(text, _only('solid_fold')) == \
        1920 * 1080 * (16 + 24)


def test_not_an_over_stack_counts_nothing():
    assert kbytes.frame_bytes('segment [0, 1)\n  solid  static=(1, 2)\n',
                              KERNELS) is None


def _pass_plan(name, traffic):
    """The plan report of one pass of a cell's traffic, as the harness
    reads it."""
    with open(os.path.join(cells.HERE, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    with open(os.path.join(cells.HERE, 'traffic', traffic + '.json')) as f:
        mix = json.load(f)
    planner = RenderPlanner(graph.build(cfg, 9), graph.window(cfg),
                            device='cpu')
    return drive.Stream(planner, cfg, mix, 9, lambda: None).explain()


@pytest.mark.parametrize('name, traffic, segment, want', [
    # the headline's frames 1-128: a fold of six solids from nothing,
    # two scaled solids, the last two solids finalized to f16
    ('headline_1080p', 'export_b128', (1, 129),
     1920 * 1080 * (16 + 24) + 32 * 2 * 448 * 768),
    # config7's frames 1-64: two solids, three DV regions, two
    # torch-blended cards, a scaled solid, the last two solids finalized
    ('mixed_dv_1080p', 'export_b16', (1, 65),
     1920 * 1080 * (16 + 24) + 48 * (640 * 1024 + 704 * 1152 + 640 * 1024)
     + 32 * 512 * 896),
])
def test_frame_bytes_at_the_configurations(name, traffic, segment, want):
    segs = kbytes.segment_bytes(_pass_plan(name, traffic), KERNELS)
    assert [(s0, s1) for s0, s1, _b in segs][:2] == [(0, 1), segment]
    assert segs[1][2] == want
    assert all(b for _s0, _s1, b in segs)


def test_the_roofline_counts_each_batch_at_its_segment():
    # a 1-frame segment renders one frame, a 32-frame one its batches of
    # 16; a lone solid_stack is a finalize from nothing, 8 B/px
    text = '\n'.join(['segment [0, 1)  1 frames  program not captured',
                      '  over_stack  static=(10, 10)  cover=100%',
                      '    solid_stack  static=(10, 10)  cover=100%',
                      'segment [1, 33)  32 frames  program not captured',
                      '  over_stack  static=(10, 20)  cover=100%',
                      '    solid_stack  static=(10, 20)  cover=100%'])
    floor_bytes = 800 + 16 * 1600 + 16 * 1600 + 800
    ctx = {'trace': {'device': [('solid_fold_kernel<float>', 0.0,
                                 floor_bytes / 1e9 * 1e6 * 2)]},
           'plan_text': text, 'kernels': KERNELS, 'firsts': [0, 1, 17, 0],
           'batch': 16, 'peak_bytes_per_s': 1e9}
    assert cells.reader('render_kernels_roofline.loop')(ctx) == \
        pytest.approx(50.0)
    ctx['firsts'] = [33]
    assert cells.reader('render_kernels_roofline.loop')(ctx) is None
