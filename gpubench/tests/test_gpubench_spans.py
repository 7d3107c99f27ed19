"""The readers of the program's spans and counters: nothing where they
find nothing, and a reading in a traced rehearsal of each cell on the
CPU wherever the CPU has one (the post's device time needs a card)."""

import time

import pytest

from gpubench import cells, core

#: The readers of the program's own spans and counters, and the cells
#: they are listed in.
SPAN_METRICS = ('prepare_wait_ms_per_frame', 'dispatch_ms_per_frame',
                'post_device_ms_per_frame', 'coded_stage_ms_per_frame',
                'plan_cache_hit_share', 'to_host_ms_per_frame')

BENCH = cells.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def _listed(cell):
    return {m['name'] for m in cells.cell(cell)['per_layer']
            if m['name'].split('.')[0] in SPAN_METRICS}


def test_each_reader_is_listed_in_the_cells_it_reads():
    assert _listed('headline_1080p.export') == {
        'prepare_wait_ms_per_frame.export', 'dispatch_ms_per_frame.export',
        'post_device_ms_per_frame.export', 'to_host_ms_per_frame.export'}
    assert _listed('mixed_dv_1080p.export') == {
        'prepare_wait_ms_per_frame.dv_export',
        'dispatch_ms_per_frame.dv_export',
        'post_device_ms_per_frame.dv_export',
        'coded_stage_ms_per_frame.dv_export',
        'to_host_ms_per_frame.dv_export'}
    assert _listed('mixed_dv_1080p.loop') == {
        'dispatch_ms_per_frame.loop', 'plan_cache_hit_share.loop'}


@pytest.mark.parametrize('stem', SPAN_METRICS)
def test_nothing_read_where_nothing_is_there(stem):
    read = cells.reader(stem)
    assert read({'report': {}, 'frames': 0}) is None
    assert read({'report': {}, 'frames': 128}) is None


def test_readers_divide_by_frames():
    rep = {'render.prepare_wait': (0.5, 4), 'render.dispatch': (0.25, 9),
           'render.post.device': (0.125, 8), 'render.stage.coded': (1.0, 5),
           'backend.to_host': (2.0, 8), 'render.plan_cache.hit': (0.0, 3),
           'render.plan_cache.miss': (0.0, 1)}
    ctx = {'report': rep, 'frames': 1000}
    got = {stem: cells.reader(stem)(ctx) for stem in SPAN_METRICS}
    assert got == {'prepare_wait_ms_per_frame': 0.5,
                   'dispatch_ms_per_frame': 0.25,
                   'post_device_ms_per_frame': 0.125,
                   'coded_stage_ms_per_frame': 1.0,
                   'plan_cache_hit_share': 0.75,
                   'to_host_ms_per_frame': 2.0}


@pytest.mark.parametrize('name', CELLS)
def test_a_traced_rehearsal_reads_the_spans(name):
    r = core.run_cell(cells.rehearsal(name), 20260101, 0.5, True, ['cpu'],
                      time.perf_counter())
    assert r['correct']
    listed = _listed(name)
    want = {m for m in listed if not m.startswith('post_device_')}
    assert want <= set(r['metrics']) and want
    # no card, no device time
    assert not any(m.startswith('post_device_') for m in r['metrics'])
    for m in want:
        assert r['metrics'][m]['value'] > 0
    if name.endswith('.loop'):
        assert r['metrics']['plan_cache_hit_share.loop']['value'] == 1.0
