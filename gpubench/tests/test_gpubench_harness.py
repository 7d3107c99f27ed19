"""The harness: its cells, metrics and readers found by name, a tiny
rehearsal of each cell on the CPU (no JAX module loaded, no file of the
old JAX benchmark opened), the quality-9 control and planted faults
refused by the check, and the command's refusals."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from canvas_tpu_torch.render import RenderPlanner

from gpubench import cells, core, guard

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = cells.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]

#: Per configuration, a small window that holds a part of every kind of
#: layer and that quality 9's bf16 accumulators change.
WINDOWS = {'headline_1080p': [560, 240, 879, 419],
           'mixed_dv_1080p': [1440, 60, 1759, 239]}


def tiny(name):
    """Cell *name* cut to a rehearsal on the CPU: a small window, passes
    over the first 24 frames in batches of 8."""
    cell = cells.cell(name)
    cell['config']['window'] = WINDOWS[cell['config']['name']]
    cell['traffic'].update(batch=8, frames=24)
    return cell


def rehearse(name, seed=20260101, quality=None):
    return core.run_cell(tiny(name), seed, 0.5, False, 'cpu',
                         time.perf_counter(), quality=quality)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['gpubench']
    assert BENCH['command'][1] == 'gpubench/run.py'
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    names = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in BENCH[group]:
            assert NAME.match(entry['name']), entry['name']
            names.add((group, entry['name']))
    assert len(names) == sum(len(BENCH[g]) for g in
                             ('configs', 'workloads', 'end_to_end',
                              'per_layer'))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for c in BENCH['configs']:
        path = os.path.join(cells.ROOT, c['file'])
        assert c['file'].startswith('gpubench/') and os.path.exists(path)
    assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= 1
    for w in BENCH['workloads']:
        assert w['chips'] in (1, 4)
        cell = cells.cell(w['name'])
        reported = {m['name'] for m in cell['end_to_end']}
        assert 'setup_s' in reported and len(reported) >= 2
        assert cell['per_layer']
        for m in cell['per_layer']:
            assert m['moves'] in reported


def test_every_metric_has_a_reader():
    for m in BENCH['per_layer']:
        assert callable(cells.reader(m['name']))


def test_a_reader_returns_nothing_where_it_finds_nothing():
    ctx = {'fetch': False, 'frames': 0, 'report': {}, 'h2d_calls': 0,
           'h2d_bytes': 0, 'programs': {'calls': 0, 'replays': 0},
           'trace': None, 'plan_text': None}
    for m in BENCH['per_layer']:
        assert cells.reader(m['name'])(ctx) is None


def test_unknown_pieces_are_refused():
    with pytest.raises(SystemExit):
        cells.cell('no_such.cell')
    with pytest.raises(SystemExit):
        cells.reader('no_such_metric.export')


@pytest.mark.parametrize('name', CELLS)
def test_a_rehearsal_runs_correct_and_loads_no_jax(name):
    guard.watch_opens()
    since = guard.opens_so_far()
    r = rehearse(name)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] > 0
    assert set(r['metrics']) == {m['name']
                                 for m in cells.cell(name)['end_to_end']}
    assert list(r)[-1] == 'checks'
    assert guard.refused_modules() == []
    assert guard.refused_opens(cells.ROOT, since) == []


def test_the_guard_sees_a_refused_open_and_module():
    guard.watch_opens()
    since = guard.opens_so_far()
    with open(os.path.join(cells.ROOT, 'BENCHMARKS.json')):
        pass
    assert guard.refused_opens(cells.ROOT, since) == ['BENCHMARKS.json']
    assert guard.refused_modules({'jax.numpy': 1, 'canvas_tpu_torch': 1,
                                  'canvas_tpu.render': 1}) == [
        'canvas_tpu.render', 'jax.numpy']


@pytest.mark.parametrize('name', CELLS)
def test_the_quality_9_control_is_refused(name):
    r = rehearse(name, quality=9)
    assert not r['correct']


def _stale():
    """Each batch's frames are the previous batch's, across calls too."""
    held = {}

    def wrap(it):
        for first, take, out in it:
            prev = held.get('out')
            held['out'] = out
            yield first, take, (out if prev is None else prev)

    return wrap


def _half_left_out(it):
    """The second half of every batch never rendered (zeros)."""
    for first, take, out in it:
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        yield first, take, out


def _altered(it):
    """A fiftieth of every frame's values moved: 3 u8 steps, or 1/16."""
    for first, take, out in it:
        out = out.clone()
        flat = out.reshape(out.shape[0], -1)
        n = flat.shape[1] // 50
        if out.dtype == torch.uint8:
            flat[:, :n] = torch.where(flat[:, :n] > 128, flat[:, :n] - 3,
                                      flat[:, :n] + 3)
        else:
            flat[:, :n] += 2 ** -4
        yield first, take, out


#: Each fault as a maker of the wrapper around ``iter_batches``.
FAULTS = {'stale': _stale, 'half_left_out': lambda: _half_left_out,
          'altered': lambda: _altered}


@pytest.mark.parametrize('name, fault', [(c, f) for c in CELLS
                                         for f in FAULTS])
def test_a_planted_fault_is_refused(name, fault, monkeypatch):
    real = RenderPlanner.iter_batches
    wrap = FAULTS[fault]()

    def broken(self, *args, **kwargs):
        return wrap(real(self, *args, **kwargs))

    monkeypatch.setattr(RenderPlanner, 'iter_batches', broken)
    r = rehearse(name)
    assert not r['correct']


def _run_cli(cwd, workload='headline_1080p.export'):
    return subprocess.run(
        [sys.executable, 'gpubench/run.py', '--workload', workload,
         '--seed', '3000000000', '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    p = _run_cli(cells.ROOT)
    assert p.returncode != 0 and p.stdout == ''
    assert 'CUDA' in p.stderr


def test_the_command_fails_beside_no_program(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / 'gpubench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = _run_cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ''


@pytest.mark.gpu
@pytest.mark.parametrize('name', CELLS)
def test_a_short_run_on_the_card(name, cuda):
    p = _run_cli(cells.ROOT, name)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
