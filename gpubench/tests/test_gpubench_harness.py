"""The harness: its cells, metrics and readers found by name, a tiny
rehearsal of each cell on the CPU (no JAX module loaded, no file of the
old JAX benchmark opened), the quality-9 control and planted faults
refused by the check, and the command's refusals; layer kinds and posts
found as files, a mesh of the cell's devices, and the trace read card
by card."""

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import record_function

from canvas_tpu_torch.render import RenderPlanner

from gpubench import cells, check, core, graph, guard, trace
from gpubench.reference import compose

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = cells.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def rehearse(name, seed=20260101, quality=None, devices=('cpu',)):
    """A rehearsal of *name*: a cell's name, or a cell cut by
    ``cells.rehearsal``."""
    cell = cells.rehearsal(name) if isinstance(name, str) else name
    return core.run_cell(cell, seed, 0.5, False, list(devices),
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
        assert len(cell['config']['rehearsal']['window']) == 4
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


# --- layer kinds and posts found as files ------------------------------------

#: A test's layer kind, ``checker``: a solid of ``color`` over ``window``
#: whose alpha alternates with ``alpha`` by ``tile`` x ``tile`` tile, as a
#: stack of windowed solids built and rendered through the functions each
#: side is handed.
CHECKER_TILES = '''
def tiles(spec):
    x0, y0, x1, y1 = spec['window']
    n = spec['tile']
    out = []
    for y in range(y0, y1 + 1, n):
        for x in range(x0, x1 + 1, n):
            color = list(spec['color'])
            if ((x - x0) // n + (y - y0) // n) % 2:
                color[3] = spec['alpha']
            out.append({'kind': 'solid', 'color': color,
                        'window': [x, y, min(x + n - 1, x1),
                                   min(y + n - 1, y1)]})
    return out
'''

CHECKER_BUILD = CHECKER_TILES + '''
from canvas_tpu_torch import process


def build(spec, length, seed, build_layer):
    ws = process.VideoWorkspace()
    for z, tile in enumerate(tiles(spec)):
        ws.add(source=build_layer(tile, length, seed), x=0, length=length,
               z=z)
    return ws
'''

CHECKER_RENDER = CHECKER_TILES + '''

def render(renderer, spec, frame, full):
    return renderer.stack(tiles(spec), frame, full)
'''

#: A test's reference of the port's 'rgba_u8' post: the gamma45 u8 levels
#: of R, G, B, A interleaved along each row.
RGBA_U8 = '''
import torch

from gpubench.reference import post, tables


def apply(x16):
    levels = torch.from_numpy(tables.gamma45_levels()).to(x16.device)
    u8 = post.gamma45_floor(x16, levels).to(torch.uint8)
    B, _C, H, W = u8.shape
    return u8.permute(0, 2, 3, 1).reshape(B, H, W * 4)
'''


@pytest.fixture
def checker(tmp_path, monkeypatch):
    """The ``checker`` kind's two files in lookup directories of a test's
    own."""
    for directory, text, module in ((tmp_path / 'layers', CHECKER_BUILD,
                                     graph),
                                    (tmp_path / 'reference_layers',
                                     CHECKER_RENDER, compose)):
        directory.mkdir()
        (directory / 'checker.py').write_text(text)
        monkeypatch.setattr(module, 'LAYERS_DIR', str(directory))
    return tmp_path


def checker_cell(template):
    """The rehearsal of *template* (a cell's name) over a configuration
    of a background, a checker and a checker under a 1.5x scaler."""
    cell = cells.rehearsal(template)
    tile = {'kind': 'checker', 'tile': 8, 'color': [0.9, 0.3, 0.1, 1.0],
            'alpha': 0.5}
    cell['config']['layers'] = [
        {'kind': 'solid', 'color': [0.1, 0.1, 0.12, 1.0]},
        dict(tile, window=[570, 250, 633, 297]),
        {'kind': 'scaler', 'source': dict(tile, window=[0, 0, 63, 31]),
         'target_point': {'lerp': [[700, 300], [720, 310]]},
         'source_point': [0.0, 0.0], 'scale_factors': [1.5, 1.5],
         'source_rect': [0, 0, 63, 31]}]
    cell['config']['window'] = [560, 240, 879, 419]
    return cell


@pytest.mark.parametrize('template', ['headline_1080p.export',
                                      'mixed_dv_1080p.loop'])
def test_a_layer_kind_of_its_own_rehearses_correct(template, checker):
    r = rehearse(checker_cell(template))
    assert r['correct'] and r['failed'] == 0 and r['attempted'] > 0


def test_a_layer_kind_of_its_own_is_checked(checker, monkeypatch):
    real = RenderPlanner.iter_batches

    def broken(self, *args, **kwargs):
        return _altered(real(self, *args, **kwargs))

    monkeypatch.setattr(RenderPlanner, 'iter_batches', broken)
    assert not rehearse(checker_cell('mixed_dv_1080p.loop'))['correct']


@pytest.fixture
def rgba_post(tmp_path, monkeypatch):
    """A reference of the post 'rgba_u8' in a lookup directory of a
    test's own."""
    (tmp_path / 'rgba_u8.py').write_text(RGBA_U8)
    monkeypatch.setattr(check, 'POSTS_DIR', str(tmp_path))


def rgba_cell():
    cell = cells.rehearsal('headline_1080p.export')
    cell['traffic']['post'] = 'rgba_u8'
    return cell


def test_a_post_of_its_own_rehearses_correct(rgba_post):
    r = rehearse(rgba_cell())
    assert r['correct'] and r['failed'] == 0
    assert r['checks']['u8_mismatch_share']['value'] == 0


@pytest.mark.parametrize('fault', ['stale', 'altered'])
def test_a_post_of_its_own_refuses_a_fault(fault, rgba_post, monkeypatch):
    real = RenderPlanner.iter_batches
    wrap = FAULTS[fault]()

    def broken(self, *args, **kwargs):
        return wrap(real(self, *args, **kwargs))

    monkeypatch.setattr(RenderPlanner, 'iter_batches', broken)
    assert not rehearse(rgba_cell())['correct']


def test_an_unknown_kind_is_refused_naming_its_files(checker):
    config = {'length': 8, 'layers': [{'kind': 'no_such_kind'}]}
    with pytest.raises(SystemExit) as e:
        graph.build(config, 1)
    for directory in (graph.LAYERS_DIR, compose.LAYERS_DIR):
        assert os.path.join(directory, 'no_such_kind.py') in str(e.value)
    renderer = compose.Renderer(dict(config, window=[0, 0, 7, 7]), 1, 'cpu')
    with pytest.raises(SystemExit) as e:
        renderer.layer(config['layers'][0], 0, (0, 0, 7, 7))
    assert os.path.join(compose.LAYERS_DIR, 'no_such_kind.py') \
        in str(e.value)
    # a kind with no reference is refused before it is built
    os.remove(os.path.join(compose.LAYERS_DIR, 'checker.py'))
    with pytest.raises(SystemExit) as e:
        graph.build({'length': 8, 'layers': [
            {'kind': 'checker', 'window': [0, 0, 7, 7], 'tile': 8,
             'color': [1.0, 1.0, 1.0, 1.0], 'alpha': 0.5}]}, 1)
    assert 'missing ' + os.path.join(compose.LAYERS_DIR, 'checker.py') \
        in str(e.value)


BAD_IMPORTS = ['from canvas_tpu_torch import color',
               'import canvas_tpu_torch.render as render',
               'from gpubench import graph',
               'import gpubench.drive',
               'from gpubench.core import run_cell',
               'from gpubench import cells, check',
               'from .. import compose',
               'import jax.numpy as jnp',
               'import importlib',
               'color = __import__("canvas_tpu_torch.color")']


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    files = glob.glob(os.path.join(cells.HERE, 'reference', '**', '*.py'),
                      recursive=True)
    assert len(files) >= 4
    for path in files:
        assert guard.program_imports(path) == [], path
    # what the reference imports of the harness: a loader by path and
    # the reader of imports, which import nothing of the program either
    for name, may in (('cells.py', {'importlib.util', 'gpubench.guard'}),
                      ('inputs.py', set()), ('guard.py', set())):
        path = os.path.join(cells.HERE, name)
        assert set(guard.program_imports(path)) <= may, name
    for i, text in enumerate([CHECKER_RENDER, RGBA_U8]):
        (tmp_path / ('ok%d.py' % i)).write_text(text)
        assert guard.program_imports(str(tmp_path / ('ok%d.py' % i))) == []
    for i, line in enumerate(BAD_IMPORTS):
        (tmp_path / ('bad%d.py' % i)).write_text('import os\n' + line + '\n')
        assert guard.program_imports(str(tmp_path / ('bad%d.py' % i))), line


@pytest.mark.parametrize('line', BAD_IMPORTS[:3])
def test_a_reference_that_imports_the_program_is_refused(line, checker,
                                                         rgba_post):
    ref = os.path.join(compose.LAYERS_DIR, 'checker.py')
    with open(ref, 'a') as f:
        f.write('\n' + line + '\n')
    with pytest.raises(SystemExit) as e:
        graph.build(checker_cell('headline_1080p.export')['config'], 1)
    assert ref in str(e.value) and 'nothing of the program' in str(e.value)
    with pytest.raises(SystemExit) as e:
        compose.Renderer({'length': 8, 'window': [0, 0, 7, 7]}, 1,
                         'cpu')._kind('checker')
    assert ref in str(e.value)
    post = os.path.join(check.POSTS_DIR, 'rgba_u8.py')
    with open(post, 'a') as f:
        f.write('\n' + line + '\n')
    with pytest.raises(SystemExit) as e:
        rehearse(rgba_cell())
    assert post in str(e.value)


def test_an_unknown_post_is_refused_before_the_run(monkeypatch):
    cell = cells.rehearsal('headline_1080p.export')
    cell['traffic']['post'] = 'no_such_post'
    built = []
    monkeypatch.setattr(graph, 'build', lambda *a: built.append(a))
    with pytest.raises(SystemExit) as e:
        rehearse(cell)
    assert os.path.join(check.POSTS_DIR, 'no_such_post.py') in str(e.value)
    assert built == []


# --- the devices of a cell ---------------------------------------------------

def _spy(monkeypatch):
    """The keyword arguments of every ``iter_batches`` call."""
    calls = []
    real = RenderPlanner.iter_batches

    def spy(self, *args, **kwargs):
        calls.append((args, kwargs, self.device))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(RenderPlanner, 'iter_batches', spy)
    return calls


@pytest.mark.parametrize('name', CELLS)
def test_one_device_renders_with_no_mesh(name, monkeypatch):
    calls = _spy(monkeypatch)
    cell = cells.rehearsal(name)
    traffic = cell['traffic']
    assert rehearse(cell)['correct']
    want = {'batch': traffic['batch'], 'device_out': True,
            'post': traffic['post'], 'max_inflight': traffic['max_inflight']}
    assert calls and all(c == ((0, traffic['frames']), want,
                               torch.device('cpu')) for c in calls)


@pytest.mark.parametrize('name', CELLS)
def test_a_mesh_of_four_renders_correct(name, monkeypatch):
    calls = _spy(monkeypatch)
    r = rehearse(name, devices=['cpu'] * 4)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] > 0
    assert calls
    for _args, kwargs, _device in calls:
        # iter_batches splits over its default axis, 'frames'
        assert 'axis' not in kwargs
        assert kwargs['mesh'].shape == {'frames': 4}
        assert kwargs['batch'] == 8


def test_the_cell_devices():
    cell = {'chips': 4}
    assert core.cell_devices(cell) == ['cuda:0', 'cuda:1', 'cuda:2',
                                       'cuda:3']
    assert core.cell_devices(cell, 'cpu') == ['cpu'] * 4


@pytest.mark.gpu
@pytest.mark.parametrize('name', CELLS)
def test_a_logical_mesh_on_the_card(name, cuda):
    r = rehearse(name, devices=['cuda:0'] * 2)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] > 0
    assert r['device']['platform'] == 'gpu'


# --- the trace, card by card -------------------------------------------------

class _Event:
    """One event of ``torch.profiler``'s raw results: on the host, or on
    the CUDA device *card*."""

    def __init__(self, name, a_us, b_us, card=None, annotation=False):
        self._name, self._a, self._b, self._card = name, a_us, b_us, card
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._a * 1000

    def end_ns(self):
        return self._b * 1000

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._card is None
                else torch.autograd.DeviceType.CUDA)

    def device_index(self):
        return -1 if self._card is None else self._card

    def is_user_annotation(self):
        return self._annotation


def _recorded(card_of):
    """A window of 10 ms with the harness's host spans, a device-side
    copy of one, and 400 device operations of 1-37 us scattered over it
    and past its ends, the i-th on card ``card_of(i)``."""
    events = [_Event('gpubench.window', 1000, 11000),
              _Event('gpubench.next', 1000, 4000),
              _Event('gpubench.fetch', 4000, 5000),
              _Event('gpubench.next', 5000, 9000),
              _Event('gpubench.next', 1200, 1300, 0, annotation=True)]
    x = 12345
    for i in range(400):
        x = (x * 1103515245 + 12345) % (1 << 31)
        a = 500 + x % 11000
        x = (x * 1103515245 + 12345) % (1 << 31)
        events.append(_Event('kernel_%d' % (i % 7), a, a + 1 + x % 37,
                             card_of(i)))
    return events


def _prof(events):
    results = type('Results', (), {'events': lambda self: events})()
    return type('Prof', (), {'profiler': type(
        'Profiler', (), {'kineto_results': results})()})()


def test_one_card_reads_as_before():
    # what trace.read gave this trace before it read cards apart
    picture = trace.read(_prof(_recorded(lambda i: 0)), [0])
    assert picture['busy_s'] == 0.004884
    assert picture['busy_s_by_card'] == [0.004884]
    assert picture['window_s'] == 0.01
    assert picture['breakdown']['idle_gaps'] == [
        ['gpubench.next', 0.003565], ['harness', 0.000978],
        ['gpubench.fetch', 0.000573]]
    assert trace.read(_prof(_recorded(lambda i: 0)))['busy_s'] == 0.004884


def test_two_cards_read_apart():
    events = _recorded(lambda i: i % 3 % 2)
    picture = trace.read(_prof(events), [0, 1])
    alone = [trace.read(_prof([e for e in events
                               if e.device_index() in (-1, card)]),
                        [card])['busy_s'] for card in (0, 1)]
    assert picture['busy_s_by_card'] == alone
    assert alone[0] != alone[1]
    assert picture['busy_s'] == sum(alone) / 2
    assert picture['cards_seen'] == [0, 1]
    assert len(picture['device']) == sum(
        len(trace.read(_prof([e for e in events
                              if e.device_index() in (-1, card)]),
                       [card])['device']) for card in (0, 1))


@pytest.mark.parametrize('card', [0, 1])
def test_an_annotation_is_no_work_on_its_card(card):
    events = _recorded(lambda i: i % 3 % 2)
    plain = trace.read(_prof(events), [0, 1])
    # a device-side copy of a host range over the whole window, as the
    # program's ``render.replay`` or ``backend.to_host`` give
    span = _Event('render.replay', 900, 11100, card, annotation=True)
    covered = trace.read(_prof(events + [span]), [0, 1])
    assert covered == plain
    # the control: the same interval as an operation fills its card
    worked = trace.read(_prof(events + [_Event('kernel', 900, 11100, card)]),
                        [0, 1])
    assert worked['busy_s_by_card'][card] == 0.01
    assert worked['busy_s_by_card'][1 - card] == \
        plain['busy_s_by_card'][1 - card]


@pytest.mark.gpu
def test_the_card_s_annotations_are_no_work(cuda):
    x = torch.ones(1 << 20, device='cuda')
    prof = trace.profile(True)
    with prof:
        with record_function('gpubench.window'):
            with record_function('render.replay'):
                x.add_(1)
                torch.cuda.synchronize()
                # the card idles 50 ms inside the range
                time.sleep(0.05)
                x.add_(1)
            torch.cuda.synchronize()
    picture = trace.read(prof, [0])
    names = [n for n, _a, _b in picture['device']]
    assert len(names) == 2
    assert not [n for n in names if n.startswith(('gpubench.', 'render.'))]
    assert picture['busy_s'] < 0.01
