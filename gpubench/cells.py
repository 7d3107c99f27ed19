"""Finding a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``), its CPU rehearsal, the per-layer metrics it
reports and their readers (``metrics/<name>.py``, else
``metrics/<name up to its first dot>.py``), and the kernels a roofline
counts (``kernels/*.json``).
``load`` loads a file of the harness by its path: a reader here, a layer
kind in ``graph``; ``load_reference`` a layer kind's or a post's
reference (``reference/compose``, ``check``), once ``guard`` finds that
it imports nothing of the program."""

import glob
import importlib.util
import json
import os

from gpubench import guard

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(os.path.join(ROOT, 'BENCHMARK.json'))


def cell(name):
    """The cell *name* with its configuration, traffic, limits and
    metrics: a dict."""
    bench = benchmark()
    found = [w for w in bench['workloads'] if w['name'] == name]
    if not found:
        raise SystemExit('no workload %r in BENCHMARK.json' % (name,))
    w = found[0]
    cfg = [c for c in bench['configs'] if c['name'] == w['config']][0]
    return {
        'name': name,
        'chips': int(w['chips']),
        'config': _json(os.path.join(ROOT, cfg['file'])),
        'traffic': _json(os.path.join(HERE, 'traffic',
                                      w['traffic'] + '.json')),
        'limits': _json(os.path.join(HERE, 'limits', name + '.json')),
        'end_to_end': [m for m in bench['end_to_end']
                       if name in m.get('workloads', [name])],
        'per_layer': [m for m in bench['per_layer']
                      if name in m.get('workloads', [name])],
    }


def rehearsal(name):
    """Cell *name* cut to its rehearsal on the CPU: the ``window`` of its
    configuration's ``rehearsal`` key, passes over the first 24 frames in
    batches of 8."""
    c = cell(name)
    c['config']['window'] = c['config']['rehearsal']['window']
    c['traffic'].update(batch=8, frames=24)
    return c


def load(path, name):
    """The module of the file *path*, loaded by its path under *name*."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def refuse_program_imports(path):
    """Exit naming the imports of the reference file *path* that
    ``guard.program_imports`` refuses, if it finds any."""
    bad = guard.program_imports(path)
    if bad:
        raise SystemExit('%s imports %s: a reference imports nothing of '
                         'the program' % (path, ', '.join(bad)))


def load_reference(path, name):
    """``load`` of the reference file *path*, refused if it imports the
    program."""
    refuse_program_imports(path)
    return load(path, name)


def reader(metric_name):
    """The ``read(ctx)`` function of a per-layer metric."""
    for stem in (metric_name, metric_name.split('.')[0]):
        path = os.path.join(HERE, 'metrics', stem + '.py')
        if os.path.exists(path):
            return load(path, 'gpubench.metrics.'
                        + stem.replace('.', '_')).read
    raise SystemExit('no reader for metric %r under gpubench/metrics'
                     % (metric_name,))


def kernels():
    """The kernels of ``kernels/*.json``: each a dict with ``name`` (its
    file's stem), ``symbol`` (the name the device trace gives it up to
    its template arguments) and what it moves per pixel."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, 'kernels', '*.json'))):
        k = _json(path)
        k['name'] = os.path.splitext(os.path.basename(path))[0]
        out.append(k)
    return out
