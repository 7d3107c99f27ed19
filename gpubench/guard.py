"""What a run may not load or read.

A run fails when, once its window has closed, ``sys.modules`` holds a
module whose top-level name is one of ``REFUSED_MODULES`` (the JAX
package, JAX itself, and the JAX package's benchmark scripts), or when it
opened a file of the JAX package or of its old benchmark
(``REFUSED_FILES``). The opens are seen by an audit hook, installed once
per process by ``watch_opens``.

The plain reference imports nothing of the program: ``program_imports``
reads a reference file's imports, and ``cells.load_reference`` refuses a
layer kind's or a post's reference that makes one.
"""

import ast
import fnmatch
import os
import sys
import threading

REFUSED_MODULES = ('jax', 'jaxlib', 'flax', 'canvas_tpu', 'bench',
                   'benchmarks')

#: The program under test.
PROGRAM = 'canvas_tpu_torch'

#: The modules of the harness that a reference may import: none of them
#: loads the program.
REFERENCE_MAY_IMPORT = ('gpubench.cells', 'gpubench.inputs',
                        'gpubench.reference')

#: Paths, relative to the repository's root, of the JAX package and of
#: the benchmark that measured it.
REFUSED_FILES = ('bench.py', 'benchmarks.py', 'BENCHMARKS.json',
                 'BENCHMARKS.md', 'BENCH_*.json', 'MULTICHIP_*.json',
                 'BASELINE.json', 'chip_smoke.py', 'cbaseline/*',
                 'canvas_tpu/*')

_opened = []
_lock = threading.Lock()
_installed = False


def _hook(event, args):
    if event == 'open' and args and isinstance(args[0], (str, bytes)):
        path = args[0]
        if isinstance(path, bytes):
            path = os.fsdecode(path)
        with _lock:
            _opened.append(path)


def watch_opens():
    """Record every file this process opens from now on."""
    global _installed
    if not _installed:
        sys.addaudithook(_hook)
        _installed = True


def refused_modules(modules=None):
    """Sorted names in *modules* (``sys.modules``) whose top-level name,
    the part before the first dot, is one of ``REFUSED_MODULES``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names)
                  if n.split('.')[0] in REFUSED_MODULES)


def _refused_import(name):
    top = name.split('.')[0]
    if top in REFUSED_MODULES or top in (PROGRAM, 'importlib'):
        return True
    return top == 'gpubench' and not any(
        name == m or name.startswith(m + '.') for m in REFERENCE_MAY_IMPORT)


def program_imports(path):
    """The imports in the Python file *path* that a reference may not
    make, as dotted names: the program, JAX or the JAX package, a module
    of the harness outside ``REFERENCE_MAY_IMPORT``, and any relative or
    dynamic (``importlib``, ``__import__``) import."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                bad.append('.' * node.level + (node.module or ''))
                continue
            names = [node.module + '.' + a.name for a in node.names]
        elif isinstance(node, ast.Name) and node.id == '__import__':
            bad.append('__import__')
            continue
        else:
            continue
        bad += [n for n in names if _refused_import(n)]
    return bad


def refused_opens(root, since=0):
    """The files of ``REFUSED_FILES`` under *root* opened after the
    *since*-th recorded open."""
    root = os.path.realpath(root)
    with _lock:
        paths = _opened[since:]
    bad = []
    for path in paths:
        full = os.path.realpath(path)
        rel = os.path.relpath(full, root)
        if rel.startswith('..'):
            continue
        if any(fnmatch.fnmatch(rel, pat) for pat in REFUSED_FILES):
            bad.append(rel)
    return sorted(set(bad))


def opens_so_far():
    with _lock:
        return len(_opened)
