"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``canvas_tpu_torch/csrc/`` have a plain C
interface. At first use each is compiled by its own ``nvcc`` for
``sm_90a`` (Hopper), all started together, and the objects are linked
into one shared library under ``canvas_tpu_torch/_build/``, named by a
hash of the sources and flags, and loaded with ``ctypes``. A later call
with unchanged sources loads the cached library. A failed build raises;
nothing falls back.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ['library', 'check', 'nvcc_release', 'SOURCES', 'NVCC_FLAGS',
           'build_info']

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('solid_fold.cu', 'region_over_sep.cu', 'region_over.cu',
           'fold_study.cu', 'tile_fold.cu', 'fma_chain.cu')
#: Headers the sources include; part of the library's hash.
HEADERS = ('fold_tile.cuh', 'cols.cuh')
#: Compile flags of each source (``-c``); the objects link with ``-shared``.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # color, box, gain, offset, baseP, baseA, out0, outA,
    # L, B, H, W, mode, base_bf16, vec, device, stream
    'canvas_solid_fold': (_P,) * 8 + (_I,) * 8 + (_P,),
    # color, ry, rx, P, A, B, h, w, H, W, dy0, dx0, bf16, vec,
    # device, stream
    'canvas_region_over_sep': (_P,) * 5 + (_I,) * 10 + (_P,),
    # layer, P, A, B, h, w, H, W, dy0, dx0, bf16, blocks_x, device, stream
    'canvas_region_over': (_P,) * 3 + (_I,) * 10 + (_P,),
    # color, box, gain, offset, out, L, B, H, W, variant, device, stream
    'canvas_fold_interior': (_P,) * 5 + (_I,) * 6 + (_P,),
    # x, col, box, out, L, B, H, W, mult, device, stream
    'canvas_roofline_fold': (_P,) * 4 + (_I,) * 6 + (_P,),
    # color, box, gain, offset, baseP, baseA, out0, outA,
    # L, B, H, W, mode, device, stream
    'canvas_tile_fold': (_P,) * 8 + (_I,) * 6 + (_P,),
    # x, c, out, n, k, blocks, device, stream
    'canvas_fma_chain': (_P,) * 3 + (_LL,) + (_I,) * 3 + (_P,),
}

#: What the last build or load did: 'path', 'seconds' (0 for a cached
#: library), 'cached', and 'log' (nvcc's output, with -Xptxas -v's
#: register and shared-memory report, also kept beside the library as
#: ``<library>.log``).
build_info = {}

_lock = threading.Lock()
_lib = None


def _nvcc():
    cands = []
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home:
        cands.append(os.path.join(home, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (looked in %s); the CUDA kernels '
                       'of canvas_tpu_torch cannot be built' % (cands,))


def nvcc_release():
    """The release of the nvcc that builds the kernels, e.g. '12.8'."""
    out = subprocess.run([_nvcc(), '--version'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    found = re.search(r'release (\d+\.\d+)', out)
    if not found:
        raise RuntimeError('no release in nvcc --version: %r' % out)
    return found.group(1)


def _run_all(cmds):
    """Run the commands at once; wait for all. Returns [(rc, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, text) for p, text in zip(procs, outs)]


def _build():
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs + [CSRC / h for h in HEADERS]:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    out = BUILD_DIR / ('libcanvas_kernels_%s.so' % digest.hexdigest()[:16])
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log='')
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename: a concurrent build of the
    # same sources never loads a half-written library.
    work = Path(tempfile.mkdtemp(prefix=out.name + '.', dir=BUILD_DIR))
    try:
        objs = [work / (s.stem + '.o') for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(s)]
                for s, o in zip(srcs, objs)]
        tmp = work / out.name
        link = [nvcc, '-shared', *NVCC_FLAGS[:2], '-o', str(tmp),
                *map(str, objs)]
        t0 = time.perf_counter()
        results = _run_all(cmds)
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link])
            cmds.append(link)
        seconds = time.perf_counter() - t0
        log = ''.join(text for _, text in results)
        for cmd, (rc, text) in zip(cmds, results):
            if rc != 0:
                raise RuntimeError('nvcc failed with exit code %d:\n%s\n%s'
                                   % (rc, ' '.join(cmd), text))
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.with_name(out.name + '.log').write_text(log)
    build_info.update(path=str(out), seconds=seconds, cached=False, log=log)
    return out


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.canvas_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.canvas_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib, name, code):
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.canvas_cuda_error_string(code).decode(errors='replace')
        raise RuntimeError('%s: CUDA launch failed with error %d (%s)'
                           % (name, code, msg))
