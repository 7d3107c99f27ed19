"""The port's fold studies and roofline probe (canvas_tpu_torch.studies,
canvas_tpu_torch.ops.study_ops) against the JAX package's TPU studies in
scripts/.

On the CPU the study wrappers run their plain PyTorch versions. The
same inputs, made with numpy from a seed, go through the scripts'
Pallas kernels in interpret mode (``run_fold(..., interpret=True)``,
``tile_fold(..., interpret=True)``), loaded by path since scripts/ is no
package. Tolerance atol=1e-6 is tests/test_torch_ops.py's: XLA:CPU
contracts FMAs in interpret mode. The port's own plain folds must be
bit-equal to each other and to cuda_ops.solid_fold_plain.

The roofline kernels are closures inside vpu_roofline.main() that need
a TPU, so their plain versions are held against numpy transcriptions of
vpu_roofline.py:93-97 (the FMA chain, in float64, within
study_ops.fma_chain_tol for constants in (-0.9, 0.9)) and 152-190 (the
fold, in float32 in the script's op order, bit-equal).

The CUDA kernels themselves are compared with their plain versions on
the card by tests/test_torch_gpu.py.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from canvas_tpu_torch.ops import cuda_ops as co
from canvas_tpu_torch.ops import study_ops as so
from canvas_tpu_torch.studies import check_device
from canvas_tpu_torch.studies import fold_interior_study as fis
from canvas_tpu_torch.studies import fold_tile_study as fts
from canvas_tpu_torch.studies import vpu_roofline as vr

ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """scripts/<name>.py as a module, leaving os.environ and sys.path as
    they were (the scripts set both when imported)."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            'script_' + name, os.path.join(REPO, 'scripts', name + '.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


@pytest.fixture(scope='module')
def interior_script():
    return _load_script('fold_interior_study')


@pytest.fixture(scope='module')
def tile_script():
    return _load_script('fold_tile_study')


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --- row 5: fold_interior_study ------------------------------------------

@pytest.mark.parametrize('variant', so.VARIANTS)
def test_fold_variant_matches_jax(variant, interior_script):
    """fold_variant (its plain version) against the script's run_fold in
    interpret mode at L=6, B=2, 240x512: within atol 1e-6, and bit-equal
    to solid_fold_plain."""
    L, B, H, W = 6, 2, 240, 512
    inputs = fis.make_inputs(np.random.default_rng(7), L, B, H, W, 0)
    want = np.asarray(interior_script.run_fold(
        variant, *map(jnp.asarray, inputs), H, W, interpret=True))
    launches = so.fold_variant.launches
    got = so.fold_variant(variant, *_t(*inputs), H, W)
    assert so.fold_variant.launches == launches     # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (B, 4, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got, co.solid_fold_plain(None, None, *_t(*inputs), H,
                                                W, finalize=True))


# Frames of whole 16x128 tiles, of part tiles, and smaller than a tile.
FRAME_SIZES = [(100, 300), (32, 256), (49, 129), (12, 100)]


@pytest.mark.parametrize('H, W', FRAME_SIZES)
def test_plain_fold_variants_bit_equal(H, W):
    """Every form gives solid_fold_plain's bits, with a box on the
    bottom-right edge and an empty box."""
    L, B = 5, 3
    color, box, gain, offset = fis.make_inputs(np.random.default_rng(11),
                                               L, B, H, W, 2)
    box[2, 0] = (H // 2, H - 1, W // 2, W - 1)
    box[3, 1] = (5, 1, 5, 1)
    args = _t(color, box, gain, offset)
    want = co.solid_fold_plain(None, None, *args, H, W, finalize=True)
    for variant in so.VARIANTS:
        assert torch.equal(so.fold_variant(variant, *args, H, W),
                           want), variant


def test_make_inputs_match_script(interior_script):
    for r in (0, 3):
        want = interior_script.make_inputs(np.random.default_rng(5), 6, 4,
                                           1080, 1920, r)
        got = fis.make_inputs(np.random.default_rng(5), 6, 4, 1080, 1920, r)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# --- row 6: fold_tile_study -----------------------------------------------

@pytest.mark.parametrize('case', fts.CASES, ids=lambda c: '-'.join(map(str,
                                                                       c)))
def test_tile_fold_matches_jax(case, tile_script):
    """tile_fold (its plain version) against the script's tile_fold in
    interpret mode on its five check cases: within atol 1e-6, and
    bit-equal to solid_fold_plain."""
    L, B, H, W, cover, base, fin = case
    rng = np.random.RandomState(fts.CASES.index(case) + 7)
    color, box, gain, offset = fts.make_case(rng, L, B, H, W, cover)
    P = A = None
    if base:
        P = rng.rand(B, 3, H, W).astype(np.float32)
        A = rng.rand(B, 1, H, W).astype(np.float32)
    want = tile_script.tile_fold(
        jnp, jax, None if P is None else jnp.asarray(P),
        None if A is None else jnp.asarray(A),
        *map(jnp.asarray, (color, box, gain, offset)), H, W, finalize=fin,
        interpret=True)
    tP, tA = (None, None) if P is None else _t(P, A)
    args = _t(color, box, gain, offset)
    launches = so.tile_fold.launches
    got = so.tile_fold(tP, tA, *args, H, W, finalize=fin)
    assert so.tile_fold.launches == launches
    ref = co.solid_fold_plain(tP, tA, *args, H, W, finalize=fin)
    got, want, ref = ([got], [want], [ref]) if fin else (got, want, ref)
    for g, w, r in zip(got, want, ref):
        assert g.shape == r.shape and torch.equal(g, r)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_make_case_matches_script(tile_script):
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for (L, B, H, W, cover, _base, _fin) in fts.CASES + (
            fts.FULL + ('mixed', False, False),):
        got = fts.make_case(a, L, B, H, W, cover)
        want = tile_script.make_case(b, L, B, H, W, cover)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('H, W', FRAME_SIZES)
def test_tile_fold_skips_only_missing_layers(H, W):
    """A tile keeps its base where no layer's box meets it, and the plain
    tile fold equals solid_fold_plain."""
    rng = np.random.RandomState(9)
    color, box, gain, offset = fts.make_case(rng, 3, 2, H, W, 'mixed')
    box[0, :] = (0, 9, 0, 9)                     # only the top-left corner
    box[1, :] = (H - 3, H - 1, W - 3, W - 1)     # the bottom-right corner
    box[2, :] = (5, 1, 5, 1)                     # empty
    P = rng.rand(2, 3, H, W).astype(np.float32)
    A = rng.rand(2, 1, H, W).astype(np.float32)
    args = _t(color, box, gain, offset)
    gP, gA = so.tile_fold(*_t(P, A), *args, H, W)
    wP, wA = co.solid_fold_plain(*_t(P, A), *args, H, W)
    assert torch.equal(gP, wP) and torch.equal(gA, wA)
    outside = np.ones((H, W), bool)
    outside[:10, :10] = False
    outside[H - 3:, W - 3:] = False
    np.testing.assert_array_equal(gP.numpy()[:, :, outside],
                                  P[:, :, outside])
    np.testing.assert_array_equal(gA.numpy()[:, :, outside],
                                  A[:, :, outside])
    assert not np.array_equal(gA.numpy()[:, :, :10, :10], A[:, :, :10, :10])


# --- rows 7a and 7b: vpu_roofline -----------------------------------------

def _chain_transcription(x, c, k):
    """vpu_roofline.py:93-97 in float64: acc = x; acc = acc * c[i] + x."""
    x = x.astype(np.float64)
    acc = x
    for i in range(k):
        acc = acc * np.float64(c[i]) + x
    return acc


@pytest.mark.parametrize('k', [0, 1, 8, 40])
def test_fma_chain_plain_matches_transcription(k):
    img, _consts, _boxes = vr.make_inputs(2, 64, 96, 1, seed=4)
    c = vr.chain_constants(64)
    x, tc = _t(img, c)
    launches = so.fma_chain.launches
    got = so.fma_chain(x, tc, k)
    assert so.fma_chain.launches == launches
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert got is not x
    tol = so.fma_chain_tol(x, tc, k)
    err = np.abs(got.numpy().astype(np.float64)
                 - _chain_transcription(img, c, k)).max()
    assert err <= tol / 2, (err, tol)
    if k == 0:
        np.testing.assert_array_equal(got.numpy(), img)


def _fold_transcription(x, col, box, mult):
    """vpu_roofline.py:152-190 in float32 over the whole plane, in the
    script's op order."""
    f32 = np.float32
    H, W = x.shape[2:]
    rows = np.arange(H, dtype=np.int32)[:, None]
    cols = np.arange(W, dtype=np.int32)[None, :]
    accP = [x[:, c] for c in range(3)]
    accA = x[:, 3]
    for l in range(col.shape[0]):
        a_s = col[l, 3]
        if mult:
            rm = np.where((rows >= box[l, 0]) & (rows <= box[l, 1]),
                          f32(1.0), f32(0.0))
            cm = np.where((cols >= box[l, 2]) & (cols <= box[l, 3]),
                          f32(1.0), f32(0.0))
            wt = rm * cm
            av = a_s * wt
            keep = f32(1.0) - av
            for c in range(3):
                accP[c] = (col[l, c] * a_s) * wt + accP[c] * keep
        else:
            m = (((rows >= box[l, 0]) & (rows <= box[l, 1]))
                 & ((cols >= box[l, 2]) & (cols <= box[l, 3])))
            av = np.where(m, a_s, f32(0.0))
            keep = f32(1.0) - av
            for c in range(3):
                accP[c] = (np.where(m, col[l, c] * a_s, f32(0.0))
                           + accP[c] * keep)
        accA = av + accA * keep
    return np.stack(accP + [accA], axis=1)


@pytest.mark.parametrize('mult', [False, True])
def test_roofline_fold_plain_matches_transcription(mult):
    img, consts, boxes = vr.make_inputs(2, 544, 1280, 2, seed=3)
    col = vr.fold_colors(consts, 1)
    want = _fold_transcription(img, col, boxes, mult)
    assert want.dtype == np.float32
    launches = so.roofline_fold.launches
    got = so.roofline_fold(*_t(img, col, boxes), mult)
    assert so.roofline_fold.launches == launches
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, img)


def test_roofline_inputs_follow_the_script_draw_order():
    """vpu_roofline.py:77-83 and 193-195: image, constants, then boxes,
    from one default_rng(seed)."""
    B, H, W, R = 2, 16, 24, 3
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, 4, H, W), np.float32) * 0.1
    consts = rng.standard_normal((R, 64), np.float32)
    boxes = rng.integers(0, 500, size=(6, 4)).astype(np.int32)
    boxes[:, 1] += 500
    boxes[:, 3] += 1200
    got = vr.make_inputs(B, H, W, R, seed=0)
    for g, w in zip(got, (img, consts, boxes)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(vr.fold_colors(consts, 2),
                                  consts[2, :24].reshape(6, 4) * 0.1 + 0.4)


# --- the entry points and the wrappers' refusals ---------------------------

@pytest.mark.parametrize('module, argv', [
    (fis, ['--check', '--batch', '2', '--device', 'cpu']),
    (fts, ['--check', '--device', 'cpu']),
    (vr, ['--check', '--device', 'cpu']),
], ids=['fold_interior_study', 'fold_tile_study', 'vpu_roofline'])
def test_check_entry_points_run_on_cpu(module, argv, capsys):
    assert module.main(argv) == 0
    out = capsys.readouterr().out
    assert 'parity OK' in out and 'on cpu' in out


@pytest.mark.parametrize('module', [fis, fts, vr],
                         ids=['fold_interior_study', 'fold_tile_study',
                              'vpu_roofline'])
def test_time_entry_points_need_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main(['--time'])


@pytest.mark.parametrize('module', [fis, fts, vr],
                         ids=['fold_interior_study', 'fold_tile_study',
                              'vpu_roofline'])
def test_check_entry_points_need_a_card_unless_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main(['--check'])
    with pytest.raises(RuntimeError, match='CUDA'):
        check_device()
    assert check_device('cpu') == torch.device('cpu')


def test_study_wrappers_refuse_bad_arguments():
    color, box, gain, offset = _t(*fis.make_inputs(
        np.random.default_rng(1), 2, 1, 64, 128, 0))
    with pytest.raises(ValueError, match='variant'):
        so.fold_variant('masked', color, box, gain, offset, 64, 128)
    x = torch.zeros((1, 4, 8, 8))
    with pytest.raises(ValueError):
        so.fma_chain(x, torch.zeros(8), 9)          # fewer constants than k
    with pytest.raises(ValueError):
        so.fma_chain(x, torch.zeros(so.MAX_CHAIN + 1), so.MAX_CHAIN + 1)
    with pytest.raises(ValueError, match='constants in'):
        so.fma_chain_tol(x, torch.full((4,), 1.5), 4)
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='unsupported device'):
        so.fold_variant('current', color.to(meta), box.to(meta),
                        gain.to(meta), offset.to(meta), 64, 128)
    with pytest.raises(ValueError, match='unsupported device'):
        so.roofline_fold(torch.zeros((1, 4, 8, 8), device=meta),
                         torch.zeros((2, 4), device=meta),
                         torch.zeros((2, 4), dtype=torch.int32, device=meta),
                         False)


def test_roofline_report_names_each_bound():
    """report() on a measure()-shaped result: each solid_fold pass prints
    its byte and instruction times with their shares and its bound, the
    issue ceiling is labelled assumed, and a missing clock reads as not
    measured."""
    sf = {'mid fold L=6': {'ms': 0.49, 'bytes': 1.06e9, 'byte_ms': 0.35,
                           'instructions_per_px': 208, 'issue_ms': 0.41,
                           'chain_rate_ms': 0.6, 'bound': 'not settled'},
          'finalize L=2 f16': {'ms': 0.54, 'bytes': 1.59e9, 'byte_ms': 0.53,
                               'instructions_per_px': 177, 'issue_ms': None,
                               'chain_rate_ms': 0.5, 'bound': 'bytes'}}
    r = {'B': 32, 'H': 1088, 'W': 1920, 'bytes': 2.1e9, 'copy_ms': 0.7,
         'copy_tbs': 3.0, 'chain_tbs': 2.98, 'chain_ms': {8: 0.72, 40: 0.73,
                                                          256: 3.2,
                                                          1024: 12.0},
         'chain_plain_ms': {8: 15.0, 40: 75.0}, 'slope_ms_8_40': 0.0003,
         'tflops': 46.0, 'ffma_per_s': 2.3e13, 'sm_clock_mhz': None,
         'sms': 132, 'fold_ms': {False: 0.73, True: 0.735},
         'fold_plain_ms': {False: 12.4, True: 12.4}, 'solid_fold': sf}
    lines = vr.report(r)
    assert len(lines) == 6
    assert 'SM clock not measured' in lines[2]
    assert '0.3500 ms (71%)' in lines[4] and '0.6000 ms (122%)' in lines[4]
    assert '0.4100 ms at the assumed issue ceiling' in lines[4]
    assert lines[4].endswith('bound: not settled')
    assert 'not measured at the assumed issue ceiling' in lines[5]
    assert lines[5].endswith('bound: bytes')


@pytest.mark.parametrize('ms, byte_ms, chain_rate_ms, want', [
    (0.5356, 0.5305, 0.5067, 'bytes'),
    (0.4883, 0.3537, 0.5970, 'not settled'),    # the chain's rate overshoots
    (0.4883, 0.3537, 0.3000, 'not settled'),    # neither explains the time
    (0.4883, 0.3537, 0.4700, 'instructions'),
])
def test_roofline_bound(ms, byte_ms, chain_rate_ms, want):
    assert vr.bound(ms, byte_ms, chain_rate_ms) == want


def test_solid_fold_instruction_counts_keyed_to_the_source(monkeypatch):
    """The SASS counts belong to csrc/solid_fold.cu as it is and to one
    nvcc release; a change to either must be recounted, so it raises."""
    release = vr.SOLID_FOLD_SASS['nvcc']
    assert vr.solid_fold_source_sha256() == vr.SOLID_FOLD_SASS['sha256']
    assert vr.solid_fold_instructions(release) == \
        vr.SOLID_FOLD_SASS['counts']
    with pytest.raises(RuntimeError, match='recount'):
        vr.solid_fold_instructions(release + '.1')
    monkeypatch.setattr(vr, 'solid_fold_source_sha256', lambda: '0' * 64)
    with pytest.raises(RuntimeError, match='recount'):
        vr.solid_fold_instructions(release)
