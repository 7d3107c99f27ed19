"""The PyTorch port's kernel wrappers (canvas_tpu_torch.ops.cuda_ops)
against the JAX package's (canvas_tpu.ops.pallas_ops).

On the CPU the wrappers run their plain PyTorch versions. The same
inputs, made with numpy from a seed, go through the JAX function both
ways the JAX tests run it on the CPU: its jnp fallback, and the Pallas
kernel under the interpreter (CANVAS_PALLAS_INTERPRET=1,
CANVAS_FOLD_MODE=pallas, as tests/test_pallas_interpret.py does).
Tolerance atol=1e-6 is that file's: about one f32 ulp on values in
[0, 2], for the FMA contraction of the interpreted kernel and the
rank-1 reassociation of region_over_sep. An f16 output may in addition
differ by one f16 ulp (rtol 2**-10): a one-ulp f32 difference before
the store can round to the neighbouring f16.

The CUDA kernels themselves are compared with their plain versions on
the card by tests/test_torch_gpu.py.
"""

import os
import stat

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from canvas_tpu.ops import pallas_ops as po
from canvas_tpu_torch.ops import _build
from canvas_tpu_torch.ops import cuda_ops as co

ATOL = 1e-6
F16_RTOL = 2.0 ** -10


@pytest.fixture(params=['fallback', 'interpret'])
def jax_mode(request, monkeypatch):
    """Which JAX path is the reference: the jnp fallback or the
    interpreted Pallas kernel."""
    if request.param == 'interpret':
        monkeypatch.setenv('CANVAS_PALLAS_INTERPRET', '1')
        monkeypatch.setenv('CANVAS_FOLD_MODE', 'pallas')
    else:
        monkeypatch.delenv('CANVAS_PALLAS_INTERPRET', raising=False)
        monkeypatch.delenv('CANVAS_FOLD_MODE', raising=False)
    return request.param


def _solid_layers(rng, L, B, H, W, empties=()):
    color = rng.uniform(0.0, 1.0, size=(L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=(L, B)).astype(np.float32)
    offset = rng.uniform(-0.2, 0.2, size=(L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            if (l, b) in empties:
                box[l, b] = (5, 4, 5, 4)          # y1 < y0: empty
                continue
            y0 = rng.integers(0, H - 1)
            y1 = rng.integers(y0, H)
            x0 = rng.integers(0, W - 1)
            x1 = rng.integers(x0, W)
            box[l, b] = (y0, y1, x0, x1)
    # one layer touching the bottom-right edge
    box[0, 0] = (H // 2, H - 1, W // 2, W - 1)
    return color, box, gain, offset


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (L, B, H, W, with_base, finalize, out_dtype, all-empty)
FOLD_CASES = {
    'mid_no_base_untiled_hw': (3, 2, 300, 640, False, False, None, False),
    'mid_base': (2, 2, 64, 256, True, False, None, False),
    'finalize_no_base_f32': (4, 2, 64, 256, False, True, None, False),
    'finalize_base_f16': (2, 2, 64, 256, True, True, np.float16, False),
    'all_empty_base': (2, 1, 64, 128, True, False, None, True),
}


@pytest.mark.parametrize('case', sorted(FOLD_CASES))
def test_solid_fold_matches_jax(case, jax_mode):
    L, B, H, W, with_base, finalize, out_dtype, all_empty = FOLD_CASES[case]
    rng = np.random.default_rng(sorted(FOLD_CASES).index(case) + 3)
    empties = ({(l, b) for l in range(L) for b in range(B)} if all_empty
               else {(1, B - 1)})
    color, box, gain, offset = _solid_layers(rng, L, B, H, W, empties)
    if all_empty:
        box[:] = (5, 4, 5, 4)
    P = A = None
    if with_base:
        P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)

    jP = None if P is None else jnp.asarray(P)
    jA = None if A is None else jnp.asarray(A)
    want = po.solid_fold(jnp, jax, jP, jA, jnp.asarray(color),
                         jnp.asarray(box), jnp.asarray(gain),
                         jnp.asarray(offset), H, W, finalize=finalize,
                         out_dtype=None if out_dtype is None
                         else jnp.float16)
    tP = None if P is None else torch.from_numpy(P)
    tA = None if A is None else torch.from_numpy(A)
    launches = co.solid_fold.launches
    got = co.solid_fold(tP, tA, *_t(color, box, gain, offset), H, W,
                        finalize=finalize,
                        out_dtype=None if out_dtype is None
                        else torch.float16)
    assert co.solid_fold.launches == launches   # the CPU runs no kernel
    if finalize:
        want, got = [np.asarray(want)], [got.numpy()]
        assert got[0].dtype == (out_dtype or np.float32)
        assert got[0].shape == (B, 4, H, W)
    else:
        want = [np.asarray(x) for x in want]
        got = [x.numpy() for x in got]
        assert got[0].shape == (B, 3, H, W) and got[1].shape == (B, 1, H, W)
    for g, w in zip(got, want):
        rtol = F16_RTOL if g.dtype == np.float16 else 0
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), rtol=rtol,
                                   atol=ATOL)
    if all_empty:
        np.testing.assert_array_equal(got[0], P)
        np.testing.assert_array_equal(got[1], A)
    else:
        assert np.abs(got[-1]).max() > 0.0


def test_solid_stack_matches_jax():
    rng = np.random.default_rng(5)
    L, B, H, W = 6, 3, 72, 130
    color, box, gain, offset = _solid_layers(rng, L, B, H, W, {(2, 1)})
    want = np.asarray(po.solid_stack(jnp, jax, *map(jnp.asarray,
                                                    (color, box, gain,
                                                     offset)), H, W))
    got = co.solid_stack(*_t(color, box, gain, offset), H, W).numpy()
    np.testing.assert_array_equal(got, want)


def _region_inputs(rng, B, H, W, h, w):
    P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    color = rng.uniform(0, 1, (B, 4)).astype(np.float32)
    ry = rng.uniform(0, 1, (B, h)).astype(np.float32)
    rx = rng.uniform(0, 1, (B, w)).astype(np.float32)
    return P, A, color, ry, rx


# (H, W, h, w, dy0, dx0): inside the frame; overhanging the bottom
# edge; overhanging the bottom and right edges (envelope 192 x 384).
REGION_CASES = {
    'inside': (256, 512, 128, 256, 64, 128),
    'overhang_bottom': (150, 384, 128, 256, 64, 128),
    'overhang_bottom_right': (150, 300, 128, 256, 64, 128),
}


@pytest.mark.parametrize('case', sorted(REGION_CASES))
def test_region_over_sep_matches_jax(case, jax_mode):
    H, W, h, w, dy0, dx0 = REGION_CASES[case]
    rng = np.random.default_rng(sorted(REGION_CASES).index(case) + 19)
    P, A, color, ry, rx = _region_inputs(rng, 2, H, W, h, w)
    wantP, wantA = po.region_over_sep(
        jnp, jax, jnp.asarray(P), jnp.asarray(A), jnp.asarray(color),
        jnp.asarray(ry), jnp.asarray(rx), jnp.int32(dy0), jnp.int32(dx0))
    tP, tA = _t(P, A)
    launches = co.region_over_sep.launches
    gotP, gotA = co.region_over_sep(tP, tA, *_t(color, ry, rx), dy0, dx0)
    assert co.region_over_sep.launches == launches
    assert gotP is tP and gotA is tA            # updated in place
    np.testing.assert_allclose(gotP.numpy(), np.asarray(wantP), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(gotA.numpy(), np.asarray(wantA), rtol=0,
                               atol=ATOL)
    # untouched outside the region
    np.testing.assert_array_equal(gotP.numpy()[:, :, :dy0], P[:, :, :dy0])
    np.testing.assert_array_equal(gotA.numpy()[..., :dx0], A[..., :dx0])


def test_region_over_plain_matches_jax():
    rng = np.random.default_rng(23)
    B, H, W, h, w = 2, 150, 300, 128, 256
    P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    layer = rng.uniform(0, 1, (B, 4, h, w)).astype(np.float32)
    wantP, wantA = po.region_over(jnp, jax, jnp.asarray(P), jnp.asarray(A),
                                  jnp.asarray(layer), jnp.int32(64),
                                  jnp.int32(128))
    gotP, gotA = co.region_over_plain(*_t(P, A, layer), 64, 128)
    np.testing.assert_array_equal(gotP.numpy(), np.asarray(wantP))
    np.testing.assert_array_equal(gotA.numpy(), np.asarray(wantA))


# (H, W, h, w, dy0, dx0): inside the frame; overhanging the bottom, the
# right, and both edges; and the mixed timeline's three DV regions of
# segment [1, 65) at 1080p (the last overhangs the bottom edge).
REGION_OVER_CASES = {
    'inside': (256, 512, 128, 256, 64, 128),
    'overhang_bottom': (150, 384, 128, 256, 64, 128),
    'overhang_right': (256, 300, 128, 256, 64, 128),
    'overhang_both': (150, 300, 128, 256, 64, 128),
    'path_640x1024_at_0_0': (1080, 1920, 640, 1024, 0, 0),
    'path_704x1152_at_64_512': (1080, 1920, 704, 1152, 64, 512),
    'path_640x1024_at_448_896': (1080, 1920, 640, 1024, 448, 896),
}


@pytest.mark.parametrize('case', sorted(REGION_OVER_CASES))
def test_region_over_matches_jax(case, jax_mode):
    """region_over on a CPU tensor (its plain version) against
    pallas_ops.region_over at B=2: equal to the jnp fallback, within
    atol 1e-6 of the interpreted kernel; updated in place, and untouched
    outside the region."""
    H, W, h, w, dy0, dx0 = REGION_OVER_CASES[case]
    rng = np.random.default_rng(sorted(REGION_OVER_CASES).index(case) + 41)
    B = 2
    P = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    layer = rng.uniform(0, 1, (B, 4, h, w)).astype(np.float32)
    wantP, wantA = po.region_over(jnp, jax, jnp.asarray(P), jnp.asarray(A),
                                  jnp.asarray(layer), jnp.int32(dy0),
                                  jnp.int32(dx0))
    tP, tA = _t(P, A)
    launches = co.region_over.launches
    gotP, gotA = co.region_over(tP, tA, torch.from_numpy(layer), dy0, dx0)
    assert co.region_over.launches == launches   # the CPU runs no kernel
    assert gotP is tP and gotA is tA              # updated in place
    for got, want in ((gotP, wantP), (gotA, wantA)):
        if jax_mode == 'fallback':
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)
    ys, xs = slice(dy0, dy0 + h), slice(dx0, dx0 + w)
    outside = np.ones((H, W), bool)
    outside[ys, xs] = False
    np.testing.assert_array_equal(gotP.numpy()[:, :, outside],
                                  P[:, :, outside])
    np.testing.assert_array_equal(gotA.numpy()[:, :, outside],
                                  A[:, :, outside])
    assert not np.array_equal(gotA.numpy()[:, :, ys, xs], A[:, :, ys, xs])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['overhang_both', 'inside'])
def test_region_over_counts_no_launch_on_the_cpu(case, dtype):
    """region_over on CPU tensors runs its plain version: no counter of
    either form or either instantiation moves."""
    H, W, h, w, dy0, dx0 = REGION_OVER_CASES[case]
    rng = np.random.default_rng(43)
    P, A, layer = [torch.from_numpy(rng.uniform(0, 1, s).astype(
        np.float32)).to(dtype) for s in ((1, 3, H, W), (1, 1, H, W),
                                         (1, 4, h, w))]
    names = ('launches', 'launches_bf16', 'launches_vector',
             'launches_scalar')
    before = [getattr(co.region_over, n) for n in names]
    want = co.region_over_plain(P.clone(), A.clone(), layer, dy0, dx0)
    got = co.region_over(P, A, layer, dy0, dx0)
    assert [getattr(co.region_over, n) for n in names] == before
    assert got[0] is P and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize('h, w, dy0, dx0', [
    (60, 128, 0, 0),          # region not whole blocks
    (64, 100, 0, 0),
    (64, 128, 32, 0),         # offset off the block grid
    (64, 128, 0, 64),
    (64, 128, 256, 0),        # region past the (64, 128) envelope
])
def test_region_over_rejects_unaligned(h, w, dy0, dx0):
    P = torch.zeros((1, 3, 128, 256))
    A = torch.zeros((1, 1, 128, 256))
    with pytest.raises(ValueError):
        co.region_over(P, A, torch.zeros((1, 4, h, w)), dy0, dx0)


def test_region_over_refuses_other_devices():
    """A meta tensor is refused, not computed with the plain version."""
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='unsupported device'):
        co.region_over(torch.zeros((1, 3, 64, 128), device=meta),
                       torch.zeros((1, 1, 64, 128), device=meta),
                       torch.zeros((1, 4, 64, 128), device=meta), 0, 0)


@pytest.mark.parametrize('h, w, dy0, dx0', [
    (60, 128, 0, 0),          # region not whole blocks
    (64, 100, 0, 0),
    (64, 128, 32, 0),         # offset off the block grid
    (64, 128, 0, 64),
    (64, 128, 256, 0),        # region past the (64, 128) envelope
])
def test_region_over_sep_rejects_unaligned(h, w, dy0, dx0):
    P = torch.zeros((1, 3, 128, 256))
    A = torch.zeros((1, 1, 128, 256))
    with pytest.raises(ValueError):
        co.region_over_sep(P, A, torch.zeros((1, 4)), torch.zeros((1, h)),
                           torch.zeros((1, w)), dy0, dx0)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    computed with the plain version."""
    meta = torch.device('meta')
    color = torch.zeros((2, 1, 4), device=meta)
    box = torch.zeros((2, 1, 4), dtype=torch.int32, device=meta)
    gain = torch.zeros((2, 1), device=meta)
    with pytest.raises(ValueError):
        co.solid_fold(None, None, color, box, gain, gain, 64, 128)
    with pytest.raises(ValueError):
        co.region_over_sep(torch.zeros((1, 3, 64, 128), device=meta),
                           torch.zeros((1, 1, 64, 128), device=meta),
                           torch.zeros((1, 4), device=meta),
                           torch.zeros((1, 64), device=meta),
                           torch.zeros((1, 128), device=meta), 0, 0)


def _fake_nvcc(path, rc):
    """An executable standing in for nvcc: writes the -o file and exits
    with *rc*."""
    path.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info" >&2\nexit %d\n'
                    % rc)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_nvcc',
                        lambda: _fake_nvcc(tmp_path / 'nvcc', 2))
    with pytest.raises(RuntimeError, match='exit code 2'):
        _build._build()
    assert not any((tmp_path / 'build').iterdir())


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_nvcc',
                        lambda: _fake_nvcc(tmp_path / 'nvcc', 0))
    first = _build._build()
    assert first.exists() and not _build.build_info['cached']
    assert '-gencode' in _build.NVCC_FLAGS and '--fmad=false' in \
        _build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    again = _build._build()
    assert again == first and _build.build_info['cached']


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    if os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('a CUDA toolkit is installed at its default place')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build._nvcc()


# The choice between the kernels' 16-byte and scalar instantiations is a
# pure function of the row length and the planes' pointers
# (cuda_ops._vector_ok); a CPU tensor's data_ptr() stands in for a card's.

@pytest.mark.parametrize('W, pointers, want', [
    (1920, (0, 4096, 1 << 40), True),
    (1920, (), True),
    (8, (16,), True),
    (1921, (0, 4096), False),        # W % 8 != 0
    (1924, (0,), False),             # W % 4 == 0 is not enough
    (1920, (0, 4100), False),        # a plane 4 bytes off
    (1920, (2, 4096), False),        # a bf16 plane one value off
    (1920, (8,), False),             # 8-byte aligned only
])
def test_vector_choice_is_a_pure_function(W, pointers, want):
    assert co._vector_ok(W, *pointers) is want


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_vector_choice_follows_the_pointer_not_the_shape(dtype):
    """A contiguous view that starts inside its storage has the same
    shape and strides as an aligned tensor; only data_ptr() tells."""
    W = 256
    flat = torch.zeros(3 * 16 * W + 16, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    aligned = flat[:3 * 16 * W].view(1, 3, 16, W)
    shifted = flat[1:3 * 16 * W + 1].view(1, 3, 16, W)
    per16 = 16 // flat.element_size()
    whole = flat[per16:3 * 16 * W + per16].view(1, 3, 16, W)
    assert aligned.is_contiguous() and shifted.is_contiguous()
    assert aligned.stride() == shifted.stride() == whole.stride()
    assert co._vector_ok(W, aligned.data_ptr())
    assert not co._vector_ok(W, shifted.data_ptr())
    assert co._vector_ok(W, whole.data_ptr())       # a 16-byte offset is fine
    assert not co._vector_ok(W, aligned.data_ptr(), shifted.data_ptr())
    assert not co._vector_ok(W - 1, aligned.data_ptr())


def _brute_pixel_layers(box, H, W):
    """(inside, across) pixel-layers by painting every box and looking
    at every 16x128 tile."""
    th, tw = co.FOLD_TILE
    inside = across = 0
    for y0, y1, x0, x1 in np.asarray(box).reshape(-1, 4):
        mask = np.zeros((H, W), bool)
        if y0 <= y1 and x0 <= x1:
            mask[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = True
        for ty in range(0, H, th):
            for tx in range(0, W, tw):
                tile = mask[ty:ty + th, tx:tx + tw]
                if tile.all():
                    inside += tile.size
                elif tile.any():
                    across += tile.size
    return inside, across


@pytest.mark.parametrize('L, B, H, W', [
    (6, 3, 100, 300),      # part tiles on both edges
    (4, 2, 64, 256),       # whole tiles
    (1, 1, 16, 128),       # one tile
    (5, 2, 33, 129),       # one row and one column past a tile
])
def test_fold_tile_pixel_layers_matches_brute_force(L, B, H, W):
    """The host count of what solid_fold's tiles list (the roofline
    study's instruction model) against a brute-force mask count on seeded
    boxes: a full-frame box, an empty one, one outside the frame, tensors
    and arrays alike."""
    rng = np.random.default_rng(L * 1000 + W)
    box = _solid_layers(rng, L, B, H, W)[1]
    box[L - 1, B - 1] = (5, 4, 5, 4)
    box[0, 0] = (0, H - 1, 0, W - 1)
    if L > 2:
        box[1, 0] = (-8, H + 5, -3, W + 200)         # contains the frame
        box[2, 0] = (H + 2, H + 9, 0, W - 1)         # below the frame
    want = _brute_pixel_layers(box, H, W)
    assert co.fold_tile_pixel_layers(box, H, W) == want
    assert co.fold_tile_pixel_layers(torch.from_numpy(box), H, W) == want
    assert want[0] > 0 and sum(want) <= L * B * H * W


def test_fold_tile_pixel_layers_of_no_layers_is_zero():
    assert co.fold_tile_pixel_layers(np.zeros((0, 2, 4), np.int32),
                                     40, 200) == (0, 0)

