"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips where
torch.cuda.is_available() is False.

This file imports neither JAX nor the JAX test configuration's needs,
so it also runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: solid_fold, region_over and the study folds (fold_variant,
tile_fold, roofline_fold), and the bf16 forms of the three render
kernels, are bit-identical to their plain versions (both round after
every operation, in the same order); the FMA chain rounds once per step
on the card and twice in its plain version, so the two are held to
study_ops.fma_chain_tol (constants in (-0.9, 0.9)); region_over_sep is
held to atol=1e-6 (about one f32 ulp on values in [0, 2],
tests/test_pallas_interpret.py's tolerance) and a rendered f16 frame to
atol=1e-3 (one f16 ulp at values up to 1). A display pull may differ from
the CPU's by 1 on at most 0.1% of its u8 values (CUDA's powf). A mixed-content frame (DV clips through
scalers: f32 matmuls summed in cuBLAS's order) is held to the slice's
tolerance, atol=1e-2 with at least 99% of values bit-equal.
"""

import numpy as np
import pytest
import torch

from canvas_tpu_torch.ops import cuda_ops as co
from canvas_tpu_torch.ops import study_ops as so

ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is False)')
    return torch.device('cuda')


def _solid_layers(rng, L, B, H, W):
    color = rng.uniform(0.0, 1.0, size=(L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=(L, B)).astype(np.float32)
    offset = rng.uniform(-0.2, 0.2, size=(L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            y0 = rng.integers(0, H - 1)
            x0 = rng.integers(0, W - 1)
            box[l, b] = (y0, rng.integers(y0, H), x0, rng.integers(x0, W))
    box[0, 0] = (H // 2, H - 1, W // 2, W - 1)      # touches the edges
    box[1, B - 1] = (5, 4, 5, 4)                     # empty
    return color, box, gain, offset


def _on(device, *arrays):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize('L, with_base, finalize, out_dtype', [
    (6, False, False, None),
    (2, True, False, None),
    (2, True, True, torch.float16),
    (3, False, True, None),
])
def test_solid_fold_kernel_matches_plain(cuda, L, with_base, finalize,
                                         out_dtype):
    rng = np.random.default_rng(29 + L)
    B, H, W = 3, 270, 481
    color, box, gain, offset = _on(cuda, *_solid_layers(rng, L, B, H, W))
    P = A = None
    if with_base:
        P, A = _on(cuda, rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
                   rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32))
    launches = co.solid_fold.launches
    got = co.solid_fold(P, A, color, box, gain, offset, H, W,
                        finalize=finalize, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert co.solid_fold.launches == launches + 1
    want = co.solid_fold_plain(P, A, color, box, gain, offset, H, W,
                               finalize=finalize, out_dtype=out_dtype)
    got = [got] if finalize else list(got)
    want = [want] if finalize else list(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize('H, W, h, w, dy0, dx0', [
    (540, 960, 384, 640, 192, 384),      # overhangs bottom and right
    (1080, 1920, 512, 1024, 576, 896),   # overhangs the bottom
])
def test_region_over_sep_kernel_matches_plain(cuda, H, W, h, w, dy0, dx0):
    rng = np.random.default_rng(31)
    B = 3
    P, A, color, ry, rx = _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32) for s in
                ((B, 3, H, W), (B, 1, H, W), (B, 4), (B, h), (B, w))])
    P2, A2 = P.clone(), A.clone()
    launches = co.region_over_sep.launches
    outP, outA = co.region_over_sep(P, A, color, ry, rx, dy0, dx0)
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert co.region_over_sep.launches == launches + 1
    co.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
    assert float((P - P2).abs().max()) <= ATOL
    assert float((A - A2).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize('H, W, h, w, dy0, dx0', [
    (1080, 1920, 640, 1024, 448, 896),   # overhangs the bottom
    (1080, 1920, 704, 1152, 64, 512),    # inside
    (540, 960, 384, 640, 192, 384),      # overhangs bottom and right
    (150, 300, 128, 256, 64, 128),       # overhangs both, W % 4 != 0
])
def test_region_over_kernel_matches_plain(cuda, H, W, h, w, dy0, dx0):
    rng = np.random.default_rng(37)
    B = 3
    P, A, layer = _on(cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                              for s in ((B, 3, H, W), (B, 1, H, W),
                                        (B, 4, h, w))])
    P2, A2 = P.clone(), A.clone()
    launches = co.region_over.launches
    outP, outA = co.region_over(P, A, layer, dy0, dx0)
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert co.region_over.launches == launches + 1
    co.region_over_plain(P2, A2, layer, dy0, dx0)
    assert torch.equal(P, P2) and torch.equal(A, A2)


@pytest.mark.gpu
@pytest.mark.parametrize('pipelined', [False, True])
def test_stager_pins_and_copies(cuda, monkeypatch, pipelined):
    from canvas_tpu_torch import staging
    if pipelined:
        monkeypatch.setattr(staging, 'SLAB_BYTES', 1)
    rng = np.random.default_rng(43)
    stager = staging.SlabStager([((480, 720), np.uint8)], 21, cuda)
    assert stager._host_t[0].is_pinned()
    assert stager.pipelined == pipelined
    rows = rng.integers(0, 256, (21, 480, 720)).astype(np.uint8)
    for n in range(21):
        stager.host[0][n] = rows[n]
        stager.note_row(n)
    (stack,) = stager.finish()
    assert stack.device.type == 'cuda' and stack.shape == (24, 480, 720)
    got = stack.cpu().numpy()
    np.testing.assert_array_equal(got[:21], rows)
    np.testing.assert_array_equal(got[21:], rows[[20, 20, 20]])


@pytest.mark.gpu
def test_mixed_render_on_card_matches_cpu(cuda):
    """Frames of the mixed-content timeline at 960x540 (DV clips staged
    by the port, static and animated scalers, region_over) on the card
    against the plain versions on the CPU."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    ws = timelines.mixed_timeline(256)
    window = box2i(0, 0, 959, 539)
    launches = co.region_over.launches
    got = RenderPlanner(ws, window).render(0, 5)
    assert co.region_over.launches > launches
    want = RenderPlanner(ws, window, device='cpu').render(0, 5)
    assert got.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.99


@pytest.mark.gpu
def test_kernel_wrappers_refuse_noncontiguous(cuda):
    P = torch.zeros((1, 3, 128, 256), device=cuda)
    A = torch.zeros((1, 1, 256, 128), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        co.region_over_sep(P, A, torch.zeros((1, 4), device=cuda),
                           torch.zeros((1, 64), device=cuda),
                           torch.zeros((1, 128), device=cuda), 0, 0)
    with pytest.raises(ValueError):
        co.region_over(P, A, torch.zeros((1, 4, 64, 128), device=cuda),
                       0, 0)
    layer = torch.zeros((1, 4, 128, 64), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        co.region_over(P, A.contiguous(), layer, 0, 0)


@pytest.mark.gpu
def test_render_on_card_matches_cpu(cuda):
    """The headline timeline at 960x540 through the kernels on the card
    against the plain versions on the CPU."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    ws = timelines.build_timeline(1024)
    window = box2i(0, 0, 959, 539)
    for start, stop in ((0, 1), (128, 136), (1000, 1003)):
        got = RenderPlanner(ws, window).render(start, stop)
        want = RenderPlanner(ws, window, device='cpu').render(start, stop)
        assert got.dtype == np.float16 and got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=0,
                                   atol=1e-3)


# The quality <= 9 forms: bf16 accumulators (and region_over's bf16
# layer), f32 math, bit-identical to their plain versions.

@pytest.mark.gpu
@pytest.mark.parametrize('with_base, finalize, out_dtype', [
    (False, False, None),                # mid fold, stores bf16
    (True, False, None),                 # bf16 base, stores bf16
    (True, True, torch.float16),         # finalize from a bf16 base
    (True, True, torch.float32),
])
def test_solid_fold_bf16_kernel_matches_plain(cuda, with_base, finalize,
                                              out_dtype):
    rng = np.random.default_rng(71)
    B, H, W = 3, 270, 481
    color, box, gain, offset = _on(cuda, *_solid_layers(rng, 4, B, H, W))
    P = A = None
    if with_base:
        P, A = [t.to(torch.bfloat16) for t in _on(
            cuda, rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
            rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32))]
    kw = (dict(finalize=True, out_dtype=out_dtype) if finalize
          else dict(acc_dtype=torch.bfloat16))
    launches = (co.solid_fold.launches, co.solid_fold.launches_bf16)
    got = co.solid_fold(P, A, color, box, gain, offset, H, W, **kw)
    torch.cuda.synchronize()
    assert (co.solid_fold.launches, co.solid_fold.launches_bf16) == \
        (launches[0], launches[1] + 1)
    want = co.solid_fold_plain(P, A, color, box, gain, offset, H, W, **kw)
    got = [got] if finalize else list(got)
    want = [want] if finalize else list(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.dtype == (out_dtype if finalize else torch.bfloat16)
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['region_over', 'region_over_sep'])
@pytest.mark.parametrize('H, W, h, w, dy0, dx0', [
    (1080, 1920, 512, 1024, 576, 896),   # overhangs the bottom
    (540, 960, 384, 640, 192, 384),      # overhangs bottom and right
])
def test_region_bf16_kernels_match_plain(cuda, kind, H, W, h, w, dy0, dx0):
    rng = np.random.default_rng(73)
    B = 3
    P, A = [t.to(torch.bfloat16) for t in _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                for s in ((B, 3, H, W), (B, 1, H, W))])]
    if kind == 'region_over':
        args = [t.to(torch.bfloat16) for t in _on(
            cuda, rng.uniform(0, 1, (B, 4, h, w)).astype(np.float32))]
    else:
        args = _on(cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                           for s in ((B, 4), (B, h), (B, w))])
    P2, A2 = P.clone(), A.clone()
    fn = getattr(co, kind)
    launches = (fn.launches, fn.launches_bf16)
    outP, outA = fn(P, A, *args, dy0, dx0)
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert (fn.launches, fn.launches_bf16) == (launches[0], launches[1] + 1)
    getattr(co, kind + '_plain')(P2, A2, *args, dy0, dx0)
    assert P.dtype == torch.bfloat16
    assert torch.equal(P, P2) and torch.equal(A, A2)


@pytest.mark.gpu
def test_bf16_wrappers_refuse_mixed_dtypes(cuda):
    P = torch.zeros((1, 3, 128, 256), device=cuda, dtype=torch.bfloat16)
    A = torch.zeros((1, 1, 128, 256), device=cuda)
    with pytest.raises(ValueError):
        co.region_over(P, A, torch.zeros((1, 4, 64, 128), device=cuda,
                                         dtype=torch.bfloat16), 0, 0)
    with pytest.raises(ValueError):
        co.region_over(P, A.to(torch.bfloat16),
                       torch.zeros((1, 4, 64, 128), device=cuda), 0, 0)
    with pytest.raises(ValueError):
        co.region_over_sep(P.half(), A.half(),
                           torch.zeros((1, 4), device=cuda),
                           torch.zeros((1, 64), device=cuda),
                           torch.zeros((1, 128), device=cuda), 0, 0)


@pytest.mark.gpu
def test_quality_9_render_on_card_matches_cpu(cuda):
    """The headline at quality 9 (bf16 mid fold, bf16 regions, finalize
    from bf16) on the card against the plain versions on the CPU. The
    kernels are bit-identical to their plain versions, but the scalers'
    taps (torch sums) may differ in an f32 ulp, which a bf16 store can
    turn into one bf16 ulp: within the quality-9 contract's 1e-2, and
    at least 99.9% of values bit-equal."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    ws = timelines.build_timeline(1024)
    window = box2i(0, 0, 959, 539)
    launches = co.solid_fold.launches_bf16, co.region_over_sep.launches_bf16
    got = RenderPlanner(ws, window, quality=9).render(128, 136)
    assert co.solid_fold.launches_bf16 > launches[0]
    assert co.region_over_sep.launches_bf16 > launches[1]
    want = RenderPlanner(ws, window, quality=9, device='cpu').render(128, 136)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.999


@pytest.mark.gpu
def test_render_display_on_card_matches_cpu(cuda):
    """render_display on the card against the CPU: u8 within 1 on at
    most 0.1% of values (CUDA's powf against the CPU's, in the last
    ulp)."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    ws = timelines.build_timeline(1024)
    window = box2i(0, 0, 959, 539)
    card = RenderPlanner(ws, window)
    cpu = RenderPlanner(ws, window, device='cpu')
    for kw in ({}, {'intent': 1.25, 'transport': 'rgb24'},
               {'display_size': (320, 180), 'transport': 'yuv420'}):
        got = card.render_display(130, **kw).astype(np.int32)
        want = cpu.render_display(130, **kw).astype(np.int32)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-3, kw


# Study kernels. Frame sizes that are not whole 16x128 tiles (1080 rows:
# not a multiple of 16; 960 columns: not a multiple of 128; 1088 x 1000:
# whole rows of tiles, part columns); _solid_layers puts a box on the
# bottom-right edge and an empty box in each case.
STUDY_SIZES = [(1080, 960), (1088, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize('variant', so.VARIANTS)
@pytest.mark.parametrize('H, W', STUDY_SIZES)
def test_fold_variant_kernel_matches_plain(cuda, variant, H, W):
    rng = np.random.default_rng(47)
    args = _on(cuda, *_solid_layers(rng, 6, 2, H, W))
    launches = so.fold_variant.launches
    got = so.fold_variant(variant, *args, H, W)
    torch.cuda.synchronize()
    assert so.fold_variant.launches == launches + 1
    want = so.fold_variant_plain(variant, *args, H, W)
    assert got.shape == (2, 4, H, W) and torch.equal(got, want)
    assert torch.equal(got, co.solid_fold_plain(None, None, *args, H, W,
                                                finalize=True))


@pytest.mark.gpu
@pytest.mark.parametrize('with_base, finalize', [
    (False, False), (True, False), (True, True), (False, True)])
@pytest.mark.parametrize('H, W', STUDY_SIZES)
def test_tile_fold_kernel_matches_plain(cuda, with_base, finalize, H, W):
    rng = np.random.default_rng(53)
    B = 2
    args = _on(cuda, *_solid_layers(rng, 5, B, H, W))
    P = A = None
    if with_base:
        P, A = _on(cuda, rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
                   rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32))
    launches = so.tile_fold.launches
    got = so.tile_fold(P, A, *args, H, W, finalize=finalize)
    torch.cuda.synchronize()
    assert so.tile_fold.launches == launches + 1
    for want in (so.tile_fold_plain(P, A, *args, H, W, finalize=finalize),
                 co.solid_fold_plain(P, A, *args, H, W, finalize=finalize)):
        got_l = [got] if finalize else list(got)
        want_l = [want] if finalize else list(want)
        for g, w in zip(got_l, want_l):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize('mult', [False, True])
@pytest.mark.parametrize('H, W', STUDY_SIZES)
def test_roofline_fold_kernel_matches_plain(cuda, mult, H, W):
    rng = np.random.default_rng(59)
    x = rng.standard_normal((2, 4, H, W)).astype(np.float32)
    col = (rng.uniform(0, 1, (6, 4)) * 0.1 + 0.4).astype(np.float32)
    box = _solid_layers(rng, 6, 1, H, W)[1][:, 0]
    x, col, box = _on(cuda, x, col, box)
    launches = so.roofline_fold.launches
    got = so.roofline_fold(x, col, box, mult)
    torch.cuda.synchronize()
    assert so.roofline_fold.launches == launches + 1
    assert torch.equal(got, so.roofline_fold_plain(x, col, box, mult))
    assert torch.equal(got, so.roofline_fold_plain(x, col, box, not mult))


@pytest.mark.gpu
@pytest.mark.parametrize('k', [0, 1, 7, 40, 1024])
@pytest.mark.parametrize('shape', [(2, 4, 1088, 1920), (3, 1, 1079, 963)])
def test_fma_chain_kernel_matches_plain(cuda, k, shape):
    rng = np.random.default_rng(61)
    x, c = _on(cuda, rng.standard_normal(shape).astype(np.float32),
               rng.uniform(-0.9, 0.9, 1024).astype(np.float32))
    launches = so.fma_chain.launches
    got = so.fma_chain(x, c, k)
    torch.cuda.synchronize()
    assert so.fma_chain.launches == launches + 1
    if k <= 40:
        want = so.fma_chain_plain(x, c, k)
        assert float((got - want).abs().max()) <= so.fma_chain_tol(x, c, k)
    exact = x.double()
    for i in range(k):
        exact = exact * c[i].double() + x.double()
    assert float((got.double() - exact).abs().max()) <= \
        so.fma_chain_tol(x, c, k) / 2


@pytest.mark.gpu
def test_study_wrappers_refuse_noncontiguous(cuda):
    H, W = 64, 128
    color, box, gain, offset = _on(cuda, *_solid_layers(
        np.random.default_rng(67), 2, 2, H, W))
    color_t = color.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        so.fold_variant('current', color_t, box, gain, offset, H, W)
    with pytest.raises(ValueError):
        so.tile_fold(None, None, color_t, box, gain, offset, H, W)
    P = torch.zeros((2, 3, W, H), device=cuda).transpose(2, 3)
    A = torch.zeros((2, 1, H, W), device=cuda)
    with pytest.raises(ValueError):
        so.tile_fold(P, A, color, box, gain, offset, H, W)
    x = torch.zeros((2, 4, W, H), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        so.roofline_fold(x, color[:, 0], box[:, 0], False)
    with pytest.raises(ValueError):
        so.fma_chain(x, torch.zeros(8, device=cuda), 8)
