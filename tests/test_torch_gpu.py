"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips where
torch.cuda.is_available() is False.

This file imports neither JAX nor the JAX test configuration's needs,
so it also runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: solid_fold, region_over_sep, region_over and the study
folds (fold_variant, tile_fold, roofline_fold), in every form (f32 and
bf16 accumulators) and, for solid_fold, region_over_sep and region_over,
through both the 16-byte and the scalar instantiation, are
bit-identical to their
plain versions (both round after every operation, in the same order);
the FMA chain rounds once per step on the card and twice in its plain
version, so the two are held to study_ops.fma_chain_tol (constants in
(-0.9, 0.9)); a rendered f16 frame is held to atol=1e-3 (one f16 ulp at
values up to 1). A display pull may differ from the CPU's by 1 on at
most 0.1% of its u8 values (the viewport resample's f32 sums run in
another order on the card; the level table is the same on both). A
mixed-content frame (DV clips through
scalers: f32 matmuls summed in cuBLAS's order) is held to the slice's
tolerance, atol=1e-2 with at least 99% of values bit-equal, and so are
the pulldown and planar clips; a replay from the plan cache is
bit-equal to the first pass on the same card, and a headline batch
rendered over a logical mesh of the one card (two shards) to the
unsharded batch. A default-mode eager
pull at 1080p (the torch arms on the card) is held to the same gates
against the NumPy arm's pull. The fused yuv420 post
(``cuda_ops.yuv420_post``) is bit-equal to its plain ops run on the
card (``color.yuv420_pack_studio_plain``): every byte of a seeded
128-frame 1080p batch, of odd and unaligned sizes and of every f16 bit
pattern in R, G and B, and the unrounded Y, Cb and Cr of all 256**3
level triples. A render program's replay (the headline,
config7, the posts, the display program, the fuzz's graphs) is
bit-equal to the eager run, also while another thread stages and runs
batches during the captures.
"""

import time

import numpy as np
import pytest
import torch

from canvas_tpu_torch.ops import cuda_ops as co
from canvas_tpu_torch.ops import study_ops as so


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


def _offsets(device, dy0, dx0):
    """A region kernel's offsets: int32 values in device memory."""
    return [torch.tensor([v], dtype=torch.int32, device=device)
            for v in (dy0, dx0)]


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
    outP, outA = co.region_over_sep(P, A, color, ry, rx,
                                    *_offsets(cuda, dy0, dx0))
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert co.region_over_sep.launches == launches + 1
    co.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
    assert torch.equal(P, P2) and torch.equal(A, A2)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('H, W, h, w, dy0, dx0', [
    (1080, 1920, 640, 1024, 448, 896),   # overhangs the bottom
    (1080, 1920, 704, 1152, 64, 512),    # inside
    (540, 960, 384, 640, 192, 384),      # overhangs bottom and right
    (150, 300, 128, 256, 64, 128),       # overhangs both, W % 4 != 0
])
def test_region_over_kernel_matches_plain(cuda, H, W, h, w, dy0, dx0,
                                          dtype):
    rng = np.random.default_rng(37)
    B = 3
    P, A, layer = [t.to(dtype) for t in _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                for s in ((B, 3, H, W), (B, 1, H, W), (B, 4, h, w))])]
    P2, A2 = P.clone(), A.clone()
    name = 'launches_bf16' if dtype == torch.bfloat16 else 'launches'
    launches = getattr(co.region_over, name)
    outP, outA = co.region_over(P, A, layer, *_offsets(cuda, dy0, dx0))
    torch.cuda.synchronize()
    assert outP is P and outA is A and P.dtype == dtype
    assert getattr(co.region_over, name) == launches + 1
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
                           torch.zeros((1, 128), device=cuda),
                           *_offsets(cuda, 0, 0))
    with pytest.raises(ValueError):
        co.region_over(P, A, torch.zeros((1, 4, 64, 128), device=cuda),
                       *_offsets(cuda, 0, 0))
    layer = torch.zeros((1, 4, 128, 64), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        co.region_over(P, A.contiguous(), layer, *_offsets(cuda, 0, 0))


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


# The 16-byte and the scalar instantiation of solid_fold,
# region_over_sep and region_over, every form, bit-identical to the
# unchanged plain versions: W % 8 != 0 or a plane that does not start at
# a multiple of 16 bytes takes the scalar one, everything else the vector
# one.

_BF = torch.bfloat16
FOLD_FORMS = [(base, kw) for base in (None, torch.float32, _BF)
              for kw in ({}, {'acc_dtype': _BF}, {'finalize': True},
                         {'finalize': True, 'out_dtype': torch.float16})]


def _offset_view(t, elements):
    """A contiguous copy of *t* that starts *elements* into its storage."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    return view


def _fold_counts():
    return (co.solid_fold.launches_vector, co.solid_fold.launches_scalar)


@pytest.mark.gpu
@pytest.mark.parametrize('base, kw', FOLD_FORMS)
@pytest.mark.parametrize('L, B, H, W, vector', [
    (5, 3, 270, 481, False),     # odd size: scalar
    (5, 2, 270, 488, True),      # part tiles on both edges: vector
    (0, 2, 37, 264, True),       # no layers
    (1, 1, 130, 1928, True),     # one frame, one layer
    (7, 1, 16, 128, True),       # one whole tile
])
def test_solid_fold_forms_match_plain(cuda, base, kw, L, B, H, W, vector):
    rng = np.random.default_rng(101 + L + W)
    if L:
        color, box, gain, offset = _on(cuda, *_solid_layers(
            rng, max(L, 2), B, H, W))
        color, box, gain, offset = (t[:L].contiguous() for t in
                                    (color, box, gain, offset))
    else:
        color, box, gain, offset = _on(
            cuda, np.zeros((0, B, 4), np.float32),
            np.zeros((0, B, 4), np.int32), np.zeros((0, B), np.float32),
            np.zeros((0, B), np.float32))
    P = A = None
    if base is not None:
        A = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
        P = (rng.uniform(0, 1, (B, 3, H, W)) * A).astype(np.float32)
        P, A = [t.to(base) for t in _on(cuda, P, A)]
    before = _fold_counts()
    got = co.solid_fold(P, A, color, box, gain, offset, H, W, **kw)
    torch.cuda.synchronize()
    assert _fold_counts() == (before[0] + vector, before[1] + (not vector))
    want = co.solid_fold_plain(P, A, color, box, gain, offset, H, W, **kw)
    if kw.get('finalize'):
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize('base', [torch.float32, _BF])
def test_solid_fold_unaligned_base_takes_the_scalar_form(cuda, base):
    rng = np.random.default_rng(103)
    L, B, H, W = 3, 2, 48, 256
    layers = _on(cuda, *_solid_layers(rng, L, B, H, W))
    P, A = [_offset_view(t.to(base), 1) for t in _on(
        cuda, rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32),
        rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32))]
    assert P.is_contiguous() and P.data_ptr() % 16
    before = _fold_counts()
    got = co.solid_fold(P, A, *layers, H, W, finalize=True,
                        out_dtype=torch.float16)
    torch.cuda.synchronize()
    assert _fold_counts() == (before[0], before[1] + 1)
    assert torch.equal(got, co.solid_fold_plain(
        P, A, *layers, H, W, finalize=True, out_dtype=torch.float16))


def _region_over_counts():
    return (co.region_over.launches_vector, co.region_over.launches_scalar)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, _BF])
@pytest.mark.parametrize('H, W, shifted, vector', [
    (150, 304, None, True),      # overhangs both edges, W % 8 == 0
    (150, 300, None, False),     # W % 8 != 0
    (192, 384, 'layer', False),  # a plane one value into its storage
    (192, 384, 'P', False),
    (192, 384, 'A', False),
])
def test_region_over_takes_both_instantiations(cuda, dtype, H, W, shifted,
                                               vector):
    """A 128x256 region at (64, 128): the 16-byte form where W % 8 == 0
    and the layer, P and A start at multiples of 16 bytes, else the
    scalar form; both bit-identical to the plain version."""
    rng = np.random.default_rng(109 + W)
    B, h, w = 2, 128, 256
    t = dict(zip(('P', 'A', 'layer'), [x.to(dtype) for x in _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                for s in ((B, 3, H, W), (B, 1, H, W), (B, 4, h, w))])]))
    if shifted:
        t[shifted] = _offset_view(t[shifted], 1)
        assert t[shifted].is_contiguous() and t[shifted].data_ptr() % 16
    P, A, layer = t['P'], t['A'], t['layer']
    P2, A2 = P.clone(), A.clone()
    before = _region_over_counts()
    outP, outA = co.region_over(P, A, layer, *_offsets(cuda, 64, 128))
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert _region_over_counts() == (before[0] + vector,
                                     before[1] + (not vector))
    co.region_over_plain(P2, A2, layer, 64, 128)
    assert torch.equal(P, P2) and torch.equal(A, A2)


@pytest.mark.gpu
@pytest.mark.parametrize('acc_dtype', [torch.float32, _BF])
def test_solid_fold_1024_layers(cuda, acc_dtype):
    """L = 1024, the most the kernel's shared memory takes; L = 1025
    raises."""
    rng = np.random.default_rng(107)
    B, H, W = 1, 40, 264
    layers = _on(cuda, *_solid_layers(rng, 1024, B, H, W))
    layers[0][:, :, 3] *= 0.05           # thin layers: the fold stays mixed
    got = co.solid_fold(None, None, *layers, H, W, acc_dtype=acc_dtype)
    torch.cuda.synchronize()
    want = co.solid_fold_plain(None, None, *layers, H, W,
                               acc_dtype=acc_dtype)
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) == 0.0
    more = [torch.cat([t, t[:1]]) for t in layers]
    with pytest.raises(ValueError):
        co.solid_fold(None, None, *more, H, W)


@pytest.mark.gpu
@pytest.mark.parametrize('vector', [True, False])
def test_narrow_stores_round_denormals_as_torch(cuda, vector):
    """Values around the smallest bf16 and f16 steps (f32 denormals
    among them) store the same bits from the paired converts of the
    vector form, the scalar form and torch's casts."""
    rng = np.random.default_rng(109)
    B, H, W = 2, 32, 256 if vector else 250
    scale = np.float32(2.0) ** rng.integers(-149, -120, (B, 3, H, W))
    A = np.ones((B, 1, H, W), np.float32)
    P = (rng.uniform(0.5, 1.0, (B, 3, H, W)) * scale).astype(np.float32)
    P[0, 0, 0, :8] = (0.0, -0.0, 1e-45, -1e-45, 2.0 ** -133, 2.0 ** -134,
                      3 * 2.0 ** -135, 65520.0)
    P, A = _on(cuda, P, A)
    none = _on(cuda, np.zeros((0, B, 4), np.float32),
               np.zeros((0, B, 4), np.int32), np.zeros((0, B), np.float32),
               np.zeros((0, B), np.float32))
    before = _fold_counts()
    for kw in ({'acc_dtype': _BF},
               {'finalize': True, 'out_dtype': torch.float16}):
        got = co.solid_fold(P, A, *none, H, W, **kw)
        want = co.solid_fold_plain(P, A, *none, H, W, **kw)
        if kw.get('finalize'):
            got, want = [got], [want]
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _fold_counts() == (before[0] + 2 * vector,
                              before[1] + 2 * (not vector))
    Pb, Ab = P.to(_BF), A.to(_BF) * 0.5
    color, ry, rx = _on(cuda, np.full((B, 4), 0.75, np.float32),
                        (rng.uniform(0.5, 1, (B, 64)) * 2.0 ** -70).astype(
                            np.float32),
                        (rng.uniform(0.5, 1, (B, 256)) * 2.0 ** -70).astype(
                            np.float32))
    P2, A2 = Pb.clone(), Ab.clone()
    co.region_over_sep(Pb, Ab, color, ry, rx, *_offsets(cuda, 0, 0))
    co.region_over_sep_plain(P2, A2, color, ry, rx, 0, 0)
    assert torch.equal(Pb.view(torch.int16), P2.view(torch.int16))
    assert torch.equal(Ab.view(torch.int16), A2.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, _BF])
@pytest.mark.parametrize('B, H, W, h, w, dy0, dx0, vector', [
    (3, 540, 960, 384, 640, 192, 384, True),     # overhangs both edges
    (1, 1080, 1920, 512, 1024, 576, 896, True),  # overhangs the bottom
    (2, 150, 300, 128, 256, 64, 128, False),     # W % 8 != 0, overhangs both
    (2, 67, 129, 64, 128, 64, 128, False),       # 3 rows and 1 column left
    (2, 64, 128, 64, 128, 0, 0, True),           # the whole frame
])
def test_region_over_sep_forms_match_plain(cuda, dtype, B, H, W, h, w, dy0,
                                           dx0, vector):
    rng = np.random.default_rng(113 + W)
    P, A = [t.to(dtype) for t in _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                for s in ((B, 3, H, W), (B, 1, H, W))])]
    color, ry, rx = _on(cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                                for s in ((B, 4), (B, h), (B, w))])
    P2, A2 = P.clone(), A.clone()
    fn = co.region_over_sep
    before = (fn.launches_vector, fn.launches_scalar)
    outP, outA = fn(P, A, color, ry, rx, *_offsets(cuda, dy0, dx0))
    torch.cuda.synchronize()
    assert outP is P and outA is A
    assert (fn.launches_vector, fn.launches_scalar) == \
        (before[0] + vector, before[1] + (not vector))
    co.region_over_sep_plain(P2, A2, color, ry, rx, dy0, dx0)
    assert torch.equal(P, P2) and torch.equal(A, A2)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, _BF])
@pytest.mark.parametrize('which', ['P', 'A', 'rx'])
def test_region_over_sep_unaligned_takes_the_scalar_form(cuda, dtype, which):
    rng = np.random.default_rng(127)
    B, H, W, h, w = 2, 100, 256, 64, 128
    t = dict(zip(('P', 'A', 'color', 'ry', 'rx'), _on(
        cuda, *[rng.uniform(0, 1, s).astype(np.float32)
                for s in ((B, 3, H, W), (B, 1, H, W), (B, 4), (B, h),
                          (B, w))])))
    t['P'], t['A'] = t['P'].to(dtype), t['A'].to(dtype)
    t[which] = _offset_view(t[which], 1)
    assert t[which].is_contiguous() and t[which].data_ptr() % 16
    P2, A2 = t['P'].clone(), t['A'].clone()
    fn = co.region_over_sep
    before = (fn.launches_vector, fn.launches_scalar)
    fn(t['P'], t['A'], t['color'], t['ry'], t['rx'],
       *_offsets(cuda, 64, 128))
    torch.cuda.synchronize()
    assert (fn.launches_vector, fn.launches_scalar) == (before[0],
                                                        before[1] + 1)
    co.region_over_sep_plain(P2, A2, t['color'], t['ry'], t['rx'], 64, 128)
    assert torch.equal(t['P'], P2) and torch.equal(t['A'], A2)


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
    outP, outA = fn(P, A, *args, *_offsets(cuda, dy0, dx0))
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
                                         dtype=torch.bfloat16),
                       *_offsets(cuda, 0, 0))
    with pytest.raises(ValueError):
        co.region_over(P, A.to(torch.bfloat16),
                       torch.zeros((1, 4, 64, 128), device=cuda),
                       *_offsets(cuda, 0, 0))
    with pytest.raises(ValueError):
        co.region_over_sep(P.half(), A.half(),
                           torch.zeros((1, 4), device=cuda),
                           torch.zeros((1, 64), device=cuda),
                           torch.zeros((1, 128), device=cuda),
                           *_offsets(cuda, 0, 0))


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
    most 0.1% of values (the viewport resample sums in another order;
    both gather their levels from the same table)."""
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


def _f16_frames_close(got, want):
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize('clip', ['pulldown', 'planar'])
def test_coded_clips_on_card_match_cpu(cuda, clip):
    """``field_interleave`` and ``planar_recon_rows`` on the card against
    the CPU (the contractions sum in cuBLAS's order: the slice's
    tolerance, atol 1e-2 with at least 99% of values bit-equal)."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    if clip == 'pulldown':
        src, window = timelines.pulldown_clip(), timelines.PULLDOWN_WINDOW
    else:
        src, window = timelines.planar_clip(8), box2i(1500, 900, 1950, 1100)
    got = RenderPlanner(src, window).render(0, 6)
    want = RenderPlanner(src, window, device='cpu').render(0, 6)
    assert np.isfinite(got).all() and got[:, 3].max() == 1.0
    _f16_frames_close(got, want)


@pytest.mark.gpu
def test_replay_on_card_is_bit_equal_and_copies_nothing(cuda):
    """A second pass over a cached range uploads nothing and gives the
    first pass's bits; pacing leaves them too."""
    from canvas_tpu_torch import backend, timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    ws = timelines.mixed_timeline(64)
    planner = RenderPlanner(ws, box2i(0, 0, 959, 539))
    first = [o.clone() for _s, _n, o in planner.iter_batches(0, 24, batch=8)]
    assert len(planner._plan_cache) == 2
    for prepared, _pinned in planner._plan_cache.values():
        assert all(prepared.uploaded)
        assert all(v.is_cuda for pl in prepared.plists for p in pl
                   for v in p.values() if isinstance(v, torch.Tensor))
    copies = backend.transfer_stats['h2d_calls']
    for kw in ({}, {'max_inflight': 1}, {'max_inflight': 2}):
        again = [o.clone() for _s, _n, o in
                 planner.iter_batches(0, 24, batch=8, **kw)]
        assert backend.transfer_stats['h2d_calls'] == copies
        assert len(again) == len(first)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    cpu = RenderPlanner(ws, box2i(0, 0, 959, 539), device='cpu')
    want = np.concatenate([o.numpy() for _s, _n, o in
                           cpu.iter_batches(0, 24, batch=8)])
    _f16_frames_close(torch.cat(first).cpu().numpy(), want)
    planner.close()
    assert not planner._plan_cache


@pytest.mark.gpu
def test_params_to_torch_on_card(cuda):
    from canvas_tpu_torch.render import _canonical, params_to_torch
    rng = np.random.default_rng(5)
    plist = [{'color': rng.uniform(0, 1, (5, 4)).astype(np.float32),
              'box': rng.integers(0, 9, (5, 4)).astype(np.int32),
              'f64': rng.uniform(0, 1, 3), 'scalar': np.float32(2.5)},
             {'dy0': 3, 'dx0': np.int64(7)}]
    got = params_to_torch(plist, cuda)
    assert got[0]['color'].untyped_storage().nbytes() % 16 == 0
    for p, q in zip(got, plist):
        for k, v in q.items():
            # the region offsets too: int32 values on the card
            want = torch.from_numpy(np.array(_canonical(v)))
            assert p[k].is_cuda and p[k].dtype == want.dtype
            assert torch.equal(p[k].cpu(), want)


@pytest.mark.gpu
def test_memory_guard_on_card(cuda, monkeypatch):
    """Without CANVAS_HBM_MB the budget is the card's total memory, and
    a batch over it raises before any launch."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import (RenderPlanner, _hbm_budget_bytes,
                                         box2i)
    monkeypatch.delenv('CANVAS_HBM_MB', raising=False)
    total = torch.cuda.mem_get_info(cuda)[1]
    assert _hbm_budget_bytes(cuda) == total
    window = box2i(0, 0, 1919, 1079)
    planner = RenderPlanner(timelines.build_timeline(64), window)
    batch = total // (40 * 1920 * 1080) + 8
    launches = co.solid_fold.launches
    with pytest.raises(ValueError, match='HBM budget'):
        next(planner.iter_batches(0, batch, batch=batch))
    assert co.solid_fold.launches == launches


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


@pytest.mark.gpu
def test_4k_yuv420_batch_on_card_matches_cpu(cuda):
    """Frames 0 and 1 of config6b: the headline at 3840x2160 with
    post='yuv420', on the card against the same conversion of the CPU's
    f16 frames, to the posts' gate (1 u8 step on at most 0.1% of
    values). At 4K frame 0 is a segment of its own (an item's plan cuts
    at frame 1), so the two frames come as two batches of one."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.ops import color
    from canvas_tpu_torch.render import RenderPlanner
    ws = timelines.build_timeline(1024)
    planner = RenderPlanner(ws, timelines.CONFIG6_WINDOW)
    batches = list(planner.iter_batches(0, 2, batch=2, post='yuv420'))
    assert [(s, n) for s, n, _g in batches] == [(0, 1), (1, 1)]
    got = torch.cat([g for _s, _n, g in batches])
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (2, 3840 * 2160 + 2 * 1920 * 1080)
    frames = RenderPlanner(ws, timelines.CONFIG6_WINDOW, device='cpu').render(
        0, 2)
    want = color.POSTS['yuv420'](torch.from_numpy(frames))
    diff = (got.cpu().int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_editor_headline_on_card_matches_headline(cuda):
    """The editor's headline project (ten Clips in ten lanes of a Space,
    through the editor's graph managers) at 640x360, batch 8, on the
    card: bit-equal to build_timeline's batches on the same card, with
    the headline's launches, one solid_fold mid fold, one finalize and
    two region_over_sep a batch."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i
    window = box2i(0, 0, 639, 359)
    video = timelines.editor_video(timelines.editor_headline(64)[1])
    planners = [RenderPlanner(src, window)
                for src in (video, timelines.build_timeline(64))]
    outs, counts = [], []
    for planner in planners:
        planner.plan_cache_segments = 0
        before = (co.solid_fold.launches, co.region_over_sep.launches,
                  co.region_over.launches)
        outs.append([(s, n, out.clone()) for s, n, out in
                     planner.iter_batches(8, 40, batch=8)])
        torch.cuda.synchronize()
        counts.append(tuple(after - b for after, b in zip(
            (co.solid_fold.launches, co.region_over_sep.launches,
             co.region_over.launches), before)))
    assert [(s, n) for s, n, _o in outs[0]] == [(8, 8), (16, 8), (24, 8),
                                                (32, 8)]
    for (s, n, got), (s2, n2, want) in zip(*outs):
        assert (s, n) == (s2, n2) and got.dtype == torch.float16
        assert torch.equal(got, want), s
    assert counts[0] == counts[1] == (2 * 4, 2 * 4, 0)


def _thumbnails_of(video, window, device):
    """4 thumbnails (160x90) of frames [0, 1024) of *video* through a
    ThumbnailPainter over a VideoPullQueue on *device*."""
    import time

    from canvas_tpu_torch.editor.ui import ThumbnailPainter
    from canvas_tpu_torch.pullqueue import VideoPullQueue
    queue = VideoPullQueue(device=device)
    try:
        painter = ThumbnailPainter(stream=video, window=window,
                                   size=(160, 90), count=4, queue=queue)
        painter.set_range(0, 1024)
        painter.request_all()
        deadline = time.time() + 60
        while any(painter.thumbnail(s) is None for s in range(4)) and \
                time.time() < deadline:
            time.sleep(0.02)
        return [painter.thumbnail(s) for s in range(4)]
    finally:
        queue.close()


@pytest.mark.gpu
def test_pullqueue_on_card_matches_cpu(cuda):
    """4 thumbnails of the editor's headline project at 640x360 through
    the card's pull queue (B=1 planned renders: solid_fold and
    region_over_sep launch), u8-equal to the CPU's."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import box2i
    video = timelines.editor_video(timelines.editor_headline(1024)[1])
    window = box2i(0, 0, 639, 359)
    before = (co.solid_fold.launches, co.region_over_sep.launches)
    got = _thumbnails_of(video, window, None)
    assert co.solid_fold.launches > before[0]
    assert co.region_over_sep.launches > before[1]
    want = _thumbnails_of(video, window, 'cpu')
    for g, w in zip(got, want):
        assert g is not None and g.shape == (90, 160, 4)
        assert np.array_equal(g, w)


@pytest.mark.gpu
def test_qt_widget_on_card_with_fake_binding(cuda):
    """The port's Qt VideoWidget (tests/fake_qt.py binding) on the card
    presents at least one frame of the headline project, u8-equal to
    the same frame presented by a CPU widget (the clock stands at frame
    12, the first frame each engine renders and presents)."""
    import time
    from fractions import Fraction

    import fake_qt
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.editor.ui import qt as qt_mod
    from canvas_tpu_torch.render import box2i
    video = timelines.editor_video(timelines.editor_headline(64)[1])
    old = qt_mod._qt
    fake_qt.install(qt_mod)
    frames = {}
    try:
        for device in (None, 'cpu'):
            clock = SystemPresentationClock()
            clock.seek(int(12 * 1e9 / 25))
            widget = qt_mod.VideoWidget(video, clock, Fraction(25),
                                        box2i(0, 0, 319, 179),
                                        device=device)
            try:
                assert widget.engine.device.type == (device or 'cuda')
                deadline = time.time() + 60
                while widget._image is None and time.time() < deadline:
                    time.sleep(0.02)
                img = widget._image
                assert img is not None
                frames[device] = np.frombuffer(img.data, np.uint8).reshape(
                    img.height(), img.width(), 4).copy()
            finally:
                widget.closeEvent(None)
    finally:
        qt_mod._qt = old
        fake_qt.QPainter.instances.clear()
    assert np.array_equal(frames[None], frames['cpu'])


@pytest.mark.gpu
@pytest.mark.parametrize('name, frame', [('headline', 300), ('config7', 70)])
def test_eager_pull_on_card_matches_numpy_pull(cuda, name, frame):
    """A 1080p ``get_frame_f16`` in the default backend mode runs the
    torch arms on the card: its data is a CUDA tensor within the
    rendered-frame gate of the NumPy arm's pull (headline atol 2e-3;
    config7 atol 1e-2 with at least 99% of values bit-equal)."""
    from canvas_tpu_torch import backend, timelines
    from canvas_tpu_torch.render import box2i
    src = (timelines.build_timeline(1024) if name == 'headline'
           else timelines.mixed_timeline(256))
    window = box2i(0, 0, 1919, 1079)
    assert backend.get_backend() == 'auto'
    got = src.get_frame_f16(frame, window)
    assert isinstance(got.data, torch.Tensor) and got.data.is_cuda
    with backend.force_backend('numpy'):
        want = src.get_frame_f16(frame, window)
    assert isinstance(want.data, np.ndarray)
    assert got.current_window == want.current_window
    g = got.to_numpy()
    atol, share = (2e-3, 0.0) if name == 'headline' else (1e-2, 0.99)
    assert float(np.abs(g.astype(np.float32)
                        - want.data.astype(np.float32)).max()) <= atol
    assert float(np.mean(g.view(np.uint16)
                         == want.data.view(np.uint16))) >= share


@pytest.mark.gpu
def test_time_get_frame_planner_branch_launches_kernels(cuda):
    """``process.time_get_frame`` over headline frames at 1080p in the
    default mode takes its planner branch on the card: ``solid_fold``
    and ``region_over_sep`` launch; ``force_eager=True`` launches
    neither."""
    from canvas_tpu_torch import process, timelines
    from canvas_tpu_torch.render import box2i
    src = timelines.build_timeline(1024)
    window = box2i(0, 0, 1919, 1079)
    before = (co.solid_fold.launches, co.region_over_sep.launches)
    ns = process.time_get_frame(src, 128, 159, window)
    after = (co.solid_fold.launches, co.region_over_sep.launches)
    assert isinstance(ns, int) and ns > 0
    assert after[0] > before[0] and after[1] > before[1]
    ns = process.time_get_frame(src, 128, 129, window, force_eager=True)
    assert isinstance(ns, int) and ns > 0
    assert (co.solid_fold.launches, co.region_over_sep.launches) == after


@pytest.mark.gpu
def test_sharded_headline_on_card_matches_unsharded(cuda):
    """The headline at 640x360 over a logical mesh of two entries of the
    one card (``Mesh([cuda:0] * 2)``: each entry one shard), batch 16:
    every batch a ``ShardedFrames`` of two shards on the card, bit-equal
    to the unsharded batches, with the unsharded path's launches doubled
    (each shard folds and composites its 8 frames); then the frames x
    space reshard of 5 frames through ``render_sharded`` equal to the
    unsharded render."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.mesh import Mesh, ShardedFrames
    from canvas_tpu_torch.render import RenderPlanner, box2i, render_sharded
    window = box2i(0, 0, 639, 359)
    src = timelines.build_timeline(64)
    card = torch.device('cuda', torch.cuda.current_device())
    mesh = Mesh([card] * 2, ('frames',))
    outs, counts = [], []
    for m in (None, mesh):
        planner = RenderPlanner(src, window)
        planner.plan_cache_segments = 0
        before = (co.solid_fold.launches, co.region_over_sep.launches)
        outs.append([(s, n, out) for s, n, out in
                     planner.iter_batches(8, 40, batch=16, mesh=m)])
        torch.cuda.synchronize()
        counts.append(tuple(after - b for after, b in zip(
            (co.solid_fold.launches, co.region_over_sep.launches), before)))
    for (s, n, want), (s2, n2, got) in zip(*outs):
        assert (s, n) == (s2, n2)
        assert isinstance(got, ShardedFrames) and got.devices() == [card] * 2
        assert torch.equal(torch.from_numpy(got.numpy()), want.cpu()), s
    assert counts[1] == tuple(2 * c for c in counts[0]) and counts[0][0] > 0
    grid = Mesh([[card] * 2] * 2, ('frames', 'space'))
    got = render_sharded(src, window, 0, 5, mesh=grid, spatial_axis='space',
                         device_out=True)
    assert len(got.shards) == 4 and all(
        t.device == card for t, _b in got.shards)
    want = RenderPlanner(src, window).render(0, 5)
    assert np.array_equal(got.numpy().view(np.uint16), want.view(np.uint16))


# --- render programs: one CUDA graph per signature ----------------------

def _eager_batches(planner, start, stop, batch, post=None):
    """The eager ``run`` of every batch of [start, stop) on the planner's
    card: [(frame, out)]."""
    from canvas_tpu_torch.render import params_to_torch, run
    out = []
    for seg in planner.segments(start, stop, min_span=batch):
        s0, sig, batches = planner._prepare(seg, batch)
        for pos, take, plist in batches:
            got = run(sig, params_to_torch(plist, planner.device),
                      planner.device, post)
            out.append((s0 + pos, got[:take]))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('name, post', [('headline', None),
                                        ('config7', None),
                                        ('headline', 'rgba_u8'),
                                        ('headline', 'yuv420')])
def test_program_replay_equals_eager_on_card(cuda, name, post):
    """The headline (frames 0..40 at 960x540, batch 8: a 1-frame segment
    with its own program), config7 (frames 0..7, batch 4, DV planes in
    the program's slots) and the headline's two posts through their
    programs over three cold passes (each program's first call eager, the
    second captured, every call of the third pass a replay), bit-equal
    (max diff 0) to the eager run on the card; the launch counters rise
    by the eager run's launches a batch."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.render import RenderPlanner, box2i, program_stats
    if name == 'headline':
        src, start, stop, batch = timelines.build_timeline(64), 0, 41, 8
    else:
        src, start, stop, batch = timelines.mixed_timeline(16), 0, 8, 4
    planner = RenderPlanner(src, box2i(0, 0, 959, 539))
    planner.plan_cache_segments = 0
    names = ('solid_fold', 'region_over_sep', 'region_over')
    since = program_stats()['captures']
    before = [getattr(co, k).launches for k in names]
    passes, calls = [], []
    for _rep in range(3):
        stats = program_stats()
        passes.append([(s, n, out) for s, n, out in planner.iter_batches(
            start, stop, batch=batch, post=post)])
        after = program_stats()
        calls.append((after['calls'] - stats['calls'],
                      after['replays'] - stats['replays']))
    torch.cuda.synchronize()
    got = [getattr(co, k).launches - b for k, b in zip(names, before)]
    stats = program_stats()
    n_batches = len(passes[0])
    assert [c for c, _r in calls] == [n_batches] * 3
    assert calls[2][1] == n_batches, calls
    sigs = {planner._prepared(seg, batch, post, False).sig
            for seg in planner.segments(start, stop, min_span=batch)}
    assert stats['captures'] - since <= len(sigs)
    assert all(p['captured'] for p in stats['programs'] if p['calls'] > 1)
    before = [getattr(co, k).launches for k in names]
    eager = _eager_batches(planner, start, stop, batch, post)
    torch.cuda.synchronize()
    per_pass = [getattr(co, k).launches - b for k, b in zip(names, before)]
    assert got == [3 * e for e in per_pass]
    for prog in passes:
        for (s, n, out), (pos, want) in zip(prog, eager):
            assert (s, n) == (pos, want.shape[0])
            assert out.dtype == want.dtype and torch.equal(out, want), (
                name, post, s)
    planner.close()


@pytest.mark.gpu
@pytest.mark.parametrize('display_size', [None, (480, 270)])
def test_display_program_replay_equals_eager_on_card(cuda, display_size):
    """render_display rgb24 through its display program: four frames of
    one segment (the first pull eager, the second captured, the last two
    replays), each equal to the eager display run of its frame."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.backend import to_host
    from canvas_tpu_torch.ops import color as color_ops
    from canvas_tpu_torch.render import (RenderPlanner, _frame_slice,
                                         _param_sharding, box2i, display_run,
                                         program_stats)
    planner = RenderPlanner(timelines.build_timeline(64),
                            box2i(0, 0, 959, 539))
    replays = []
    for i in range(4, 8):
        before = program_stats()['replays']
        got = planner.render_display(i, transport='rgb24',
                                     display_size=display_size)
        replays.append(program_stats()['replays'] - before)
        seg = planner._display_seg
        pos = i - seg['lo']
        params = [{k: (v if _param_sharding(op, k) is None
                       else _frame_slice(v, _param_sharding(op, k), pos))
                   for k, v in p.items()}
                  for p, op in zip(seg['params'], seg['ops'])]
        flat = to_host(display_run(
            seg['sig1'], params, planner.device,
            planner._display_matrices(display_size), (2, 1, 0, 3), None,
            'rgb24'))
        want = color_ops.rgb24_unpack(flat[0], (2, 1, 0, 3))
        assert np.array_equal(got, want), i
    assert replays[2:] == [1, 1], replays
    planner.close()


@pytest.mark.gpu
def test_program_captures_beside_uploads_and_eager_runs(cuda):
    """Captures made while another thread stages segments (a SlabStager a
    segment: pinned host rows, device stacks, copies on the copy stream
    and a wait for them), packs params into pinned memory and runs batches
    eagerly: every capture succeeds and every frame, eager, captured or
    replayed, equals the eager run. More stagers than torch pools streams
    of a priority (32) are made meanwhile."""
    import threading

    from canvas_tpu_torch import render, staging, timelines
    from canvas_tpu_torch.render import (RenderPlanner, box2i,
                                         params_to_torch, run)
    planner = RenderPlanner(timelines.build_timeline(64),
                            box2i(0, 0, 959, 539))
    seg = planner.segments(0, 8, min_span=8)[0]
    _s0, sig, batches = planner._prepare(seg, 8)
    plist = batches[0][2]
    want = run(sig, params_to_torch(plist, cuda), cuda)
    stop, errors, made = threading.Event(), [], [0]

    def busy():
        try:
            while not stop.is_set():
                stager = staging.SlabStager([((64, 1920), np.float32)], 16,
                                            cuda)
                for r in range(stager.n_real):
                    stager.host[0][r] = r
                    stager.note_row(r)
                stager.finish()
                got = run(sig, params_to_torch(plist, cuda), cuda)
                torch.cuda.current_stream(cuda).synchronize()
                if not torch.equal(got, want):
                    errors.append(AssertionError('eager run differs'))
                made[0] += 1
        except Exception as err:          # reported by the main thread
            errors.append(err)

    worker = threading.Thread(target=busy)
    worker.start()
    captures = 0
    try:
        deadline = time.monotonic() + 120
        while (captures < 40 or made[0] < 64) and not errors:
            assert time.monotonic() < deadline, (captures, made[0])
            prog = render._Program((sig, cuda), cuda,
                                   render._make_run(sig, None, cuda))
            for _call in range(3):     # eager, captured, replayed
                got = prog(plist)
                assert torch.equal(got, want), (captures, _call)
            assert prog.captured and prog.replays == 1
            prog._release()
            captures += 1
    finally:
        stop.set()
        worker.join()
    assert not errors, errors[0]
    planner.close()


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['region_over', 'region_over_sep'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('H, W, h, w, dy0, dx0', [
    (256, 512, 128, 256, 64, 128),        # inside
    (150, 300, 128, 256, 64, 128),        # overhanging both edges
    (1080, 1920, 512, 1024, 576, 896),    # a headline region at 1080p
    (1080, 1920, 704, 1152, 64, 512),     # a config7 DV region
])
def test_region_kernels_read_device_offsets(cuda, kind, dtype, H, W, h, w,
                                            dy0, dx0):
    """Both region kernels with their offsets as int32 values in device
    memory equal their plain versions (max diff 0); a new value written
    into the same tensors moves the next launch's region (the kernel
    reads the offsets at its launch, as a replayed graph needs)."""
    rng = np.random.default_rng(H + W + h + dy0)
    P = torch.from_numpy(rng.uniform(0, 1, (2, 3, H, W)).astype(
        np.float32)).to(cuda, dtype)
    A = torch.from_numpy(rng.uniform(0, 1, (2, 1, H, W)).astype(
        np.float32)).to(cuda, dtype)
    if kind == 'region_over':
        args = (torch.from_numpy(rng.uniform(0, 1, (2, 4, h, w)).astype(
            np.float32)).to(cuda, dtype),)
    else:
        args = tuple(torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)).to(cuda) for s in ((2, 4), (2, h), (2, w)))
    fn, plain = getattr(co, kind), getattr(co, kind + '_plain')
    offsets = _offsets(cuda, dy0, dx0)
    for at in ((dy0, dx0), (0, 0)):
        offsets[0].fill_(at[0])
        offsets[1].fill_(at[1])
        got, want = (P.clone(), A.clone()), (P.clone(), A.clone())
        fn(*got, *args, *offsets)
        plain(*want, *args, *at)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[1], A)


@pytest.mark.gpu
@pytest.mark.parametrize('seed', range(4))
def test_fuzz_program_replay_equals_eager_on_card(cuda, seed):
    """tests/test_torch_render_fuzz.py's random workspaces on the card:
    each segment through its program equals the eager run, bit for bit,
    over three renders of the range (each program's first call eager,
    the second captured, every call of the third render a replay)."""
    from test_torch_render_fuzz import PORT, WINDOW, fuzz_case

    from canvas_tpu_torch.backend import force_backend
    from canvas_tpu_torch.render import (RenderPlanner, box2i, flat_params,
                                         params_to_torch, program_stats, run,
                                         signature)
    ws, start, stop = fuzz_case(PORT, seed)
    planner = RenderPlanner(ws, box2i(*WINDOW))
    with force_backend('numpy'):
        want = []
        for seg in planner.segments(start, stop):
            node = planner._plan(seg)
            want.append(run(signature(node), params_to_torch(
                flat_params(node), planner.device), planner.device))
        want = torch.cat(want)
        for rep in range(3):
            before = program_stats()
            got = planner.render(start, stop, device_out=True)
            after = program_stats()
            assert torch.equal(got, want), (seed, rep)
    calls = after['calls'] - before['calls']
    assert calls and after['replays'] - before['replays'] == calls, seed
    planner.close()


# The yuv420 export post: one launch of csrc/yuv420_post.cu against the
# plain PyTorch ops (color.yuv420_pack_studio_plain) on the same card.

def _yuv420_counts():
    return (co.yuv420_post.launches, co.yuv420_post.launches_vector,
            co.yuv420_post.launches_scalar)


def _yuv420_vs_plain(x16, vector):
    """The kernel's bytes and the plain ops' on *x16*, with one launch of
    the instantiation *vector* counted. Returns (mismatch share, max
    |diff|)."""
    from canvas_tpu_torch.ops import color
    before = _yuv420_counts()
    got = color.yuv420_pack_studio(x16)
    after = _yuv420_counts()
    assert after[0] - before[0] == 1
    assert (after[1] - before[1], after[2] - before[2]) == (
        (1, 0) if vector else (0, 1))
    want = color.yuv420_pack_studio_plain(x16)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    return float((diff != 0).sum()) / diff.numel(), int(diff.max())


@pytest.mark.gpu
def test_yuv420_post_seeded_1080p_batch_is_bit_equal(cuda):
    """A seeded 128-frame 1080p batch, values across the whole level ramp
    and past both ends: every byte equal to the plain ops' (measured
    mismatch share 0)."""
    g = torch.Generator(device=cuda).manual_seed(2020)
    x16 = (torch.rand((128, 4, 1080, 1920), generator=g, device=cuda)
           * 1.3 - 0.1).half()
    assert _yuv420_vs_plain(x16, vector=True) == (0.0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize('B, H, W, shift, vector', [
    (1, 1, 1, 0, False),
    (2, 3, 5, 0, False),
    (1, 1081, 1919, 0, False),
    (2, 66, 100, 0, False),        # W % 8 == 4
    (3, 1080, 1920, 1, False),     # frames 2 bytes off a 16-byte boundary
    (2, 5, 16, 0, True),           # odd H in the 16-byte form
    (2, 1081, 1920, 0, True),
])
def test_yuv420_post_odd_and_unaligned_sizes(cuda, B, H, W, shift, vector):
    """Odd sizes (the edge-replicate pad), rows of a width that is not a
    multiple of 8 and frames off a 16-byte boundary take the scalar
    instantiation, the rest the 16-byte one; every byte equal."""
    rng = np.random.default_rng(B * H + W)
    x16 = torch.from_numpy(rng.uniform(-0.1, 1.3, (B, 4, H, W)).astype(
        np.float16)).to(cuda)
    if shift:
        x16 = _offset_view(x16, shift)
    assert _yuv420_vs_plain(x16, vector) == (0.0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize('vector', [True, False])
@pytest.mark.parametrize('channel', [0, 1, 2])
def test_yuv420_post_every_f16_bit_pattern(cuda, channel, vector):
    """Every f16 bit pattern (NaN, +/-inf, negatives, subnormals) in R, G
    or B, the other channels seeded: every byte equal, in both
    instantiations."""
    rng = np.random.default_rng(channel)
    x = rng.uniform(-0.1, 1.3, (1, 4, 256, 256)).astype(np.float16)
    x[0, channel] = np.arange(65536, dtype=np.uint16).view(
        np.float16).reshape(256, 256)
    x16 = torch.from_numpy(x).to(cuda)
    if not vector:
        x16 = _offset_view(x16, 1)
    assert _yuv420_vs_plain(x16, vector) == (0.0, 0)


@pytest.mark.gpu
def test_yuv420_post_unrounded_levels_of_every_triple(cuda):
    """The kernel's unrounded Y, Cb and Cr (``cuda_ops.yuv420_levels``)
    of all 256**3 (R, G, B) level triples, bit-equal to the plain ops'
    (``color.studio_ycbcr``) on the card."""
    from canvas_tpu_torch.ops import color
    got = co.yuv420_levels(cuda)
    i = torch.arange(1 << 24, dtype=torch.int32, device=cuda)
    want = color.studio_ycbcr((i >> 16).float(), ((i >> 8) & 255).float(),
                              (i & 255).float())
    for name, g, w in zip(('Y', 'Cb', 'Cr'), got, want):
        same = g.view(torch.int32) == w.view(torch.int32)
        assert bool(same.all()), (name, int((~same).sum()))


@pytest.mark.gpu
def test_yuv420_post_one_launch_a_batch_through_the_planner(cuda):
    """The headline through iter_batches(post='yuv420') on the card, its
    programs captured and replayed: one kernel launch per batch, none of
    the plain ops' (no other post ran), and each batch's bytes equal to
    the plain ops' over the same batch's f16 frames."""
    from canvas_tpu_torch import timelines
    from canvas_tpu_torch.ops import color
    from canvas_tpu_torch.render import RenderPlanner, box2i
    planner = RenderPlanner(timelines.build_timeline(64),
                            box2i(0, 0, 319, 179))
    frames = {s: out for s, _n, out in
              planner.iter_batches(0, 40, batch=8)}
    for _rep in range(3):
        before = _yuv420_counts()
        batches = list(planner.iter_batches(0, 40, batch=8, post='yuv420'))
        after = _yuv420_counts()
        assert after[0] - before[0] == len(batches) > 1
        assert after[1] - before[1] == len(batches)
        for s, _n, out in batches:
            assert torch.equal(out,
                               color.yuv420_pack_studio_plain(frames[s]))
    planner.close()


@pytest.mark.gpu
def test_yuv420_post_refuses_frames_not_f16_or_not_contiguous(cuda):
    """On a card the post takes contiguous f16 frames only: f32 frames
    and a strided view raise, and nothing launches."""
    from canvas_tpu_torch.ops import color
    x16 = torch.zeros((2, 4, 8, 16), dtype=torch.float16, device=cuda)
    before = _yuv420_counts()
    for bad in (x16.float(), x16[:, :, :, ::2]):
        with pytest.raises(ValueError, match='contiguous'):
            color.yuv420_pack_studio(bad)
    assert _yuv420_counts() == before
