"""The port's quality <= 9 tier (bf16 ``acc16`` accumulators) and
quality <= 5 tier (``lq`` bilinear scaler taps, with ``acc16``) against
the JAX package's, on the CPU.

- ``_eval`` at quality 9 on the headline (640x360) against
  ``canvas_tpu.render._eval`` on CPU JAX, both with the JAX fallbacks and
  with the Pallas kernel bodies run by the interpreter
  (``CANVAS_PALLAS_INTERPRET=1``, ``CANVAS_FOLD_MODE=pallas``, as
  tests/test_quality_acc16.py runs them): bit-equal f16 frames.
- One batch of the mixed-content timeline at quality 5 (1080p): within
  1e-2 with at least 99% of values bit-equal (the DV scalers' f32
  contractions sum in torch's order, not XLA's).
- The plain bf16 forms of the three kernels (``cuda_ops.*_plain`` on
  bf16 accumulators) against ``pallas_ops`` on the same inputs: equal to
  the JAX fallbacks bit for bit, and within one bf16 ulp (2**-7 at
  values up to 2) of the interpreted Pallas bodies, the tolerance of
  test_quality_acc16.py:119-126.
"""

import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bench
import benchmarks
from canvas_tpu import render as ref_render
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.ops import pallas_ops as po
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import cuda_ops as co
from test_torch_ops import REGION_OVER_CASES

CPU = torch.device('cpu')
BF16_ULP = 2.0 ** -7


@pytest.fixture
def interp(monkeypatch):
    """Switch the JAX package's Pallas kernels to the interpreter."""
    def on():
        monkeypatch.setenv('CANVAS_PALLAS_INTERPRET', '1')
        monkeypatch.setenv('CANVAS_FOLD_MODE', 'pallas')

    def off():
        monkeypatch.delenv('CANVAS_PALLAS_INTERPRET', raising=False)
        monkeypatch.delenv('CANVAS_FOLD_MODE', raising=False)

    off()
    return on, off


def _ref_eval(ws, window, start, stop, quality):
    """(signature, f16 frames) of the JAX package's program for
    [start, stop) at *quality*."""
    planner = ref_render.RenderPlanner(ws, ref_box2i(*window),
                                       quality=quality)
    planner._stage_cache = {}
    planner._frame_hints = {}
    node = ref_render.PlanContext(planner, np.arange(start, stop),
                                  ref_box2i(*window)).plan(ws)
    sig = node.signature()
    out = jax.jit(ref_render._make_run(sig, None, jnp, jax))(
        node.flat_params([]))
    return sig, np.asarray(out)


def _port_eval(ws, window, start, stop, quality):
    planner = port.RenderPlanner(ws, box2i(*window), quality=quality,
                                 device='cpu')
    node = planner._plan((start, stop))
    sig = port.signature(node)
    out = port.run(sig, port.params_to_torch(port.flat_params(node), CPU),
                   CPU)
    return sig, out.numpy()


@pytest.fixture(scope='module')
def headlines():
    return bench.build_timeline(1024), timelines.build_timeline(1024)


@pytest.mark.parametrize('interpreted', [False, True])
@pytest.mark.parametrize('start, stop', [(0, 1), (1, 5), (128, 132),
                                         (1000, 1003)])
def test_quality_9_headline_bit_equal(headlines, interp, interpreted, start,
                                      stop):
    """The mid fold stores bf16, both rank-1 regions blend over bf16
    accumulators, the finalize reads them: f16 frames bit-equal."""
    on, off = interp
    if interpreted:
        on()
    window = (0, 0, 639, 359)
    sig, want = _ref_eval(headlines[0], window, start, stop, 9)
    off()
    got_sig, got = _port_eval(headlines[1], window, start, stop, 9)
    assert got_sig == sig and 'acc16' in repr(sig)
    assert got.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_quality_5_mixed_batch_matches_jax():
    """lq taps and acc16 accumulators through region_over and the
    torch-blended full-frame layers, frames 64..71 at 1080p."""
    window = (0, 0, 1919, 1079)
    sig, want = _ref_eval(benchmarks._mixed_timeline(256), window, 64, 72, 5)
    got_sig, got = _port_eval(timelines.mixed_timeline(256), window, 64, 72,
                              5)
    assert got_sig == sig and 'acc16' in repr(sig)
    assert any(n == 'scale_taps_dyn' and st[-1] for n, st in _ops(sig))
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.99


def _ops(sig):
    yield sig[0], sig[1]
    for c in sig[3]:
        yield from _ops(c)


def _solid_layers(rng, L, B, H, W):
    color = rng.uniform(0.0, 1.0, size=(L, B, 4)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=(L, B)).astype(np.float32)
    offset = rng.uniform(-0.2, 0.2, size=(L, B)).astype(np.float32)
    box = np.zeros((L, B, 4), np.int32)
    for l in range(L):
        for b in range(B):
            box[l, b] = (rng.integers(0, H // 2), rng.integers(H // 2, H),
                         rng.integers(0, W // 2), rng.integers(W // 2, W))
    return color, box, gain, offset


def _bf16_pair(rng, shape):
    """The same bf16 values as a jnp array and a torch tensor."""
    x = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize('with_base, finalize', [
    (False, False), (True, False), (True, True)])
def test_solid_fold_plain_bf16_matches_pallas(interp, with_base, finalize):
    on, off = interp
    rng = np.random.default_rng(31)
    L, B, H, W = 3, 2, 128, 256
    layers = _solid_layers(rng, L, B, H, W)
    jl = [jnp.asarray(a) for a in layers]
    tl = [torch.from_numpy(a) for a in layers]
    P = A = tP = tA = None
    if with_base:
        P, tP = _bf16_pair(rng, (B, 3, H, W))
        A, tA = _bf16_pair(rng, (B, 1, H, W))
    kw = dict(finalize=True) if finalize else dict(acc_dtype=jnp.bfloat16)
    tkw = dict(finalize=True) if finalize else dict(acc_dtype=torch.bfloat16)
    got = co.solid_fold_plain(tP, tA, *tl, H, W, **tkw)
    got = [got] if finalize else list(got)
    for interpreted in (False, True):
        (on if interpreted else off)()
        want = po.solid_fold(jnp, jax, P, A, *jl, H, W, **kw)
        want = [want] if finalize else list(want)
        for g, w in zip(got, want):
            assert g.dtype == (torch.float32 if finalize else torch.bfloat16)
            assert np.asarray(w).dtype == (np.float32 if finalize
                                           else jnp.bfloat16)
            if interpreted:
                np.testing.assert_allclose(_f32(g), _f32(w), rtol=0,
                                           atol=BF16_ULP)
            else:
                np.testing.assert_array_equal(_f32(g), _f32(w))


# (kind, seed, (H, W, h, w, dy0, dx0)): a (128, 256) region at (64, 128)
# of a 192x384 frame for each region kernel, and region_over at every
# shape of test_torch_ops.REGION_OVER_CASES (overhanging the bottom, the
# right and both edges, where the card's scalar instantiation runs for
# W % 8 != 0, and the mixed timeline's three DV regions at 1080p), each
# seeded from its own name so that a case added there reseeds no other.
REGION_BF16_CASES = {
    'region_over': ('region_over', 37, (192, 384, 128, 256, 64, 128)),
    'region_over_sep': ('region_over_sep', 37,
                        (192, 384, 128, 256, 64, 128)),
}
REGION_BF16_CASES.update({'region_over-' + k: ('region_over',
                                               zlib.crc32(k.encode()), v)
                          for k, v in REGION_OVER_CASES.items()})


@pytest.mark.parametrize('case', sorted(REGION_BF16_CASES))
def test_region_plain_bf16_matches_pallas(interp, case):
    """A bf16 region over bf16 accumulators: dtype kept, pixels outside
    the region untouched, the plain form equal to the fallback and
    within one bf16 ulp of the interpreted kernel."""
    on, off = interp
    kind, seed, (H, W, h, w, dy0, dx0) = REGION_BF16_CASES[case]
    rng = np.random.default_rng(seed)
    B = 2
    P, tP = _bf16_pair(rng, (B, 3, H, W))
    A, tA = _bf16_pair(rng, (B, 1, H, W))
    if kind == 'region_over':
        layer, tlayer = _bf16_pair(rng, (B, 4, h, w))
        args, targs = (layer,), (tlayer,)
    else:
        f32 = [rng.uniform(0, 1, s).astype(np.float32)
               for s in ((B, 4), (B, h), (B, w))]
        args = tuple(jnp.asarray(a) for a in f32)
        targs = tuple(torch.from_numpy(a) for a in f32)
    gotP, gotA = getattr(co, kind + '_plain')(tP.clone(), tA.clone(),
                                              *targs, dy0, dx0)
    assert gotP.dtype == gotA.dtype == torch.bfloat16
    outside = np.ones((H, W), bool)
    outside[dy0:dy0 + h, dx0:dx0 + w] = False
    np.testing.assert_array_equal(_f32(gotP)[:, :, outside],
                                  _f32(tP)[:, :, outside])
    np.testing.assert_array_equal(_f32(gotA)[:, :, outside],
                                  _f32(tA)[:, :, outside])
    for interpreted in (False, True):
        (on if interpreted else off)()
        wantP, wantA = getattr(po, kind)(jnp, jax, P, A, *args,
                                         jnp.int32(dy0), jnp.int32(dx0))
        for g, wnt in ((gotP, wantP), (gotA, wantA)):
            if interpreted:
                np.testing.assert_allclose(_f32(g), _f32(wnt), rtol=0,
                                           atol=BF16_ULP)
            else:
                np.testing.assert_array_equal(_f32(g), _f32(wnt))


def test_bf16_wrappers_take_the_plain_forms_on_the_cpu():
    """On CPU tensors the bf16 forms run their plain versions and count
    no launch."""
    rng = np.random.default_rng(41)
    B, H, W = 1, 64, 128
    layers = [torch.from_numpy(a) for a in _solid_layers(rng, 2, B, H, W)]
    before = (co.solid_fold.launches_bf16, co.region_over.launches_bf16,
              co.region_over_sep.launches_bf16)
    P, A = co.solid_fold(None, None, *layers, H, W, acc_dtype=torch.bfloat16)
    assert P.dtype == A.dtype == torch.bfloat16
    out = co.solid_fold(P, A, *layers, H, W, finalize=True,
                        out_dtype=torch.float16)
    want = co.solid_fold_plain(P, A, *layers, H, W, finalize=True,
                               out_dtype=torch.float16)
    assert torch.equal(out, want)
    co.region_over(P, A, torch.zeros((B, 4, 64, 128), dtype=torch.bfloat16),
                   0, 0)
    co.region_over_sep(P, A, torch.zeros((B, 4)), torch.zeros((B, 64)),
                       torch.zeros((B, 128)), 0, 0)
    assert (co.solid_fold.launches_bf16, co.region_over.launches_bf16,
            co.region_over_sep.launches_bf16) == before
