"""The port's editor plugins (canvas_tpu_torch.editor.plugins: the
plugin manager, the libav source and codec plugin) and the
``u8_linearize`` op its generic video codec plans, on the CPU.

- ``PluginManager.load_all`` finds the port's ``libav.plugin`` and loads
  ``canvas_tpu_torch.editor.plugins.libav_plugin``, not the JAX
  package's; the two managers keep their state apart.
- ``u8_linearize`` in the port's ``render._eval`` is bit-equal to
  ``canvas_tpu.render._eval`` on a seeded u8 batch that holds every u8
  value in every channel; ``_RgbaDecoderSource`` over a seeded decoder
  plans the same IR in both packages, renders bit-equal to the JAX
  package's program and to its own pull path.
- A DV tape through the port's editor without ``EditorApp`` (the port's
  counterpart of tests/test_dv_editor_workflow.py): imported through
  the port's own build of the native layer and the plugin chain, edited
  with undoable commands, saved and reopened through ``yamlio``, with
  pulls equal to the JAX editor's and to the reopened project's. It
  skips where the native layer cannot be built, as the JAX test does.
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from canvas_tpu import render as ref_render
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.editor.plugins import PluginManager as RefManager
from canvas_tpu.editor.plugins import libav_plugin as ref_libav_plugin
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import ir
from canvas_tpu_torch import render as port
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.editor import model, plugins, yamlio
from canvas_tpu_torch.editor.plugins import PluginManager
from canvas_tpu_torch.editor.plugins import libav_plugin
from canvas_tpu_torch.editor.settings import set_settings_path

CPU = torch.device('cpu')
SEED = 20261017


@pytest.fixture(autouse=True)
def fresh_settings(tmp_path):
    from canvas_tpu.editor.settings import set_settings_path as ref_set
    set_settings_path(str(tmp_path / 'settings.json'))
    ref_set(str(tmp_path / 'ref_settings.json'))
    PluginManager._reset_for_tests()
    RefManager._reset_for_tests()
    yield
    PluginManager._reset_for_tests()
    RefManager._reset_for_tests()


def test_load_all_loads_the_ports_libav_plugin():
    PluginManager.load_all()
    assert [m.module_name for m in PluginManager.plugin_modules] == [
        'canvas_tpu_torch.editor.plugins.libav_plugin']
    assert all(m.module is libav_plugin for m in PluginManager.plugin_modules)
    for urn, cls in (('urn:canvas-tpu/plugins:libav',
                      libav_plugin.LibavSourcePlugin),
                     ('urn:canvas-tpu/plugins:libav-codecs',
                      libav_plugin.LibavCodecPlugin)):
        assert PluginManager.find_plugin_by_urn(urn, enabled_only=False) \
            is cls
    # enabling in the port's manager leaves the JAX editor's alone
    PluginManager.set_plugin_enabled(libav_plugin.LibavCodecPlugin, True)
    assert [c.__module__ for c in PluginManager.find_decoders()] == [
        'canvas_tpu_torch.editor.plugins.libav_plugin'] * 3
    assert RefManager.plugin_modules is None
    RefManager.load_all()
    assert not RefManager.is_plugin_enabled(
        ref_libav_plugin.LibavCodecPlugin)
    assert PluginManager.is_plugin_enabled(libav_plugin.LibavCodecPlugin)


def _u8_batch(B=3, H=24, W=40):
    """Seeded (B, H, W, 4) u8 RGBA holding every u8 value in every
    channel."""
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8)
    data.reshape(-1, 4)[:256] = np.arange(256, dtype=np.uint8)[:, None]
    return data


def test_u8_linearize_bit_equal_to_jax():
    data = _u8_batch()
    B, H, W = data.shape[:3]
    win = np.tile(np.asarray([0, 0, W - 1, H - 1], np.int64), (B, 1))
    node = ref_render.Node('u8_linearize', params={'data': data},
                           windows=win)
    sig = node.signature()
    params = node.flat_params([])
    want = np.asarray(ref_render._eval(sig, iter(params), jnp, jax))
    pnode = ir.Node('u8_linearize', params={'data': data}, windows=win)
    assert port.signature(pnode) == sig
    got = port._eval(sig, iter(port.params_to_torch(
        port.flat_params(pnode), CPU)), CPU).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (B, 4, H, W)
    np.testing.assert_array_equal(got, want)
    # u8 0 and 255 linearize to 0.0 and 1.0; every value in between is
    # the curve's at v/255 rounded to the nearest f16 (a truncating
    # quantizer lands one f16 step low on many of them)
    assert got[0, 3].max() == 1.0 and got.min() == 0.0
    assert np.unique(got[:, 0]).size == 256


class _Decoder:
    """A decoder's ``get_frame_rgba``: seeded (H, W, 4) u8 frames, None
    past *length*."""

    def __init__(self, length=8):
        self.length = length

    def get_frame_rgba(self, frame_index, width, height):
        if not 0 <= frame_index < self.length:
            return None
        rng = np.random.default_rng(SEED + frame_index)
        rgba = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
        rgba[..., 3] = 255
        return rgba


@pytest.mark.parametrize('window', [(0, 0, 47, 31), (-8, 4, 63, 27)])
def test_rgba_decoder_source_plans_and_renders_like_jax(window):
    """The generic codec's RGBA fallback: a staged u8 stack, linearized
    on the device, then placed in the window."""
    port_src = libav_plugin._RgbaDecoderSource(_Decoder(), 48, 32)
    ref_src = ref_libav_plugin._RgbaDecoderSource(_Decoder(), 48, 32)
    planner = port.RenderPlanner(port_src, box2i(*window), device='cpu')
    node = planner._plan((0, 6))
    assert node.op == 'place' and node.children[0].op == 'u8_linearize'
    rp = ref_render.RenderPlanner(ref_src, ref_box2i(*window))
    ref = ref_render.PlanContext(rp, np.arange(0, 6), rp.window).plan(ref_src)
    assert port.signature(node) == ref.signature()
    for p, q in zip(port.flat_params(node), ref.flat_params([])):
        for k in q:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(q[k]))
    got = planner.render(0, 6)
    want = np.asarray(ref_render.render_frames(ref_src, ref_box2i(*window),
                                               0, 6))
    np.testing.assert_array_equal(got, want)
    for f in (0, 5):
        pull = port_src.get_frame_f16(f, box2i(*window))
        np.testing.assert_array_equal(got[f], np.asarray(pull.data,
                                                         np.float16))
    planner.close()


# --- a DV tape through the port's editor ------------------------------------

@pytest.fixture(scope='module')
def dv_file(tmp_path_factory):
    ref_libav = pytest.importorskip('canvas_tpu.libav')
    if not ref_libav.available():
        pytest.skip('native canvas_av unavailable')
    from canvas_tpu_torch import libav
    path = str(tmp_path_factory.mktemp('dv') / 'tape.avi')
    try:
        mux = libav.AVMuxer(path)
        vstream = mux.add_video_stream('dvvideo', (720, 480),
                                       Fraction(30000, 1001))
    except IOError as e:
        pytest.skip('dvvideo encoder unavailable: %s' % e)
    with mux:
        for i in range(10):
            rgba = np.zeros((480, 720, 4), np.uint8)
            rgba[..., 1] = 40 + 20 * i        # green ramps per frame
            rgba[..., 3] = 255
            mux.write_video_frame(vstream, rgba)
    return path


def _enable_all(manager):
    for p in manager.find_plugins(enabled_only=False):
        manager.set_plugin_enabled(p, True)


def _import(pkg_model, pkg_plugins, assets, name, path):
    """The editor's import of a file: the first source plugin that reads
    it makes a PluginSourceAsset."""
    for plugin in pkg_plugins.PluginManager.find_plugins(
            pkg_plugins.SourcePlugin):
        source = plugin.create_source_from_file(name, path)
        if source is not None:
            assets[name] = pkg_model.PluginSourceAsset(
                name, plugin.plugin_urn, source.get_definition())
            return assets[name]
    raise IOError('No plugin could read ' + path)


def _cut(pkg_model, pkg_plugins, path):
    """A project 'cut' holding the tape as one 10-frame video clip,
    added by an undoable command; (assets, the cut's video stream, the
    clip, the undo stack)."""
    assets = pkg_model.AssetList()
    _import(pkg_model, pkg_plugins, assets, 'tape', path)
    space = pkg_model.Space('cut', pkg_plugins.VideoFormat(
        frame_rate=Fraction(30000, 1001)),
        pkg_plugins.AudioFormat(sample_rate=48000))
    assets['cut'] = pkg_model.SpaceAsset(space, name='cut')
    clip = pkg_model.Clip(type='video', x=0, y=0.0, length=10, height=1.0,
                          source=pkg_model.AssetStreamRef('tape', '0'),
                          offset=0)
    stack = pkg_model.UndoStack()
    stack.push(pkg_model.InsertItemCommand(space, clip, 0))
    source = assets['cut'].get_source()
    source.bring_online()
    return assets, source.get_stream('Video'), clip, stack


def test_dv_tape_through_the_ports_editor(dv_file, tmp_path):
    from canvas_tpu.editor import model as ref_model
    from canvas_tpu.editor import plugins as ref_plugins

    _enable_all(PluginManager)
    assets, video, clip, stack = _cut(model, plugins, dv_file)
    tape = assets['tape'].get_source()
    assert not tape.offline, [str(a) for a in (tape.alerts or [])]
    vstream = tape.get_stream('0')
    assert isinstance(vstream.codec, libav_plugin.DVVideoCodec)
    assert type(vstream).__module__.startswith('canvas_tpu_torch.')

    _enable_all(RefManager)
    _ref_assets, ref_video, _c, _s = _cut(ref_model, ref_plugins, dv_file)

    win = box2i(0, 0, 719, 479)
    greens = []
    for f in (0, 4, 8):
        with port_backend.force_backend('numpy'):
            frame = video.get_frame_f16(f, win)
        want = ref_video.get_frame_f16(f, ref_box2i(0, 0, 719, 479))
        np.testing.assert_array_equal(np.asarray(frame.data),
                                      np.asarray(want.data))
        px = frame.pixel(360, 240)
        greens.append(float(px.g))
        assert float(px.g) > 2.5 * max(float(px.r), float(px.b)), (f, px)
    assert greens[0] < greens[1] < greens[2]

    # the batched path over the decoded tape: DV staged rows through the
    # port's plan, within the coded gate of the pull path
    planner = port.RenderPlanner(video, box2i(200, 160, 519, 339),
                                 device='cpu')
    planner.stage_cache_mb = 0
    batch = planner.render(2, 6)
    for f in (2, 5):
        with port_backend.force_backend('numpy'):
            pull = np.asarray(video.get_frame_f16(
                f, box2i(200, 160, 519, 339)).data, np.float16)
        np.testing.assert_allclose(batch[f - 2].astype(np.float32),
                                   pull.astype(np.float32), rtol=0,
                                   atol=1e-2)
        assert np.mean(batch[f - 2] == pull) >= 0.99
    planner.close()

    # trim with an undoable command: frame 8 goes empty, and comes back
    stack.push(model.AdjustClipLengthCommand(clip, -5))
    with port_backend.force_backend('numpy'):
        assert video.get_frame_f16(8, win).current_window.empty()
        stack.undo()
        assert not video.get_frame_f16(8, win).current_window.empty()

    # project round trip through the port's YAML
    with port_backend.force_backend('numpy'):
        want = np.asarray(video.get_frame_f16(4, win).data)
    path = str(tmp_path / 'cut.yaml')
    with open(path, 'w') as stream:
        yamlio.dump(model.Project(assets=assets), stream)
    PluginManager._reset_for_tests()
    _enable_all(PluginManager)
    with open(path) as stream:
        project = yamlio.load(stream)
    project.fixup()
    source = project.assets['cut'].get_source()
    source.bring_online()
    again = source.get_stream('Video')
    with port_backend.force_backend('numpy'):
        got = np.asarray(again.get_frame_f16(4, win).data)
    np.testing.assert_array_equal(got, want)
    assert os.path.getsize(path) > 0
