"""The port's editor model (canvas_tpu_torch.editor: model, undo
commands, YAML) against the JAX package's editor, on the CPU.

- One script of 32 edits, its numbers drawn from a seeded NumPy
  generator, runs on a project of each package: inserts, moves, clip
  length/start/height/slip adjustments, sequence transitions and item
  lengths, removals from the space and from the sequence, bring forward
  and send back, undo and redo through each package's ``UndoStack``.
  After every step the two ``!CanvasSpace`` documents are text-equal.
  (``tests/test_torch_editor_graph.py`` runs the same script through
  both packages' graph managers and planners.)
- A document either editor saves opens in the other, and writes out
  to the same text again.
- The YAML registries do not clash: the port registers its tags on its
  own ``yamlio.Loader``/``Dumper``, never on PyYAML's global classes, so
  in a process that imports both packages, in either order, the JAX
  editor's ``yaml.load(..., Loader=yaml.Loader)`` builds the JAX
  package's classes and ``yamlio.load`` the port's.
"""

import fractions
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from canvas_tpu import process as ref_process
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.editor import model as ref_model
from canvas_tpu.editor import plugins as ref_plugins
from canvas_tpu_torch import process as port_process
from canvas_tpu_torch.basetypes import box2i as port_box2i
from canvas_tpu_torch.editor import model as port_model
from canvas_tpu_torch.editor import plugins as port_plugins
from canvas_tpu_torch.editor import yamlio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each package's editor, so a project builds and edits the same from
#: either.
REF = SimpleNamespace(model=ref_model, plugins=ref_plugins,
                      process=ref_process, box2i=ref_box2i,
                      dump=yaml.dump,
                      load=lambda text: yaml.load(text, Loader=yaml.Loader))
PORT = SimpleNamespace(model=port_model, plugins=port_plugins,
                       process=port_process, box2i=port_box2i,
                       dump=yamlio.dump, load=yamlio.load)

SEED = 20261017

#: The script's sources: name -> (color at frame 0, color at frame 63,
#: window); the partly transparent ones let every lane show.
COLORS = {
    'red': ((0.9, 0.1, 0.1, 1.0), (0.5, 0.2, 0.1, 1.0), None),
    'green': ((0.1, 0.8, 0.2, 0.6), (0.2, 0.4, 0.1, 0.9), (8, 4, 70, 50)),
    'blue': ((0.1, 0.2, 0.9, 0.5), (0.3, 0.3, 0.6, 0.7), (20, 10, 90, 60)),
    'white': ((1.0, 1.0, 1.0, 0.3), (1.0, 1.0, 1.0, 0.3), (0, 40, 95, 63)),
}


def make_assets(pkg, length=64):
    """An AssetList of the script's runtime sources, each one stream
    'video' behind a plugins.VideoStream."""
    assets = pkg.model.AssetList()
    for name, (c0, c1, win) in COLORS.items():
        kw = {} if win is None else {'window': pkg.box2i(*win)}
        source = pkg.process.SolidColorVideoSource(
            pkg.process.LerpFunc(c0, c1, length), **kw)
        assets[name] = pkg.model.RuntimeSourceAsset(pkg.model.RuntimeSource(
            name, {'video': pkg.plugins.VideoStream(source)}))
    return assets


def _ref(pkg, name):
    return pkg.model.AssetStreamRef(asset_path=name, stream='video')


def make_space(pkg):
    """The script's project: two overlapping clips in lane 0, a
    three-clip sequence in lane 1, a clip in lane 2, in a 96x64 space."""
    m = pkg.model
    space = m.Space('edits', pkg.plugins.VideoFormat(
        full_frame=pkg.box2i(0, 0, 95, 63),
        frame_rate=fractions.Fraction(25)),
        pkg.plugins.AudioFormat(sample_rate=48000))
    seq = m.Sequence(type='video', x=2, y=1.0, height=1.0, items=[
        m.SequenceItem(source=_ref(pkg, 'green'), offset=1, length=16),
        m.SequenceItem(source=_ref(pkg, 'blue'), offset=2, length=16,
                       transition_length=4),
        m.SequenceItem(source=_ref(pkg, 'red'), offset=0, length=16,
                       transition_length=6)])
    space[0:0] = [
        m.Clip(type='video', x=0, y=0.0, length=40, height=1.0,
               source=_ref(pkg, 'red'), offset=0),
        m.Clip(type='video', x=10, y=0.0, length=20, height=1.0,
               source=_ref(pkg, 'blue'), offset=3),
        seq,
        m.Clip(type='video', x=5, y=2.0, length=30, height=1.0,
               source=_ref(pkg, 'white'), offset=0),
    ]
    return space


def _draws():
    """The script's numbers, drawn once from the seeded generator."""
    rng = np.random.default_rng(SEED)
    return SimpleNamespace(
        move_x=int(rng.integers(0, 12)), len_cut=int(rng.integers(2, 9)),
        start=int(rng.integers(1, 5)), trans=int(rng.integers(5, 9)),
        seq_len=int(rng.integers(1, 4)), seq_start=int(rng.integers(1, 3)),
        slip=int(rng.integers(1, 6)), ins_x=int(rng.integers(0, 20)),
        ins_len=int(rng.integers(8, 24)), height=float(rng.integers(1, 4)) / 4,
        move_y=float(rng.integers(3, 5)), grow=int(rng.integers(1, 10)))


def _clip(key):
    return lambda st: st[key]


def _push(make):
    def step(pkg, st):
        st['stack'].push(make(pkg, st))
    return step


def _undo(pkg, st):
    st['stack'].undo()


def _redo(pkg, st):
    st['stack'].redo()


def _insert(key, lane):
    def make(pkg, st):
        d = st['draws']
        st[key] = pkg.model.Clip(type='video', x=d.ins_x, y=lane,
                                 length=d.ins_len, height=1.0,
                                 source=_ref(pkg, 'green'), offset=2)
        return pkg.model.InsertItemCommand(st['space'], st[key], 1)
    return make


def _seq(i):
    return lambda st: st['S'][i]


def build_script():
    """(name, step) pairs: step(pkg, state) applies one edit to a
    package's project; state holds 'space', 'stack', 'draws' and the
    items by name ('A', 'B', 'S', 'C', and the clips inserted)."""
    d = _draws()

    def cmd(name, *args):
        def make(pkg, st):
            resolved = [a(st) if callable(a) else a for a in args]
            return getattr(pkg.model, name)(*resolved)
        return make

    def remove(key):
        return lambda pkg, st: pkg.model.RemoveItemCommand(st['space'],
                                                           st[key])

    def set_props(target, **kw):
        return lambda pkg, st: pkg.model.UpdateItemPropertiesCommand(
            target(st), **kw)

    return [
        ('move C', _push(cmd('MoveItemCommand', _clip('C'), d.move_x, 2.0))),
        ('trim A', _push(cmd('AdjustClipLengthCommand', _clip('A'),
                             -d.len_cut))),
        ('start B', _push(cmd('AdjustClipStartCommand', _clip('B'),
                              d.start))),
        ('send A back', _push(cmd('SendItemBackCommand', _clip('A')))),
        ('undo', _undo),
        ('bring B forward', _push(cmd('BringItemForwardCommand',
                                      _clip('B')))),
        ('transition S1', _push(set_props(_seq(1),
                                          transition_length=d.trans))),
        ('seq length S0', _push(cmd('AdjustSequenceItemLengthCommand',
                                    _seq(0), -d.seq_len))),
        ('seq start S2', _push(cmd('AdjustSequenceItemStartCommand',
                                   _seq(2), d.seq_start))),
        ('undo', _undo),
        ('redo', _redo),
        ('insert D', _push(_insert('D', 0.0))),
        ('slip A', _push(cmd('SlipBehindCommand', _clip('A'), d.slip))),
        ('height C', _push(cmd('AdjustClipHeightCommand', _clip('C'),
                               d.height))),
        ('remove D', _push(remove('D'))),
        ('undo', _undo),
        ('move D', _push(cmd('MoveItemCommand', _clip('D'), d.ins_x + 4,
                             d.move_y))),
        ('remove S1', _push(lambda pkg, st:
                            pkg.model.RemoveAdjacentItemsFromSequenceCommand(
                                [st['S'][1]]))),
        ('undo', _undo),
        ('grow B', _push(cmd('AdjustClipLengthCommand', _clip('B'),
                             d.grow))),
        ('move S', _push(cmd('MoveItemCommand', _clip('S'), 6, 1.0))),
        ('cut transition S2', _push(set_props(_seq(2),
                                              transition_length=0))),
        ('send B back', _push(cmd('SendItemBackCommand', _clip('B')))),
        ('remove A', _push(remove('A'))),
        ('undo', _undo),
        ('undo', _undo),
        ('redo', _redo),
        ('insert E', _push(_insert('E', 3.0))),
        ('trim E', _push(cmd('AdjustClipStartCommand', _clip('E'), 2))),
        ('remove C', _push(remove('C'))),
        ('undo', _undo),
        ('send A back', _push(cmd('SendItemBackCommand', _clip('A')))),
    ]


SCRIPT = build_script()


def start_state(pkg):
    space = make_space(pkg)
    return {'space': space, 'stack': pkg.model.UndoStack(),
            'draws': _draws(), 'A': space[0], 'B': space[1], 'S': space[2],
            'C': space[3]}


def test_script_is_long_and_seeded():
    """32 steps, every one of which changes the document."""
    names = [name for name, _step in SCRIPT]
    assert len(names) >= 30
    assert names.count('undo') >= 5 and 'redo' in names
    assert _draws() == _draws()
    st = start_state(PORT)
    texts = [PORT.dump(st['space'])]
    for _name, step in SCRIPT:
        step(PORT, st)
        texts.append(PORT.dump(st['space']))
    assert all(a != b for a, b in zip(texts, texts[1:])), [
        name for (name, _s), a, b in zip(SCRIPT, texts, texts[1:])
        if a == b]


def test_scripted_edits_keep_documents_equal():
    """After every step, the port's ``!CanvasSpace`` document is the JAX
    editor's, character for character; the undo stacks agree."""
    states = {'ref': start_state(REF), 'port': start_state(PORT)}
    want = REF.dump(states['ref']['space'])
    assert PORT.dump(states['port']['space']) == want
    for i, (name, step) in enumerate(SCRIPT):
        texts = {}
        for key, pkg in (('ref', REF), ('port', PORT)):
            step(pkg, states[key])
            texts[key] = pkg.dump(states[key]['space'])
        assert texts['port'] == texts['ref'], (i, name)
        assert ((states['port']['stack'].index,
                 states['port']['stack'].count())
                == (states['ref']['stack'].index,
                    states['ref']['stack'].count())), (i, name)
        assert ([it.z for it in states['port']['space']]
                == [it.z for it in states['ref']['space']]), (i, name)
    assert '!CanvasSequenceItem' in texts['port']


def _project(pkg):
    space = make_space(pkg)
    assets = pkg.model.AssetList()
    assets['tape'] = pkg.model.PluginSourceAsset(
        name='tape', plugin_urn='urn:canvas-tpu/plugins:libav',
        definition={'path': 'tape.avi', 'streams': {}})
    assets['edits'] = pkg.model.SpaceAsset(space, name='edits')
    return pkg.model.Project(assets=assets)


@pytest.mark.parametrize('writer, reader', [('ref', 'port'),
                                            ('port', 'ref')])
def test_document_opens_in_the_other_editor(writer, reader):
    pkgs = {'ref': REF, 'port': PORT}
    w, r = pkgs[writer], pkgs[reader]
    text = w.dump(_project(w))
    loaded = r.load(text)
    assert type(loaded) is r.model.Project
    loaded.fixup()
    space = loaded.assets['edits'].space
    assert type(space) is r.model.Space
    assert [type(it).__name__ for it in space] == ['Clip', 'Clip',
                                                   'Sequence', 'Clip']
    assert type(space.video_format) is r.plugins.VideoFormat
    assert type(space.video_format.full_frame) is r.box2i
    assert loaded.assets['tape'].get_source().plugin_urn == \
        'urn:canvas-tpu/plugins:libav'
    assert r.dump(loaded) == text


def test_port_leaves_the_global_registry_alone():
    """The port's tags live on yamlio's classes only: PyYAML's global
    Dumper has no representer of a port class and its Loader no
    constructor from the port, so its '!CanvasClip' (the JAX editor's)
    builds a JAX clip; yamlio's classes hold none of the JAX package's."""
    clip = port_model.Clip(type='video', x=3, length=5)
    assert '!CanvasClip' in yamlio.dump(clip)
    for cls, reg in ((yaml.Dumper, 'yaml_representers'),
                     (yaml.Loader, 'yaml_constructors'),
                     (yamlio.Dumper, 'yaml_representers'),
                     (yamlio.Loader, 'yaml_constructors')):
        other = 'canvas_tpu_torch' if cls.__module__.startswith('yaml') \
            else 'canvas_tpu.'
        for key, fn in getattr(cls, reg).items():
            owner = getattr(key, '__module__', None) or ''
            made_by = getattr(fn, '__module__', None) or ''
            assert not owner.startswith(other), (cls, key)
            assert not made_by.startswith(other), (cls, key)
    assert type(yaml.load(yamlio.dump(clip), Loader=yaml.Loader)) is \
        ref_model.Clip
    assert type(yamlio.load(yamlio.dump(clip))) is port_model.Clip


REGISTRY_SCRIPT = textwrap.dedent('''
    import sys
    import yaml
    order = sys.argv[1].split(',')
    mods = {}
    for name in order:
        if name == 'ref':
            from canvas_tpu.editor import model as m, plugins as p
        else:
            from canvas_tpu_torch.editor import model as m, plugins as p
        mods[name] = (m, p)
    from canvas_tpu_torch.editor import yamlio

    def space(m, p):
        s = m.Space('s', p.VideoFormat(), p.AudioFormat())
        seq = m.Sequence(type='video', items=[
            m.SequenceItem(source=m.AssetStreamRef('red', 'video'),
                           offset=1, length=10),
            m.SequenceItem(source=m.AssetStreamRef('blue', 'video'),
                           offset=1, length=10, transition_length=5)])
        clip = m.Clip(type='video', x=3, y=1.0, length=5, height=1.0,
                      source=m.AssetStreamRef('red', 'video'), offset=2)
        s[0:0] = [clip, seq]
        return s

    # the JAX editor's test_yaml_round_trip_space, as it runs there
    m, p = mods['ref']
    text = yaml.dump(space(m, p))
    loaded = yaml.load(text, Loader=yaml.Loader)
    loaded._video_format = p.VideoFormat()
    loaded._audio_format = p.AudioFormat()
    loaded.fixup()
    assert type(loaded) is m.Space and type(loaded[0]) is m.Clip
    assert type(loaded[1][0]) is m.SequenceItem
    assert loaded[0].x == 3 and loaded[0].source.asset_path == 'red'
    assert len(loaded[1]) == 2
    # the port's, through its own classes
    pm, pp = mods['port']
    ptext = yamlio.dump(space(pm, pp))
    assert ptext == text
    back = yamlio.load(ptext)
    back.fixup()
    assert type(back) is pm.Space and type(back[0]) is pm.Clip
    assert type(back[1][0]) is pm.SequenceItem
    assert type(back.video_format) is pp.VideoFormat
    assert type(yaml.load(ptext, Loader=yaml.Loader)) is m.Space
    print('REGISTRY_OK')
''')


@pytest.mark.parametrize('order', ['ref,port', 'port,ref'])
def test_registries_do_not_clash_in_either_import_order(order):
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    env.setdefault('JAX_PLATFORMS', 'cpu')
    proc = subprocess.run([sys.executable, '-c', REGISTRY_SCRIPT, order],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'REGISTRY_OK' in proc.stdout


def test_base_types_round_trip_through_yamlio():
    """The base types' tags, as the JAX package writes them."""
    from canvas_tpu import basetypes as rb
    from canvas_tpu_torch import basetypes as pb
    doc = [pb.v2i(3, -4), pb.v2f(0.5, -1.25), pb.box2i(0, 0, 719, 479),
           pb.box2f(pb.v2f(0.5, 0.25), pb.v2f(1.5, 2.0)),
           pb.rgba(0.1, 0.2, 0.3, 1.0), fractions.Fraction(30000, 1001)]
    ref = [rb.v2i(3, -4), rb.v2f(0.5, -1.25), rb.box2i(0, 0, 719, 479),
           rb.box2f(rb.v2f(0.5, 0.25), rb.v2f(1.5, 2.0)),
           rb.rgba(0.1, 0.2, 0.3, 1.0), fractions.Fraction(30000, 1001)]
    text = yamlio.dump(doc)
    assert text == yaml.dump(ref)
    back = yamlio.load(text)
    assert back == doc
    assert [type(v) for v in back] == [type(v) for v in doc]


def test_settings_default_file_is_the_ports(monkeypatch, tmp_path):
    """The two editors keep their plugin choices apart."""
    from canvas_tpu.editor import settings as ref_settings
    from canvas_tpu_torch.editor import settings as port_settings
    monkeypatch.setenv('HOME', str(tmp_path))
    for mod in (ref_settings, port_settings):
        monkeypatch.setattr(mod, '_instance', None)
        monkeypatch.setattr(mod, '_path_override', None)
    assert port_settings.get_settings().path == str(
        tmp_path / '.config' / 'canvas_tpu_torch' / 'settings.json')
    assert ref_settings.get_settings().path != \
        port_settings.get_settings().path
