"""A configuration's layers (``configs/<name>.json``) built as a
``canvas_tpu_torch`` source from the port's public classes.

A configuration lists its layers bottom to top; each is a dict with a
``kind``:

- ``solid``: ``color`` (an RGBA list, or ``{"lerp": [from, to]}`` over
  the configuration's ``length``) inside an optional ``window`` box;
- ``gain_offset``: ``source`` scaled by ``gain`` (``{"linear": [a, b]}``
  is ``a / length * frame + b``) plus ``offset``, alpha unchanged;
- ``scaler``: ``source`` scaled about ``source_point`` onto
  ``target_point`` by ``scale_factors``, fetched from ``source_rect``;
- ``mix``: ``a`` crossfaded into ``b`` by ``mix``;
- ``dv``: a 720x480 4:1:1 DV clip (``clip`` picks its seeded planes,
  ``inputs.dv_base_planes``) through the DV reconstruction.

Any other kind is a pair of files: ``layers/<kind>.py``, whose
``build(spec, length, seed, build_layer)`` returns the source built from
the port's public classes (``canvas_tpu_torch.process``, ``coded``,
``timelines``) and builds a nested spec with the *build_layer* it is
handed, and ``reference/layers/<kind>.py`` (``reference/compose.py``).

The same dicts drive the plain reference (``reference/compose.py``).
"""

import os

from canvas_tpu_torch import process

from gpubench import cells, inputs
from gpubench.reference import compose

#: Where a layer kind of its own is found: ``<kind>.py``.
LAYERS_DIR = os.path.join(cells.HERE, 'layers')


def _func(value, length):
    """A frame function of a spec value: a constant, a lerp over
    *length*, or a linear ramp."""
    if isinstance(value, dict):
        if 'lerp' in value:
            a, b = value['lerp']
            return process.LerpFunc(tuple(a), tuple(b), length)
        if 'linear' in value:
            a, b = value['linear']
            return process.LinearFrameFunc(a / length, b)
        raise ValueError('unknown frame function %r' % (value,))
    if isinstance(value, list):
        return tuple(value)
    return value


class SeededDV(process.CodedImageSource):
    """The seeded planes of one DV clip, rolled by the frame index."""

    def __init__(self, seed, clip):
        self.base = inputs.dv_base_planes(seed, clip)

    def get_frame(self, frame_index, quality=0):
        return process.CodedImage(list(inputs.dv_frame_planes(self.base,
                                                      frame_index)))


def build_layer(spec, length, seed):
    kind = spec['kind']
    if kind == 'solid':
        window = spec.get('window')
        return process.SolidColorVideoSource(
            _func(spec['color'], length),
            None if window is None else process.box2i(*window))
    if kind == 'gain_offset':
        return process.VideoGainOffsetFilter(
            build_layer(spec['source'], length, seed),
            gain=_func(spec['gain'], length),
            offset=_func(spec.get('offset', 0.0), length))
    if kind == 'scaler':
        return process.VideoScaler(
            build_layer(spec['source'], length, seed),
            target_point=_func(spec['target_point'], length),
            source_point=_func(spec['source_point'], length),
            scale_factors=_func(spec['scale_factors'], length),
            source_rect=process.box2i(*spec['source_rect']))
    if kind == 'mix':
        return process.VideoMixFilter(
            build_layer(spec['a'], length, seed),
            build_layer(spec['b'], length, seed),
            _func(spec['mix'], length))
    if kind == 'dv':
        return process.DVReconstructionFilter(SeededDV(seed, spec['clip']))
    return _kind(kind).build(spec, length, seed, build_layer)


def _kind(kind):
    """The module of layer kind *kind*, whose reference has to be there
    too: the check renders every layer the program builds."""
    paths = [os.path.join(LAYERS_DIR, kind + '.py'),
             os.path.join(compose.LAYERS_DIR, kind + '.py')]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise SystemExit('unknown layer kind %r: looked for %s and %s; '
                         'missing %s' % (kind, paths[0], paths[1],
                                         ', '.join(missing)))
    cells.refuse_program_imports(paths[1])
    return cells.load(paths[0], 'gpubench.layers.' + kind)


def build(config, seed):
    """The configuration's workspace: each layer an item of its own over
    the whole length, stacked in the order listed."""
    length = config['length']
    ws = process.VideoWorkspace()
    for z, spec in enumerate(config['layers']):
        ws.add(source=build_layer(spec, length, seed), x=0, length=length,
               z=z)
    return ws


def window(config):
    return process.box2i(*config['window'])
