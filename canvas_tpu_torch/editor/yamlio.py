"""The editor's YAML: project documents in the reference's tags.

The model's classes (``!CanvasClip``, ``!CanvasSpace``, ``!Project``,
``!VideoFormat``, ...) and the base types (``!v2i``, ``!box2i``,
``!rational``, ...) register on this module's ``Loader`` and ``Dumper``
and nowhere else: PyYAML's global ``yaml.Loader`` and ``yaml.Dumper``
stay untouched, so another package in the same process that registers
the same tags there (the JAX editor does) keeps its classes, and this
one keeps its own. The tags are the same, so a document either writes
opens in the other.

Both classes start from PyYAML's stock constructors and representers,
not from whatever the global classes hold when this module is
imported::

    from canvas_tpu_torch.editor import yamlio
    text = yamlio.dump(project)
    project = yamlio.load(text)
"""

import fractions

import yaml

from canvas_tpu_torch.basetypes import box2f, box2i, rgba, v2f, v2i

__all__ = ['Loader', 'Dumper', 'load', 'dump', 'register']


class Loader(yaml.Loader):
    """``yaml.Loader`` with a registry of its own."""

    yaml_constructors = yaml.constructor.Constructor.yaml_constructors.copy()
    yaml_multi_constructors = \
        yaml.constructor.Constructor.yaml_multi_constructors.copy()


class Dumper(yaml.Dumper):
    """``yaml.Dumper`` with a registry of its own."""

    yaml_representers = yaml.representer.Representer.yaml_representers.copy()
    yaml_multi_representers = \
        yaml.representer.Representer.yaml_multi_representers.copy()


def register(data_type, tag, represent, construct):
    """Dump instances of *data_type* through ``represent(dumper, data)``
    and load *tag* through ``construct(loader, node)``, on this module's
    classes only."""
    Dumper.add_representer(data_type, represent)
    Loader.add_constructor(tag, construct)


def load(stream):
    """A document from *stream* (a string or a file), in the port's
    classes."""
    return yaml.load(stream, Loader=Loader)


def dump(data, stream=None, **kw):
    """*data* as a YAML document (a string when *stream* is None); the
    keywords are ``yaml.dump``'s."""
    return yaml.dump(data, stream, Dumper=Dumper, **kw)


# --- base types (the reference's project files) -----------------------------

def _rational_represent(dumper, data):
    return dumper.represent_sequence('!rational',
                                     [data.numerator, data.denominator])


def _rational_construct(loader, node):
    return fractions.Fraction(*loader.construct_sequence(node))


def _v2i_represent(dumper, data):
    return dumper.represent_scalar('!v2i',
                                   '({0}, {1})'.format(data.x, data.y))


def _v2i_construct(loader, node):
    x, y = loader.construct_scalar(node).strip()[1:-1].split(',')
    return v2i(int(x), int(y))


def _v2f_represent(dumper, data):
    return dumper.represent_scalar('!v2f',
                                   '({0!r}, {1!r})'.format(data.x, data.y))


def _v2f_construct(loader, node):
    x, y = loader.construct_scalar(node).strip()[1:-1].split(',')
    return v2f(float(x), float(y))


def _box_represent(tag):
    def represent(dumper, data):
        return dumper.represent_sequence(tag, [data.min, data.max])
    return represent


def _sequence_construct(cls):
    def construct(loader, node):
        return cls(*loader.construct_sequence(node))
    return construct


def _rgba_represent(dumper, data):
    return dumper.represent_sequence('!rgba', list(data))


register(fractions.Fraction, '!rational', _rational_represent,
         _rational_construct)
register(v2i, '!v2i', _v2i_represent, _v2i_construct)
register(v2f, '!v2f', _v2f_represent, _v2f_construct)
register(box2i, '!box2i', _box_represent('!box2i'), _sequence_construct(box2i))
register(box2f, '!box2f', _box_represent('!box2f'), _sequence_construct(box2f))
register(rgba, '!rgba', _rgba_represent, _sequence_construct(rgba))
