"""The port's user entry points, each the counterpart of a script of the
repository's ``scripts/`` (which stays the JAX package's), run as
``python -m canvas_tpu_torch.tools.<name>``:

- ``explain``: ``scripts/explain.py``: a project's render plan
  (``RenderPlanner.explain``), or the headline's with ``--demo``;
- ``decode_raw_image``: ``scripts/decode_raw_image.py``: DV planes made
  in Python through ``DVReconstructionFilter`` into a gamma45 PPM;
- ``write_raw_audio``: ``scripts/write_raw_audio.py``: a tone as float
  PCM Matroska (host only);
- ``demo_project``: ``scripts/demo_project.py``: media made, imported,
  edited, saved and reloaded as YAML, compiled and exported;
- ``play_demo``: ``scripts/play_demo.py``: a media file through the
  playback engine, headless, in Tk (``--tk``) or in GTK on broadway
  (``--gtk``);
- ``encode_x264_mkv``, ``encode_faac_mkv``, ``encode_x264_faac_mkv``,
  ``encode_video``: the scripts of the same names: H.264 and AAC in
  Matroska;
- ``audio_roundtrip``: ``scripts/test_audio.py`` (renamed so that no
  ``test_*`` module sits in the package): AAC in Matroska, decoded and
  held against its input.

Each takes the script's arguments, plus ``--device`` where it renders:
the card by default, raising without one; ``--device cpu`` (or
``CANVAS_FORCE_CPU`` set, as for the scripts) runs the kernels' plain
versions on the host. Each has ``main(argv=None)`` for a run inside
another process. They import nothing of JAX, the JAX package,
``bench``, ``benchmarks`` or ``scripts``.
"""

import contextlib
import os

from canvas_tpu_torch import backend

__all__ = ['add_device_argument', 'on_device']


def add_device_argument(parser):
    parser.add_argument(
        '--device', default=None,
        help="where to render: the card by default (raises without one), "
        "'cpu' for the kernels' plain versions on the host")


@contextlib.contextmanager
def on_device(device=None):
    """The device a tool renders on, and this thread's eager pulls pinned
    to it inside the block (``backend.force_backend``, in the thread's
    mode): *device* when given, the CPU where ``CANVAS_FORCE_CPU`` is
    set, else the card (``backend.resolve_device``, which raises without
    one)."""
    if device is None and os.environ.get('CANVAS_FORCE_CPU'):
        device = 'cpu'
    device = backend.resolve_device(device)
    with backend.force_backend(backend.get_backend(), device):
        yield device
