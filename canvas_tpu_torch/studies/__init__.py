"""The port's counterparts of the JAX package's TPU studies in
``scripts/`` (which stay the JAX reference), backed by the CUDA kernels
of ``canvas_tpu_torch.ops.study_ops``:

- ``fold_interior_study``: the solid fold in four forms (select masks,
  rank-1 float masks, per-tile inside/across, per-tile
  outside/inside/across), ``scripts/fold_interior_study.py``;
- ``fold_tile_study``: the solid fold over per-tile covering layers,
  ``scripts/fold_tile_study.py``;
- ``vpu_roofline``: the card's bandwidth and FMA rate, the roofline
  probe's fold, and what bounds the shipped ``solid_fold``,
  ``scripts/vpu_roofline.py``;
- ``capture_probe`` (the port's own, no TPU counterpart): which work on
  another thread invalidates a render program's CUDA graph capture;
  ``python -m canvas_tpu_torch.studies.capture_probe`` on a card;
- ``region_over_time`` (the port's own): ``cuda_ops.region_over`` held
  to the plain version and timed at config7's regions beside its byte
  floor, or an older checkout's kernel when that checkout comes first on
  ``PYTHONPATH``; ``python -m canvas_tpu_torch.studies.region_over_time``
  on a card.

Each runs as ``python -m canvas_tpu_torch.studies.<name> --check`` (each
kernel against its plain version on the card; ``--device cpu`` runs the
plain versions on the CPU instead) or ``--time`` (a card only). Both
raise without a card unless the CPU is asked for. They carry the
scripts' seeded input generators over and import neither ``scripts/``
nor JAX. The render path is unchanged: it keeps ``cuda_ops.solid_fold``.
"""

import torch

from canvas_tpu_torch import backend

__all__ = ['check_device', 'time_device', 'on_device', 'max_diff']


def check_device(device=None):
    """The device of a ``--check`` run: the card (``device=None``, raises
    without one, as ``backend.resolve_device``), or the CPU when the
    caller asks for it with ``device='cpu'`` (plain versions only)."""
    return backend.resolve_device(device)


def time_device():
    """The device of a ``--time`` run: a CUDA card, or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError('--time measures the CUDA kernels on a card, and '
                           'torch.cuda.is_available() is False')
    return torch.device('cuda')


def on_device(device, *arrays):
    """NumPy arrays as tensors on *device* (``backend.to_device``)."""
    return [backend.to_device(a, device) for a in arrays]


def max_diff(got, want):
    """Largest absolute difference between two tensors, or two sequences
    of tensors, as a float."""
    if isinstance(got, (tuple, list)):
        return max(max_diff(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())
