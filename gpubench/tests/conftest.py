"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` from
the repository's root. Tests marked ``gpu`` need a CUDA device and skip
without one (the ``cuda`` fixture decides, at run time)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers', 'gpu: needs a CUDA device')


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')
