"""The debug mode (port of ``trcnn/utils/debug.py``): :func:`nan_debug`.

The JAX package's ``no_jit`` and ``pallas_interpret`` have no counterpart
(see :mod:`trcnn_torch.utils`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def nan_debug():
    """Autograd's anomaly mode with its NaN check: a backward function that
    returns a NaN raises, naming the forward operation that made it (whose
    stack trace is recorded).  It watches the backward only: a NaN made in
    a forward passes unseen until a backward meets it, where JAX's
    ``jax_debug_nans`` checks every operation's output.  The previous
    setting comes back on exit."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
