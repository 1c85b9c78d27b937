"""Utilities: timing and profiling harnesses, and the debug mode (port of
``trcnn/utils``).

The JAX package's ``no_jit`` and ``pallas_interpret`` have no counterpart
here.  Nothing in the port is jitted, so every op already runs eagerly
and Python's debuggers see it.  Forcing the plain versions of the kernels
on the card, as ``pallas_interpret`` forces Pallas through its
interpreter, is the fallback this port refuses: a wrapper launches its
kernel on a CUDA tensor or raises, and a plain version runs only for CPU
tensors (run on the CPU to take the plain versions).
"""

from trcnn_torch.utils.debug import nan_debug
from trcnn_torch.utils.profiling import device_sync, op_time_breakdown, time_fn, trace_to

__all__ = ["device_sync", "time_fn", "trace_to", "op_time_breakdown", "nan_debug"]
