"""trcnn_torch — the PyTorch / CUDA port of trcnn for NVIDIA Hopper.

It sits beside the JAX package ``trcnn`` and is held against it: the same
weights and inputs give the same discrete results (keep-sets, RoI bin
bounds, top-k order, detection classes) and float results within stated
tolerances.  It shares the frozen-dataclass config tree ``trcnn.config``
(through :mod:`trcnn_torch.config`) and imports nothing else of ``trcnn``
(``trcnn.ops`` and ``trcnn.models`` pull in JAX).

Package map (mirrors ``trcnn``):

- :mod:`trcnn_torch.ops`     — anchors, box transforms, top-k, greedy NMS,
                               RoI max-pool, the fused VGG stem and the
                               proposal layer.  NMS, RoI pool and the stem
                               launch hand-written CUDA kernels
                               (``csrc/``) on CUDA tensors and run their
                               plain PyTorch versions on CPU tensors.
- :mod:`trcnn_torch.models`  — VGG-16 trunk, RPN head, RoI head and the
                               Faster R-CNN composite (detect, postprocess).
- :mod:`trcnn_torch.config`  — the config classes, shared with ``trcnn``.
- :mod:`trcnn_torch.convert` — flax parameter tree <-> ``state_dict``.
- :mod:`trcnn_torch.entry`   — the full VOC detect graph on one device.
"""

__version__ = "0.1.0"
