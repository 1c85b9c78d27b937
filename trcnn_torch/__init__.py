"""trcnn_torch — the PyTorch / CUDA port of trcnn for NVIDIA Hopper.

It sits beside the JAX package ``trcnn`` and is held against it: the same
weights and inputs give the same discrete results (keep-sets, RoI bin
bounds, top-k order, sampled sets, detection classes) and float results
within stated tolerances.  It imports nothing of ``trcnn``: what it needs of
the framework-free modules (the config tree, the base anchors, the IEEE
division table) it keeps as its own copy.

Package map (mirrors ``trcnn``):

- :mod:`trcnn_torch.ops`     — anchors, box transforms and IoU, top-k,
                               greedy NMS, RoI max-pool (forward and
                               backward), the fused VGG stem and the
                               proposal layer.  NMS (K1), the RoI pool
                               forward (K2) and backward (K4) and the stem
                               (K3) launch hand-written CUDA kernels
                               (``csrc/``) on CUDA tensors and run their
                               plain PyTorch versions on CPU tensors.
- :mod:`trcnn_torch.targets` — anchor and proposal target assignment, with
                               the sampling uniforms as arguments.
- :mod:`trcnn_torch.models`  — VGG-16 trunk (frozen stem), RPN head, RoI
                               head (dropout in training), losses and the
                               Faster R-CNN composite (detect, postprocess,
                               losses).
- :mod:`trcnn_torch.train`   — the Caffe-order MomentumSGD, the train step
                               and the trainer with checkpoint/resume.
- :mod:`trcnn_torch.config`  — the port's copy of the config classes.
- :mod:`trcnn_torch.convert` — flax parameter tree and optax momentum trace
                               <-> ``state_dict`` and momentum buffers.
- :mod:`trcnn_torch.entry`   — the full VOC detect graph (``entry``) and
                               training step (``train_entry``) on one
                               device, the card unless asked for the CPU.
"""

__version__ = "0.2.0"
