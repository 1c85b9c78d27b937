"""trcnn_torch — the PyTorch / CUDA port of trcnn for NVIDIA Hopper.

It sits beside the JAX package ``trcnn`` and is held against it: the same
weights and inputs give the same discrete results (keep-sets, RoI bin
bounds, top-k order, sampled sets, detection classes) and float results
within stated tolerances.  It imports nothing of ``trcnn``: what it needs of
the framework-free modules (the config tree, the base anchors, the IEEE
division table, the weight importers, the data layer, the AP code) it
keeps as its own copy.

Package map (mirrors ``trcnn``):

- :mod:`trcnn_torch.ops`     — anchors, box transforms and IoU, top-k,
                               greedy NMS, RoI max-pool (forward and
                               backward), the fused VGG stem and the
                               proposal layer.  NMS (K1), the RoI pool
                               forward (K2) and backward (K4) and the stem
                               (K3) launch hand-written CUDA kernels
                               (``csrc/``) on CUDA tensors and run their
                               plain PyTorch versions on CPU tensors;
                               ``ops.native`` binds the C++ host ops of
                               ``native/`` (built with g++ at first use).
- :mod:`trcnn_torch.targets` — anchor and proposal target assignment, with
                               the sampling uniforms as arguments.
- :mod:`trcnn_torch.models`  — VGG-16 trunk (frozen stem) and its fc RoI
                               head (dropout in training), the
                               ResNet-101-C4 trunk and res5 RoI head
                               (FrozenBN), RPN head, losses and the Faster
                               R-CNN composite (detect, postprocess,
                               losses) over either backbone.
- :mod:`trcnn_torch.train`   — the Caffe-order MomentumSGD, the train step
                               (data-parallel over a process group), K
                               steps per call, and the trainer with
                               checkpoint/resume, upload lookahead, the
                               evaluator hook, hooks and a metric writer.
- :mod:`trcnn_torch.data`    — preprocessing (the port's own resize,
                               bit-equal to OpenCV's generic bilinear, and
                               JAX's resize on the card),
                               image files through cv2 or PIL, the VOC,
                               synthetic and concatenated datasets and the
                               batching loader.
- :mod:`trcnn_torch.eval`    — VOC and COCO AP, the devkit detection files
                               and the evaluator (sharded over a process
                               group).
- :mod:`trcnn_torch.parallel` — data parallelism over ``torch.distributed``:
                               ``initialize`` (the JAX arguments or the
                               environment), the ranks' collectives and
                               the host gather of the sharded evaluator.
- :mod:`trcnn_torch.cli`     — ``forward``, ``evaluate``, ``train``,
                               ``convert``, ``download`` and ``parity``,
                               run as ``python -m trcnn_torch.cli.<name>``.
- :mod:`trcnn_torch.utils`   — timing, ``torch.profiler`` traces and their
                               device-time breakdown, the NaN debug mode.
- :mod:`trcnn_torch.config`  — the port's copy of the config classes.
- :mod:`trcnn_torch.convert` — flax parameter tree and optax momentum trace
                               <-> ``state_dict`` and momentum buffers.
- :mod:`trcnn_torch.convert_chainer`, :mod:`trcnn_torch.convert_caffemodel`,
  :mod:`trcnn_torch.convert_resnet` — Chainer npz (import and export),
                               caffemodel and ResNet-101 npz import into a
                               state_dict; :mod:`trcnn_torch.weights`
                               dispatches them.
- :mod:`trcnn_torch.entry`   — the full VOC detect graph (``entry``) and
                               training step (``train_entry``) on one
                               device, the card unless asked for the CPU,
                               for either backbone.
"""

__version__ = "0.3.0"
