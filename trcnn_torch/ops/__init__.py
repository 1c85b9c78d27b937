"""Detection ops of the port.  Import the submodules directly
(``trcnn_torch.ops.nms`` and so on), as the models do."""
