"""The plain float32 PyTorch reference the benchmark judges the port by:
the networks (:mod:`.nets`), the discrete layers (:mod:`.boxes`) and the
training step (:mod:`.train`).  It imports neither the JAX package nor the
port."""
