"""optimizer_span_ms: host ms per training step of the port's own
``train_step.optimizer`` span (the global norm and the CaffeSGD update)."""

from bench_port import readers


def read(trace):
    return readers.host_span_ms(trace, "train", "train_step.optimizer")
