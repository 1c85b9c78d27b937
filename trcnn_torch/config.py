"""Configuration: the JAX package's frozen-dataclass config tree, shared.

``trcnn/config.py`` holds only dataclasses and imports no JAX, so the port
uses it as it is rather than a copy.  This module is the port's one import
of ``trcnn``: everything else in ``trcnn_torch`` takes its config classes
from here.
"""

from trcnn.config import (AnchorConfig, FasterRCNNConfig, ProposalConfig,  # noqa: F401
                          voc_config)
