"""Training target assignment (port of ``trcnn/targets``)."""

from trcnn_torch.targets.anchor_targets import AnchorTargets, anchor_targets  # noqa: F401
from trcnn_torch.targets.proposal_targets import ProposalTargets, proposal_targets  # noqa: F401
