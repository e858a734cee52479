"""Host orchestrator: tracking, local mapping, loop closing, relocalization
and the system facade.

The reference's 3-thread pipeline (System.cc:86-113) becomes a sequential
host loop launching device work; the host map is the only mutable state and
device work only sees snapshots of it."""

from pslam_tpu_torch.pipeline.system import SlamSystem  # noqa: F401
