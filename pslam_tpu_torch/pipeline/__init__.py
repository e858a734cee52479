"""Host orchestrator: tracking, local mapping and the system facade for the
points-only RGB-D slice."""
