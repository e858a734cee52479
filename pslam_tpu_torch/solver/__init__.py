"""Estimation core: robust LM for pose-only optimization and the Schur
local bundle adjustment."""
