"""Dataset IO: the synthetic RGB-D scene generator."""
