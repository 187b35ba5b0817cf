"""Geometry operations of the port (torch tensors, numpy for grids)."""
