"""Weights, presets and device helpers of the port."""
