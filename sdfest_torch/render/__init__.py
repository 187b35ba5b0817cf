"""Sphere-tracing renderer of the port: kernels, plain twins, autograd."""
from sdfest_torch.render.api import (  # noqa: F401
    render_depth,
    render_depth_with_pc_values,
    sample_sdf_masked_extrapolating,
)
