"""Training data: SDF grids, generated views and batch loaders."""
