"""Trainers of the shape VAE and the init network."""
