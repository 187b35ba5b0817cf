"""Estimation pipeline of the port."""
