"""Measurement scripts of the port that run on an NVIDIA GPU."""
