"""Logging and metrics (torch-free)."""
