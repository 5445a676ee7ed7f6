"""Measurement scripts for the port, each run as ``python -m
tomojax_torch.tools.<name>`` from the repository root."""
