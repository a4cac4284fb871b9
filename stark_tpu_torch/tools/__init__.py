"""Diagnostic scripts of the port, run on demand on a CUDA card."""
