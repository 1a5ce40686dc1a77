"""Measurement scripts for the port on a CUDA card (run with ``python3 -m``)."""
