"""Noisy digital circuit simulation (TEBD over compiled half-layers)."""
