"""Drivers: one per kind of traffic (training, serving)."""
