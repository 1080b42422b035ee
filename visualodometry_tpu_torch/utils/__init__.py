"""Offline host-side utilities: calibration, video ingest, profiling.

Pre-processing tools and measurement hooks, not part of the device
compute path. OpenCV is imported inside the functions that use it.
"""
