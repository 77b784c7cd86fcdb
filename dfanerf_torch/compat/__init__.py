"""Conversion of the reference package's parameters into the port's modules,
reference checkpoints, and the landmark export (landmark_export)."""
