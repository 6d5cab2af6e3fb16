"""Synthetic token batches (port of `repro.data`)."""
