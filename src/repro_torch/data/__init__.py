"""Synthetic corpora generated on device."""
