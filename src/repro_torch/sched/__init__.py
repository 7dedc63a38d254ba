"""Demand-aware micro-batch scheduling for the BMP sweep."""
