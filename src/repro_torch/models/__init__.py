"""Models of the port (``repro.models``): the SPLADE encoder and its layers."""
