"""Partitioning of the PyTorch port (the host part of
frontistr_tpu/parallel): node-based overlapped domains and their
HECMW-DIST files."""
