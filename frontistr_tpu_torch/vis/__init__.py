"""Visualization of the PyTorch port (mirrors frontistr_tpu/vis): PSR
surface and PVR volume pictures as BMP."""
