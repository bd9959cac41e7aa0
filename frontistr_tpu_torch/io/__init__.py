"""io layer of the PyTorch port (mirrors frontistr_tpu/io)."""
