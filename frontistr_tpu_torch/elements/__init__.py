"""elements layer of the PyTorch port (mirrors frontistr_tpu/elements)."""
