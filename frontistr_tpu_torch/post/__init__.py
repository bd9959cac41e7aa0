"""post layer of the PyTorch port (mirrors frontistr_tpu/post)."""
