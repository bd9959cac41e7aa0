"""Node-to-surface contact (torch port of ``frontistr_tpu/contact``)."""
