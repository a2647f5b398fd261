"""The benchmark of elodin_tpu_torch on the card (see README.md)."""
