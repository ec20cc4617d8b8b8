"""The benchmark of vbr_tpu_torch: see README.md."""
