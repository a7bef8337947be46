"""The benchmark of ray_tpu_torch: one cell, one run, one result line."""
