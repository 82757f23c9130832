"""The benchmark of gsattack_torch: see run.py."""
