"""Entry points of the port that measure it: `python -m gsattack_torch.scripts.<name>`."""
