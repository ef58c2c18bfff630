"""The benchmark of the PyTorch port (see bench/run.py)."""
