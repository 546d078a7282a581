"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``); ``run.py``
runs one cell."""
