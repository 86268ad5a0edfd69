"""The benchmark of the PyTorch and CUDA port (``stcat_tpu_torch``): see run.py."""
