"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions; ``LAUNCHES`` counts the launches each wrapper made."""
from repro_torch.kernels._build import LAUNCHES, build_all, reset_launches
