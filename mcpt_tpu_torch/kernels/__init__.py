"""Kernels of the port: the megakernels' tables, plain PyTorch versions and
CUDA launch wrappers, the wavefront intersector's, and the wavefront
bounce's (`wavefront.py`, `wavefront_ref.py`)."""
