"""Tidehunter on PyTorch and CUDA: the port of the ``repro`` package."""
