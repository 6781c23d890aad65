# Hand-written CUDA kernels for Hopper (sm_90a).  Each kernel has a package
# <name>/ with kernel.py (the ctypes wrapper that launches it and counts its
# launches), ref.py (its plain PyTorch version) and ops.py (the host-facing
# entry, which launches the kernel for CUDA tensors and takes the plain
# version for CPU tensors).  The CUDA sources live in csrc/ and build.py
# compiles them with nvcc at first use.
