"""Training: AdamW, the train step, the restartable loop and the straggler
monitor, the JAX package's ``training/`` on PyTorch."""
