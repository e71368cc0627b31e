"""architectures of the PyTorch/CUDA port."""
