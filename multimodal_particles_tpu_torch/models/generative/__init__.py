"""generative of the PyTorch/CUDA port."""
