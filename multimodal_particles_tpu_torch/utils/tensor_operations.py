"""Masked-tensor helpers (multimodal_particles_tpu/utils/tensor_operations.py:11-66):
centre-of-mass removal over a node mask, prefix masks from dimension
counts, masked Gaussian draws and the host-side mask assertions. The two
samplers take a `torch.Generator` where the JAX functions take a key."""

import numpy as np
import torch


def remove_mean(x):
    return x - x.mean(dim=1, keepdim=True)


def remove_mean_with_mask(x, node_mask):
    n = node_mask.sum(dim=1, keepdim=True)
    mean = x.sum(dim=1, keepdim=True) / torch.clamp(n, min=1.0)
    return x - mean * node_mask


def create_and_apply_mask_3(x, new_dims):
    """Zero rows >= new_dims of (B, N, F) tensors; returns (masked, mask)."""
    rows = torch.arange(x.shape[1], device=x.device)
    mask = (rows[None, :, None] < new_dims[:, None, None]).to(x.dtype).expand(x.shape)
    return x * mask, mask


def create_and_apply_mask_2(x, new_dims):
    """Zero columns >= new_dims of (B, N) tensors; returns (masked, mask)."""
    cols = torch.arange(x.shape[1], device=x.device)
    mask = (cols[None, :] < new_dims[:, None]).to(x.dtype)
    return x * mask, mask


def sample_gaussian_with_mask(generator, size, node_mask):
    return torch.randn(size, generator=generator, device=node_mask.device) * node_mask


def sample_center_gravity_zero_gaussian_with_mask(generator, size, node_mask):
    if len(size) != 3:
        raise ValueError(f"size must be (B, N, F), got {tuple(size)}")
    x = torch.randn(size, generator=generator, device=node_mask.device) * node_mask
    return remove_mean_with_mask(x, node_mask)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_correctly_masked(variable, node_mask, atol=1e-4):
    err = np.abs(_np(variable) * (1 - _np(node_mask))).max()
    assert err < atol, f"Variables not masked properly ({err})."


def assert_mean_zero_with_mask(x, node_mask, eps=1e-10):
    assert_correctly_masked(x, node_mask)
    x = _np(x)
    largest = np.abs(x).max()
    error = np.abs(x.sum(axis=1, keepdims=True)).max()
    rel_error = error / (largest + eps)
    assert rel_error < 1e-2, f"Mean is not zero, relative_error {rel_error}"


def check_mask_correct(variables, node_mask):
    for variable in variables:
        if len(variable) > 0:
            assert_correctly_masked(variable, node_mask)
