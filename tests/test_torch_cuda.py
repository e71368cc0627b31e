"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card. Without one every test here skips. The card's machine has no JAX,
so run this file without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerance atol 1e-4 / rtol 1e-4: float32 on both sides, with sums in other
orders (fused multiply-adds, per-jet reductions); tokens may differ on at most
1% of real slots where a uniform falls within rounding of a CDF boundary.
"""

import pytest
import torch

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.data import gauss_noise_source_batch
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_forward_reference,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import (
    sampler_step,
    sampler_step_reference,
)

pytestmark = pytest.mark.cuda
ATOL = RTOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def packed_model(device, hidden=16, blocks=2, skip=True, head=True):
    config = MultimodalBridgeMatchingConfig()
    config.encoder.dim_hidden_local = config.encoder.dim_hidden_glob = hidden
    config.encoder.num_blocks = blocks
    config.encoder.skip_connection = skip
    config.encoder.add_discrete_head = head
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    model = model.to(device)
    # non-zero biases, so that a misplaced bias shows
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=torch.Generator(device=device).manual_seed(1))
    return pack_mbm_encoder_params(model.encoder, config)


def inputs(device, B, N, seed=2):
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = gauss_noise_source_batch(B, N, 3, 8, gen, device=device, num_empty=2)
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, batch.source_continuous, batch.source_discrete, batch.source_mask, gen


@pytest.mark.parametrize("hidden,blocks,N,skip,head", [
    (16, 2, 128, True, True),
    (32, 1, 37, False, True),
    (64, 4, 16, True, False),
])
def test_epic_forward_matches_plain(device, hidden, blocks, N, skip, head):
    packed = packed_model(device, hidden, blocks, skip, head)
    t, x, k, mask, _ = inputs(device, 64, N)
    before = epic_forward.launches
    got = epic_forward(packed, t, x, k, mask)
    torch.cuda.synchronize()
    assert epic_forward.launches == before + 1
    torch.testing.assert_close(got, epic_forward_reference(packed, t, x, k, mask),
                               atol=ATOL, rtol=RTOL)
    assert (got[-2:, :, :3] == 0).all()  # empty jets


@pytest.mark.parametrize("t", [0.0101, 0.5, 1.0 - 1e-4])
def test_sampler_step_matches_plain(device, t):
    packed = packed_model(device)
    _, x, k, mask, gen = inputs(device, 256, 128)
    k = k.to(torch.int32)
    u = torch.rand((2, 256, 128), generator=gen, device=device)
    x_new, k_new = sampler_step(packed, x, k, mask, u, t, 0.0101, gamma=0.125)
    torch.cuda.synchronize()
    x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, t, 0.0101, gamma=0.125)
    torch.testing.assert_close(x_new, x_ref, atol=ATOL, rtol=RTOL)
    real = mask[..., 0] > 0
    mismatch = ((k_new != k_ref)[..., 0] & real).sum().item() / real.sum().item()
    assert mismatch <= 0.01
    assert k_new.dtype == torch.int32 and (k_new[~real] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    packed = packed_model(device)
    t, x, k, mask, _ = inputs(device, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        epic_forward(packed, t, x.transpose(0, 1).contiguous().transpose(0, 1), k, mask)
    with pytest.raises(TypeError, match="integer"):
        epic_forward(packed, t, x, k.float(), mask)
    with pytest.raises(ValueError, match="outside"):
        big = inputs(device, 2, 300)
        epic_forward(packed, *big[:4])
    with pytest.raises(ValueError, match="u must be"):
        sampler_step(packed, x, k, mask, torch.rand((2, 8, 31), device=device), 0.5, 0.01,
                     gamma=0.125)
