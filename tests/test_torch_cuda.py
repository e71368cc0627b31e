"""The hand-written CUDA kernels (K1 forward, K2 sampler step, K3 backward,
the wide pair K4 forward / K5 backward at hidden 128, K6, the absorbing
family's survival head, with K1's hidden output and 56-wide discrete head, K7,
the transdimensional family's gsdm stack, with K1's folded Linear-discrete
input, K4 as the `--scaled` absorbing and transdimensional trunks call it, K7 at
input widths above 128, and K8, the attention core) against their plain
PyTorch versions, on a CUDA card. Without one every test
here skips. The card's machine has no JAX, so run this file without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerance atol 1e-4 / rtol 1e-4: float32 on both sides, with sums in other
orders (fused multiply-adds, per-jet reductions); tokens may differ on at most
1% of real slots where a uniform falls within rounding of a CDF boundary.
K3's weight gradients are held per leaf: |err| ≤ 1e-4·max|ref leaf| +
1e-3·|ref| (sums over all particles of a batch, in another order), with no
cotangent on jets that `near_kink_jets` flags. K4 is held per particle
(|err| ≤ 1e-4 + 1e-4·max|ref| over the particle's 11 outputs: at hidden 128
the outputs are large sums of terms that cancel), K5 per leaf as K3. K6's
logits are held elementwise at rtol = atol = 2e-4, the JAX kernel's own test's
tolerance (tests/test_ops/test_survival_pallas.py:86-88); K7's hidden state
likewise (tests/test_ops/test_gsdm_stack_pallas.py:72). K8's output is held
at atol 2e-5, the JAX kernel's own test's (tests/test_ops/test_attention_pallas.py:26).
Every kernel runs its products on the tensor cores under the 3×TF32 split;
K8 is held at every head width it takes (32, 64, 128 channels), K4's four
template instances at N on both sides of their 16-row and 64-row edges, K6
and K7 at every head width and N on both sides of the same edges, K1 and K2
at N from 1 to 256 (K1 per particle past N = 128, where no float32
evaluation holds the elementwise form), K3 at N from 1 to 256 at hidden 16,
32 and 64, with skip and head on and off, at B from 0 to 8192 and on empty
jets, its rerun of the forward held to K1's bits on the same buffer. K4 and K5
are also held on jets of 129 to 256 slots (two row blocks a jet), K7 at the
scaled stacks' input widths past 128 slots. K1, K2 and K3 are also held at
hidden widths that the packings zero-pad to an instance (8, 20, 24, 40, 56;
48 its own instance) and on jets of 257 to 512 slots (a cluster of two row
blocks a jet), K3 there also on sparse masks whose held jets reach past slot
256; at hidden 72 and at N = 513 the wrappers raise and the C entry points
return cudaErrorInvalidValue.
"""

import copy
import dataclasses
import itertools

import pytest
import torch

from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data import MultimodalDatabatch, gauss_noise_source_batch
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import (
    init_absorbing_parameters,
    init_mbm_parameters,
    init_transdimensional_parameters,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
    StructuredState,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    EpicDims,
    epic_forward,
    epic_forward_reference,
    flat_views,
    narrow_buffer,
    narrow_buffer_layout,
    pack_encoder,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (
    gsdm_stack,
    gsdm_stack_reference,
    stack_time_embeddings,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward,
    epic_backward_reference,
    epic_train_forward,
    near_kink_jets,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    epic_forward_wide,
    pack_wide_encoder_params,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import (
    pack_sampler_params,
    sampler_step,
    sampler_step_reference,
)
from multimodal_particles_tpu_torch.ops.survival_cuda import (
    project_time_embeddings,
    survival_head,
    survival_head_reference,
)

pytestmark = pytest.mark.cuda
ATOL = RTOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def packed_model(device, hidden=16, blocks=2, skip=True, head=True, wide=False, sampler=False,
                 **encoder):
    """A seeded MBM encoder packed for the narrow kernels (with the buffer of
    the forward kernel and the backward kernel, `with_narrow_buffer`), with
    `sampler` for the sampler step
    (`pack_sampler_params`), or with `wide` for the wide ones; `encoder`
    overrides encoder fields."""
    config = MultimodalBridgeMatchingConfig()
    config.encoder.dim_hidden_local = config.encoder.dim_hidden_glob = hidden
    if wide:  # every width 128, the wide kernels' layout
        e = config.encoder
        e.dim_emb_time = e.dim_emb_features_continuous = e.dim_emb_features_discrete = hidden
    for name, value in encoder.items():
        setattr(config.encoder, name, value)
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
    if wide:
        return pack_wide_encoder_params(model.encoder, config)
    if sampler:
        return pack_sampler_params(model.encoder, config)
    return with_narrow_buffer(pack_mbm_encoder_params(model.encoder, config))


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
    packed = packed_model(device, sampler=True)
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


K2_N = [1, 15, 16, 17, 31, 32, 33, 100, 128, 129, 256]


def sampler_case(device, hidden, N, t, B=133, **encoder):
    """K2 against its plain version at (hidden, N, t): B jets (not a multiple
    of any grid), the last two empty; x' within atol = rtol = 1e-4, tokens
    differing on at most 1% of real slots, the same bits on a repeat."""
    packed = packed_model(device, hidden, blocks=2, sampler=True, **encoder)
    _, x, k, mask, gen = inputs(device, B, N)
    k = k.to(torch.int32)
    u = torch.rand((2, B, N), generator=gen, device=device)
    before = sampler_step.launches
    x_new, k_new = sampler_step(packed, x, k, mask, u, t, 0.0101, gamma=0.125)
    x_again, k_again = sampler_step(packed, x, k, mask, u, t, 0.0101, gamma=0.125)
    torch.cuda.synchronize()
    assert sampler_step.launches == before + 2
    x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, t, 0.0101, gamma=0.125)
    torch.testing.assert_close(x_new, x_ref, atol=ATOL, rtol=RTOL)
    real = mask[..., 0] > 0
    mismatch = ((k_new != k_ref)[..., 0] & real).sum().item() / max(real.sum().item(), 1)
    assert mismatch <= 0.01
    assert (k_new[~real] == 0).all() and (x_new[-2:] == 0).all()
    assert torch.equal(x_new, x_again) and torch.equal(k_new, k_again)


@pytest.mark.parametrize("N", K2_N)
@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_sampler_step_tensor_cores_across_n(device, hidden, N):
    sampler_case(device, hidden, N, 0.5)


@pytest.mark.parametrize("t", [0.0101, 0.5, 1.0 - 1e-4])
@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_sampler_step_tensor_cores_at_every_time(device, hidden, t):
    sampler_case(device, hidden, 128, t, B=1024)


@pytest.mark.parametrize("hidden,glob,temb", [(16, 96, 80), (16, 200, 16), (64, 130, 100)])
def test_sampler_step_with_per_jet_vectors_wider_than_64(device, hidden, glob, temb):
    """The global vector and the time embedding wider than a warp's two
    registers a lane (the kernel keeps them in shared memory, the global
    MLP's outputs 64 columns at a time)."""
    sampler_case(device, hidden, 128, 0.5, dim_hidden_glob=glob, dim_emb_time=temb)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    packed = packed_model(device, sampler=True)
    t, x, k, mask, _ = inputs(device, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        epic_forward(packed, t, x.transpose(0, 1).contiguous().transpose(0, 1), k, mask)
    with pytest.raises(TypeError, match="integer"):
        epic_forward(packed, t, x, k.float(), mask)
    with pytest.raises(ValueError, match="outside"):
        big = inputs(device, 2, 513)  # past the two row blocks' 512 slots
        epic_forward(packed, *big[:4])
    with pytest.raises(ValueError, match="u must be"):
        sampler_step(packed, x, k, mask, torch.rand((2, 8, 31), device=device), 0.5, 0.01,
                     gamma=0.125)


@pytest.mark.parametrize("hidden,blocks", [(16, 2), (32, 3), (64, 4)])
@pytest.mark.parametrize("skip", [True, False])
def test_epic_backward_matches_plain_autograd(device, hidden, blocks, skip):
    packed = packed_model(device, hidden, blocks, skip)
    t, x, k, mask, gen = inputs(device, 64, 128)
    # no cotangent on jets where float32 rounding may flip a derivative branch
    near = near_kink_jets(packed, t, x, k, mask)
    g = torch.randn((64, 128, 11), generator=gen, device=device) * (~near)[:, None, None]
    before = epic_backward.launches
    got = epic_backward(packed, t, x, k, mask, g)
    torch.cuda.synchronize()
    assert epic_backward.launches == before + 1
    ref = epic_backward_reference(packed, t, x, k, mask, g)
    assert torch.isfinite(got).all()
    for name, a in flat_views(got, packed.dims).items():
        r = flat_views(ref, packed.dims)[name]
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name
    # the backward is deterministic: the same inputs give the same bits
    assert torch.equal(got, epic_backward(packed, t, x, k, mask, g))


def test_epic_train_forward_goes_through_both_kernels(device):
    config = MultimodalBridgeMatchingConfig()
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    model = model.to(device)
    t, x, k, mask, _ = inputs(device, 32, 128)
    fwd, bwd = epic_forward.launches, epic_backward.launches
    packed = pack_mbm_encoder_params(model.encoder, config, differentiable=True)
    (epic_train_forward(packed, t, x, k, mask) ** 2).sum().backward()
    assert (epic_forward.launches, epic_backward.launches) == (fwd + 1, bwd + 1)
    for name, p in model.encoder.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(device):
    packed = packed_model(device)
    t, x, k, mask, gen = inputs(device, 8, 32)
    g = torch.randn((8, 32, 11), generator=gen, device=device)
    with pytest.raises(ValueError, match="is on"):
        epic_backward(packed, t, x, k, mask, g.cpu())
    with pytest.raises(ValueError, match="is on"):
        epic_backward(packed, t.cpu(), x, k, mask, g)
    with pytest.raises(ValueError, match="contiguous"):
        epic_backward(packed, t, x, k, mask, g.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError, match="float32"):
        epic_backward(packed, t, x, k, mask, g.double())
    with pytest.raises(ValueError, match="g must be"):
        epic_backward(packed, t, x, k, mask, g[..., :10].contiguous())


# ------------------------------- K3 on the tensor cores, every shape it takes


K3_N = [1, 17, 64, 65, 128, 129, 256]


def k3_inputs(device, B, N, seed=6):
    """t, x, k, mask: random non-prefix masks, the last two jets empty."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.7).float()
    mask[max(B - 2, 0):] = 0.0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, x, k, mask, gen


def hold_k3(packed, t, x, k, mask, gen):
    """K3 against plain autograd per packed leaf (|err| ≤ 1e-4·max|ref leaf| +
    1e-3·|ref|), no cotangent on the jets `near_kink_jets` flags; the same
    bits on a repeat; its rerun of the forward K1's bits on the same buffer."""
    B, N = x.shape[:2]
    near = near_kink_jets(packed, t, x, k, mask)
    g = torch.randn((B, N, 11), generator=gen, device=x.device) * (~near)[:, None, None]
    rerun = torch.empty((B, N, 11), device=x.device)
    before = epic_backward.launches
    got = epic_backward(packed, t, x, k, mask, g, rerun_out=rerun)
    again = epic_backward(packed, t, x, k, mask, g)
    torch.cuda.synchronize()
    assert epic_backward.launches == before + 2
    ref = epic_backward_reference(packed, t, x, k, mask, g)
    assert torch.isfinite(got).all()
    for name, a in flat_views(got, packed.dims).items():
        r = flat_views(ref, packed.dims)[name]
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name
    assert torch.equal(got, again)
    assert torch.equal(rerun, epic_forward(packed, t, x, k, mask))


@pytest.mark.parametrize("N", K3_N)
@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_epic_backward_tensor_cores_across_n(device, hidden, N):
    """Jets of 1 to 256 slots, on both sides of a warp's 16 and of 64 and
    128, at B=133 (not a multiple of any grid)."""
    hold_k3(packed_model(device, hidden, {16: 2, 32: 3, 64: 4}[hidden]), *k3_inputs(device, 133, N))


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("head", [True, False], ids=["head", "no_head"])
def test_epic_backward_tensor_cores_skip_and_head(device, skip, head):
    hold_k3(packed_model(device, 16, 2, skip, head), *k3_inputs(device, 133, 109))


@pytest.mark.parametrize("B", [1, 133, 8192])
def test_epic_backward_tensor_cores_across_b(device, B):
    """One jet (and so one block), a few jets a block, and the training
    batch, where each block walks ~30 jets through its partial sums."""
    hold_k3(packed_model(device), *k3_inputs(device, B, 128))


def test_epic_backward_takes_no_jets_and_empty_jets(device):
    """B=0 launches nothing and gives zeros; jets with every slot masked
    reach the weights only through the discrete head, as plain autograd
    has it."""
    packed = packed_model(device)
    t, x, k, mask, gen = k3_inputs(device, 0, 128)
    before = epic_backward.launches
    out = epic_backward(packed, t, x, k, mask, torch.zeros((0, 128, 11), device=device))
    assert epic_backward.launches == before and (out == 0).all()
    t, x, k, mask, gen = k3_inputs(device, 6, 40)
    mask.zero_()
    hold_k3(packed, t, x, k, mask, gen)


def test_epic_backward_refuses_a_packing_without_its_buffers(device):
    """K3 reads the buffer's K1 entries and its transposed fragments after
    them: a packing with no buffer, or with K1's entries alone, or a short
    one is refused."""
    packed = packed_model(device)
    t, x, k, mask, gen = k3_inputs(device, 4, 32)
    g = torch.randn((4, 32, 11), generator=gen, device=device)
    with pytest.raises(ValueError, match="tensor-core buffer"):
        epic_backward(dataclasses.replace(packed, tensor_core=None), t, x, k, mask, g)
    (buf,) = packed.tensor_core
    k1_entries = sum(n for name, n in itertools.takewhile(
        lambda entry: entry[0] != "outT", narrow_buffer_layout(packed.dims)))
    for cut in (buf[:k1_entries], buf[:-4]):
        short = dataclasses.replace(packed, tensor_core=(cut.clone(),))
        with pytest.raises(ValueError, match="buffer holds"):
            epic_backward(short, t, x, k, mask, g)


# ------------------------------- K1 on the tensor cores, every shape it takes


K1_N = [1, 15, 16, 17, 31, 32, 33, 100, 109, 128, 129, 256]


def k1_packed(device, hidden=16, blocks=2, head_width=8, fold=False, glob=None, temb=None):
    """A seeded narrow packing with the buffer of K1: MBM's encoder, or with
    `fold` the transdimensional trunk's (the Linear-discrete input); a
    discrete head of `head_width` hidden units (Linear-SELU-Linear, seeded),
    None for no head; `glob`, `temb` the global and time widths."""
    config = TransdimensionalEpicConfig() if fold else MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.dim_hidden_local = hidden
    e.dim_hidden_glob = hidden if glob is None else glob
    if temb is not None:
        e.dim_emb_time = temb
    e.num_blocks = blocks
    if fold:
        net = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), 0).network
    else:
        net = init_mbm_parameters(MultiModalBridgeMatching(config), 0).encoder
    gen = torch.Generator().manual_seed(1)
    head = None
    with torch.no_grad():
        if head_width is not None:
            head = torch.nn.Sequential(torch.nn.Linear(8, head_width), torch.nn.SELU(),
                                       torch.nn.Linear(head_width, 8))
            for p in head.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.1))
        for p in net.parameters():  # non-zero biases, so that a misplaced vector shows
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    d = EpicDims.from_config(config, head_hidden=8 if head_width is None else head_width,
                             add_discrete_head=head_width is not None, fold_discrete=fold)
    net, head = net.to(device), head.to(device) if head is not None else None
    return with_narrow_buffer(pack_encoder(net, d, head=head))


def k1_inputs(device, packed, B, N, seed=4):
    """t, x, k (tokens, or with a folded packing noisy one-hot channel values,
    8-byte aligned), mask: random non-prefix masks, the last two jets empty."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.7).float()
    mask[-2:] = 0.0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    tokens = torch.randint(0, 8, (B, N, 1), generator=gen, device=device)
    if packed.dims.fold_discrete:
        k = torch.nn.functional.one_hot(tokens[..., 0], 8).float()
        k = (k + 0.3 * torch.randn(k.shape, generator=gen, device=device)) * mask
    else:
        k = tokens * mask.long()
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, x, k, mask


def k1_case(device, packed, N, B=133, per_particle=False):
    """K1 against its plain version with the hidden output, at B jets (not a
    multiple of any grid): the 11 outputs and the hidden state within K1's
    gate (elementwise atol = rtol = 1e-4; per particle at hidden 64, as
    chip_smoke.py holds it, and at N over 128), the empty jets' continuous
    outputs 0, the same bits on a repeat and without the hidden output.

    Past N = 128 no float32 evaluation holds the elementwise form: at N = 256
    (jets of up to 256 particles, whose pooled sums feed the global MLP) the
    plain version misses its own float64 evaluation, and the FFMA kernel
    before the tensor cores missed the plain version, while every one of
    them stays far inside the per-particle form
    (`python3 scripts/k1_long_jets.py --other DIR`; PERF.md §6)."""
    per_particle = per_particle or N > 128
    t, x, k, mask = k1_inputs(device, packed, B, N)
    before = epic_forward.launches
    out, hid = epic_forward(packed, t, x, k, mask, output_hidden_local=True)
    again = epic_forward(packed, t, x, k, mask)
    torch.cuda.synchronize()
    assert epic_forward.launches == before + 2
    ref_out, ref_hid = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=True)
    assert tuple(out.shape) == (B, N, 11) and tuple(hid.shape) == (B, N, packed.dims.hidden_local)
    for got, ref in ((out, ref_out), (hid, ref_hid)):
        assert torch.isfinite(got).all()
        if per_particle:
            close_per_particle(got, ref)
        else:
            torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    assert (out[-2:, :, :3] == 0).all()
    assert torch.equal(out, again)


@pytest.mark.parametrize("N", K1_N)
@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_epic_forward_tensor_cores_across_n(device, hidden, N):
    k1_case(device, k1_packed(device, hidden), N, per_particle=hidden == 64)


@pytest.mark.parametrize("head_width", [1, 8, 56, None], ids=["head1", "head8", "head56", "no_head"])
@pytest.mark.parametrize("fold", [False, True], ids=["tokens", "folded"])
def test_epic_forward_tensor_cores_every_head_width(device, head_width, fold):
    k1_case(device, k1_packed(device, head_width=head_width, fold=fold), 109)


@pytest.mark.parametrize("hidden,glob,temb", [(16, 96, 80), (16, 200, 16), (64, 130, 100), (32, 19, 7)])
def test_epic_forward_with_per_jet_vectors_wider_than_64(device, hidden, glob, temb):
    """The global vector and the time embedding wider than a warp's two
    registers a lane, and an odd time width (a zero column)."""
    k1_case(device, k1_packed(device, hidden, glob=glob, temb=temb), 128, per_particle=hidden == 64)


@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_epic_forward_folded_input_across_n(device, hidden):
    packed = k1_packed(device, hidden, head_width=None, fold=True)
    for N in (1, 17, 128, 256):
        k1_case(device, packed, N, B=67, per_particle=hidden == 64)


def test_epic_forward_takes_no_jets_and_empty_jets(device):
    packed = k1_packed(device)
    t, x, k, mask = k1_inputs(device, packed, 0, 128)
    out, hid = epic_forward(packed, t, x, k, mask, output_hidden_local=True)
    assert tuple(out.shape) == (0, 128, 11) and tuple(hid.shape) == (0, 128, 16)
    t, x, k, mask = k1_inputs(device, packed, 5, 128)
    mask.zero_()
    out = epic_forward(packed, t, x, k, mask)
    ref = epic_forward_reference(packed, t, x, k, mask)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    assert (out[..., :3] == 0).all()


def test_epic_forward_refuses_a_packing_without_its_buffer(device):
    packed = k1_packed(device)
    t, x, k, mask = k1_inputs(device, packed, 4, 32)
    stripped = dataclasses.replace(packed, tensor_core=None)
    with pytest.raises(ValueError, match="tensor-core buffer"):
        epic_forward(stripped, t, x, k, mask)
    short = dataclasses.replace(packed, tensor_core=(packed.tensor_core[0][:-4].clone(),))
    with pytest.raises(ValueError, match="buffer holds"):
        epic_forward(short, t, x, k, mask)


@pytest.mark.parametrize("hidden,blocks", [(16, 2), (32, 3), (64, 4)])
def test_epic_train_forward_loss_and_gradient_match_plain_autograd(device, hidden, blocks):
    """The training forward: the loss from K1 (its buffer made from the
    non-leaf weights at the call) within K1's gate, and d(flat) from K3
    within K3's per-leaf gate, off the jets near a kink."""
    packed = packed_model(device, hidden, blocks)
    t, x, k, mask, gen = inputs(device, 64, 128)
    near = near_kink_jets(packed, t, x, k, mask)
    g = torch.randn((64, 128, 11), generator=gen, device=device) * (~near)[:, None, None]
    flat = packed.flat.detach().clone().requires_grad_(True)
    leaf = dataclasses.replace(packed.rebind(flat * 1.0), tensor_core=None)  # a non-leaf, no buffer
    before = epic_forward.launches, epic_backward.launches
    out = epic_train_forward(leaf, t, x, k, mask)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (epic_forward.launches, epic_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = epic_forward_reference(packed, t, x, k, mask)
    if hidden == 64:
        close_per_particle(out.detach(), ref)
    else:
        torch.testing.assert_close(out.detach(), ref, atol=ATOL, rtol=RTOL)
    d_ref = epic_backward_reference(packed, t, x, k, mask, g)
    for name, a in flat_views(flat.grad, packed.dims).items():
        r = flat_views(d_ref, packed.dims)[name]
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name
    # the buffer the step made is the packing's own
    assert torch.equal(narrow_buffer(flat, packed.dims), packed.tensor_core[0])


# ------------------------------------------------------- the wide pair, K4/K5


@pytest.mark.parametrize("blocks,N,skip,head", [
    (2, 128, True, True),
    (1, 37, False, True),
    (6, 128, True, False),
    (1, 8, False, False),
])
def test_epic_forward_wide_matches_plain(device, blocks, N, skip, head):
    packed = packed_model(device, 128, blocks, skip, head, wide=True)
    t, x, k, mask, _ = inputs(device, 48, N)
    before = epic_forward_wide.launches
    got = epic_forward_wide(packed, t, x, k, mask)
    torch.cuda.synchronize()
    assert epic_forward_wide.launches == before + 1
    ref = epic_forward_reference(packed, t, x, k, mask)
    bound = ATOL + RTOL * ref.abs().amax(dim=-1, keepdim=True)
    assert ((got - ref).abs() <= bound).all()
    assert (got[-2:, :, :3] == 0).all()  # empty jets


@pytest.mark.parametrize("blocks,N", [(2, 128), (3, 50), (6, 128)])
@pytest.mark.parametrize("skip,head", [(True, True), (False, False)])
def test_epic_backward_wide_matches_plain_autograd(device, blocks, N, skip, head):
    packed = packed_model(device, 128, blocks, skip, head, wide=True)
    B = 300  # more jets than SMs: some blocks of the persistent grid sum several
    t, x, k, mask, gen = inputs(device, B, N)
    near = near_kink_jets(packed, t, x, k, mask)
    g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
    before = epic_backward_wide.launches
    got = epic_backward_wide(packed, t, x, k, mask, g)
    torch.cuda.synchronize()
    assert epic_backward_wide.launches == before + 1
    ref = epic_backward_reference(packed, t, x, k, mask, g)
    assert torch.isfinite(got).all()
    refs = packed.rebind(ref).tensors
    for name, a in packed.rebind(got).tensors.items():
        r = refs[name]
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name
    assert torch.equal(got, epic_backward_wide(packed, t, x, k, mask, g))


def hold_wide_backward(packed, t, x, k, mask, g):
    """K5 against plain autograd per leaf (|err| ≤ 1e-4·max|ref leaf| +
    1e-3·|ref|), the same bits on a repeat."""
    before = epic_backward_wide.launches
    got = epic_backward_wide(packed, t, x, k, mask, g)
    again = epic_backward_wide(packed, t, x, k, mask, g)
    torch.cuda.synchronize()
    assert epic_backward_wide.launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    ref = sum(epic_backward_reference(packed, *(a[i:i + 512] for a in (t, x, k, mask, g)))
              for i in range(0, x.shape[0], 512))
    refs = packed.rebind(ref).tensors
    for name, a in packed.rebind(got).tensors.items():
        r = refs[name]
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name


@pytest.mark.parametrize("N", [1, 63, 64, 65, 109, 128])
@pytest.mark.parametrize("skip,head", [(True, True), (False, False)])
def test_epic_backward_wide_tensor_cores_across_n(device, N, skip, head):
    """K5's products on the tensor cores at N on both sides of their 8-, 16-
    and 64-row edges, with the skip and head flips; B = 133, more jets than
    SMs and not a multiple of the grid."""
    packed = packed_model(device, 128, 2, skip, head, wide=True)
    t, x, k, mask, gen = inputs(device, 133, N)
    near = near_kink_jets(packed, t, x, k, mask)
    g = torch.randn((133, N, 11), generator=gen, device=device) * (~near)[:, None, None]
    hold_wide_backward(packed, t, x, k, mask, g)


@pytest.mark.parametrize("B", [1, 131, 133, 2048])
def test_epic_backward_wide_tensor_cores_across_b(device, B):
    """K5 at the scaled backbone's depth (6 blocks), N = 128, with one jet a
    block, about one, and up to 16 jets a block summed into its row."""
    packed = packed_model(device, 128, 6, wide=True)
    t, x, k, mask, gen = inputs(device, B, 128)
    if B == 1:  # `inputs` empties the last jets
        mask[0, :100] = 1.0
        x = torch.randn((1, 128, 3), generator=gen, device=device) * mask
    near = torch.cat([near_kink_jets(packed, *(a[i:i + 512] for a in (t, x, k, mask)))
                      for i in range(0, B, 512)])
    g = torch.randn((B, 128, 11), generator=gen, device=device) * (~near)[:, None, None]
    hold_wide_backward(packed, t, x, k, mask, g)


# K4 and K5 at every width the wide gate takes up to 512 (a cluster of
# hidden / 128 blocks a jet), mixed; the encoder overrides of `packed_model`
WIDE_WIDTH_CASES = {
    "all256": dict(hidden=256),
    "local256-glob128": dict(hidden=256, dim_hidden_glob=128),
    "local128-glob256-time384": dict(hidden=128, dim_hidden_glob=256, dim_emb_time=384),
    "local384-emb256": dict(hidden=384, dim_emb_features_continuous=256),
    "all512": dict(hidden=512),
    "local512-glob256-time128": dict(hidden=512, dim_hidden_glob=256, dim_emb_time=128,
                                     dim_emb_features_discrete=128),
}


def wide_width_packing(device, case, blocks, skip=True, head=True, head_hidden=None):
    """A seeded MBM encoder at a WIDE_WIDTH_CASES case, packed for the wide
    kernels; with `head_hidden` a seeded discrete head of that hidden width
    (the absorbing generator's Dense-SELU-Dense) in place of the module's."""
    overrides = dict(WIDE_WIDTH_CASES[case])
    hidden = overrides.pop("hidden")
    packed = packed_model(device, hidden, blocks, skip, head, wide=True, **overrides)
    if head_hidden is None:
        return packed
    config = MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = hidden
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = hidden
    for name, value in overrides.items():
        setattr(e, name, value)
    e.num_blocks, e.skip_connection, e.add_discrete_head = blocks, skip, True
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    torch.manual_seed(7)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, head_hidden), torch.nn.SELU(),
                              torch.nn.Linear(head_hidden, 8))
    return pack_wide_encoder_params(model.to(device).encoder, config, head=mlp.to(device))


def hold_wide_forward(packed, t, x, k, mask, hidden_output=False):
    """K4 against its plain version per particle (|err| ≤ 1e-4 + 1e-4·the
    particle's largest |output|; the hidden output per particle the same way),
    the same bits on a repeat, empty jets' continuous outputs 0."""
    before = epic_forward_wide.launches
    got = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden_output)
    again = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden_output)
    torch.cuda.synchronize()
    assert epic_forward_wide.launches == before + 2
    ref = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=hidden_output)
    pairs = zip(got, again, ref) if hidden_output else [(got, again, ref)]
    for a, b, r in pairs:
        assert torch.isfinite(a).all() and torch.equal(a, b)
        bound = ATOL + RTOL * r.abs().amax(dim=-1, keepdim=True)
        assert ((a - r).abs() <= bound).all(), (a - r).abs().max().item()
    out = got[0] if hidden_output else got
    assert (out[-2:, :, :3] == 0).all()  # empty jets


@pytest.mark.parametrize("N", [128, 37])
@pytest.mark.parametrize("case", list(WIDE_WIDTH_CASES))
def test_epic_forward_wide_at_every_width(device, case, N):
    """K4 at every width case (clusters of 1 to 4 blocks), 2 blocks with skip
    and head, and 1 block without; N on both sides of the 64-row warpgroups."""
    t, x, k, mask, _ = inputs(device, 48, N)
    hold_wide_forward(wide_width_packing(device, case, 2), t, x, k, mask)
    hold_wide_forward(wide_width_packing(device, case, 1, skip=False, head=False), t, x, k, mask)


@pytest.mark.parametrize("case,head_hidden", [("all256", 56), ("all256", 128), ("local384-emb256", 8),
                                              ("local128-glob256-time384", 128),
                                              ("local512-glob256-time128", 512)])
def test_epic_forward_wide_heads_and_hidden_output_at_every_width(device, case, head_hidden):
    """K4's discrete head up to 512 wide (the absorbing generator's MLP) with
    the trunk's last hidden state (B, N, H) as a second output."""
    packed = wide_width_packing(device, case, 2, head_hidden=head_hidden)
    assert packed.dims.head_hidden == head_hidden
    t, x, k, mask, _ = inputs(device, 40, 109)
    hold_wide_forward(packed, t, x, k, mask, hidden_output=True)


@pytest.mark.parametrize("head_hidden", [56, 64, 65, 128, 512])
def test_epic_forward_wide_heads_at_width_128(device, head_hidden):
    """At every width 128, a head of at most 64 takes the width-128 kernel and
    a wider one the general kernel (a one-block cluster): both against the
    plain version, with the hidden output."""
    config = MultimodalBridgeMatchingConfig()
    scale_encoder(config, 2)
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    torch.manual_seed(8)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, head_hidden), torch.nn.SELU(),
                              torch.nn.Linear(head_hidden, 8))
    packed = pack_wide_encoder_params(model.to(device).encoder, config, head=mlp.to(device))
    t, x, k, mask, _ = inputs(device, 24, 109)
    hold_wide_forward(packed, t, x, k, mask, hidden_output=True)


@pytest.mark.parametrize("N", [128, 50])
@pytest.mark.parametrize("case", list(WIDE_WIDTH_CASES))
def test_epic_backward_wide_at_every_width(device, case, N):
    """K5 at every width case against plain autograd per leaf, with the skip
    and head flips, over more jets than the grid has clusters; the same bits
    on a repeat."""
    B = 140
    for skip, head in ((True, True), (False, False)):
        packed = wide_width_packing(device, case, 2, skip, head)
        t, x, k, mask, gen = inputs(device, B, N)
        near = near_kink_jets(packed, t, x, k, mask)
        g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
        hold_wide_backward(packed, t, x, k, mask, g)


@pytest.mark.parametrize("hidden", [256, 300])
def test_survival_head_on_a_trunk_wider_than_its_width(device, hidden):
    """K6 at transformer width 128 on a trunk hidden width above it (its
    first product in passes of 128 columns) against its plain version at
    2e-4, the same bits on a repeat."""
    B, N = 133, 109
    model = absorbing_model(device, hidden=hidden)
    _, head = model.pack_for_kernel()
    assert head.dim_hidden == hidden
    t, _, _, mask = scattered_inputs(device, B, N)
    last = torch.randn((B, N, hidden), generator=torch.Generator(device=device).manual_seed(9),
                       device=device)
    tp = project_time_embeddings(model.generator, t, 2, 128)
    got = survival_head(head, tp, last, mask.long(), n_heads=2)
    again = survival_head(head, tp, last, mask.long(), n_heads=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, survival_head_reference(head, tp, last, mask.long(), n_heads=2),
                               atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)


def test_epic_train_forward_wide_goes_through_both_kernels(device):
    config = MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    model = model.to(device)
    assert model.wide_kernel_enabled(device) and not model.kernel_enabled(device)
    t, x, k, mask, _ = inputs(device, 32, 128)
    fwd, bwd = epic_forward_wide.launches, epic_backward_wide.launches
    packed = pack_wide_encoder_params(model.encoder, config, differentiable=True)
    (epic_train_forward_wide(packed, t, x, k, mask) ** 2).sum().backward()
    assert (epic_forward_wide.launches, epic_backward_wide.launches) == (fwd + 1, bwd + 1)
    for name, p in model.encoder.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_wide_wrappers_reject_what_the_kernels_do_not_take(device):
    wide = packed_model(device, 128, 1, wide=True)
    narrow = packed_model(device)
    t, x, k, mask, gen = inputs(device, 4, 32)
    g = torch.randn((4, 32, 11), generator=gen, device=device)
    with pytest.raises(ValueError, match="layout"):
        epic_forward_wide(narrow, t, x, k, mask)
    with pytest.raises(ValueError, match="layout"):
        epic_forward(wide, t, x, k, mask)
    with pytest.raises(ValueError, match="outside"):
        epic_forward_wide(wide, *inputs(device, 2, 257)[:4])
    with pytest.raises(ValueError, match="g must be"):
        epic_backward_wide(wide, t, x, k, mask, g[..., :10].contiguous())
    with pytest.raises(TypeError, match="float32"):
        epic_backward_wide(wide, t, x, k, mask, g.double())


# ------------------------------------------------- the absorbing family: K1 + K6


def scale_encoder(config, blocks):
    """Every width 128 (bench.py's `_scale_encoder`) at `blocks` blocks."""
    e = config.encoder
    e.num_blocks = blocks
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128


def absorbing_model(device, hidden=16, n_heads=2, n_blocks=2, scaled_blocks=None, width=128):
    config = AbsorbingConfig()
    config.encoder.dim_hidden_local = config.encoder.dim_hidden_glob = hidden
    if scaled_blocks is not None:
        scale_encoder(config, scaled_blocks)
    config.generator.n_heads, config.generator.n_attn_blocks = n_heads, n_blocks
    config.generator.transformer_dim = width
    model = init_absorbing_parameters(AbsorbingFlow(config), 0).to(device)
    # non-zero biases and GroupNorm offsets, so that a misplaced vector shows
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(1)
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
    return model.eval()


def scattered_inputs(device, B, N, seed=3):
    """t, x, k, mask with random, non-prefix masks and jet 0 empty."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.6).float()
    mask[0] = 0.0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, x, k, mask


@pytest.mark.parametrize("hidden,N", [(16, 109), (32, 128), (64, 50)])
def test_epic_forward_hidden_output_and_wide_head_match_plain(device, hidden, N):
    """K1 with `output_hidden_local` and the absorbing generator's 56-wide
    discrete head: the 11 outputs and the (B, N, H) hidden state."""
    model = absorbing_model(device, hidden)
    trunk, _ = model.pack_for_kernel()
    assert trunk.dims.head_hidden == 56
    t, x, k, mask = scattered_inputs(device, 64, N)
    out, hid = epic_forward(trunk, t, x, k, mask, output_hidden_local=True)
    torch.cuda.synchronize()
    ref_out, ref_hid = epic_forward_reference(trunk, t, x, k, mask, output_hidden_local=True)
    assert tuple(hid.shape) == (64, N, hidden)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(hid, ref_hid, atol=ATOL, rtol=RTOL)
    assert torch.equal(epic_forward(trunk, t, x, k, mask), out)


@pytest.mark.parametrize("B,N,hidden,n_heads,n_blocks", [
    (7, 109, 16, 2, 2), (64, 128, 16, 2, 2), (300, 109, 16, 2, 2),
    (5, 1, 16, 2, 2), (9, 33, 32, 4, 1), (6, 77, 64, 1, 3),
])
def test_survival_head_matches_plain(device, B, N, hidden, n_heads, n_blocks):
    """K6 at the reference N = 109, at N = 128, over more jets than the grid
    has blocks, at one slot, and at other trunk widths, head counts and
    depths; the same bits on a repeat."""
    model = absorbing_model(device, hidden, n_heads, n_blocks)
    _, head = model.pack_for_kernel()
    t, _, _, mask = scattered_inputs(device, B, N)
    gen = torch.Generator(device=device).manual_seed(4)
    last = torch.randn((B, N, hidden), generator=gen, device=device)
    tp = project_time_embeddings(model.generator, t, n_blocks, 128)
    launches = survival_head.launches
    got = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    again = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    torch.cuda.synchronize()
    assert survival_head.launches == launches + 2
    ref = survival_head_reference(head, tp, last, mask.long(), n_heads=n_heads)
    assert tuple(got.shape) == (B, N, 1) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)


def test_absorbing_forward_sampling_goes_through_both_kernels(device):
    """forward_sampling on the card: one launch of K1 and one of K6, no plain
    version, and the heads of the module path within 2e-4."""
    model = absorbing_model(device)
    t, x, k, mask = scattered_inputs(device, 32, 109)
    from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState

    state = AbsorbingBridgeState(t, x, k, mask.long())
    counts = epic_forward.launches, survival_head.launches
    calls = epic_forward_reference.calls, survival_head_reference.calls
    heads = model.forward_sampling(state)
    torch.cuda.synchronize()
    assert (epic_forward.launches, survival_head.launches) == (counts[0] + 1, counts[1] + 1)
    assert (epic_forward_reference.calls, survival_head_reference.calls) == calls
    with torch.no_grad():
        ref = model.forward(state)
    for name in ("continuous", "discrete", "absorbing"):
        torch.testing.assert_close(getattr(heads, name), getattr(ref, name), atol=2e-4, rtol=2e-4)


def test_survival_wrapper_rejects_what_the_kernel_does_not_take(device):
    model = absorbing_model(device)
    _, head = model.pack_for_kernel()
    t, _, _, mask = scattered_inputs(device, 4, 16)
    last = torch.randn((4, 16, 16), device=device)
    tp = project_time_embeddings(model.generator, t, 2, 128)
    with pytest.raises(ValueError):
        survival_head(head, tp, last[..., :8].contiguous(), mask, n_heads=2)
    with pytest.raises(ValueError):
        survival_head(head, tp, last, mask, n_heads=3)
    with pytest.raises(TypeError):
        survival_head(head, tp, last.double(), mask, n_heads=2)
    with pytest.raises(ValueError):
        survival_head(head, tp, last.cpu().to(device)[:, ::2], mask[:, ::2], n_heads=2)
    trunk, _ = model.pack_for_kernel()
    with pytest.raises(ValueError, match="hidden width 8"):
        sampler_step(trunk, last[..., :3].contiguous(), mask.long(), mask,
                     torch.rand((2, 4, 16), device=device), 0.5, 0.01, gamma=0.125)


# ------------------------------------------- the transdimensional family, K7


def transdim_model(device, hidden=16, n_heads=2, n_blocks=2, n=128, scaled_blocks=None,
                   width=128):
    """TransdimensionalJumpDiffusion at its reference config (global 19,
    Linear-discrete input) with seeded weights and noise on every vector;
    with `scaled_blocks` at the `--scaled` widths, with `width` its gsdm
    stacks' transformer width."""
    config = TransdimensionalEpicConfig()
    config.data.max_num_particles = n
    config.encoder.dim_hidden_local = hidden
    if scaled_blocks is not None:
        scale_encoder(config, scaled_blocks)
    config.encoder.n_heads, config.encoder.n_attn_blocks = n_heads, n_blocks
    config.encoder.transformer_dim = width
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), 0).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
    return model.eval()


def transdim_state(device, B, N, seed=5):
    """A noisy state with prefix masks: dims in [1, N], jet 0 at dims = 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = torch.randint(1, N + 1, (B,), generator=gen, device=device).to(torch.int32)
    dims[0] = 1
    live = (torch.arange(N, device=device)[None, :] < dims[:, None]).float()[..., None]
    x = torch.randn((B, N, 3), generator=gen, device=device) * live
    values = torch.nn.functional.one_hot(
        torch.randint(0, 8, (B, N), generator=gen, device=device), 8).float()
    values = (values + 0.3 * torch.randn((B, N, 8), generator=gen, device=device)) * live
    ts = torch.rand((B,), generator=gen, device=device).clamp(1e-3, 1.0)
    return StructuredState(x, values, dims), ts


@pytest.mark.parametrize("hidden,N", [(16, 128), (32, 40), (64, 109)])
def test_epic_forward_folded_input_matches_plain(device, hidden, N):
    """K1 with the folded Linear-discrete input, no discrete head, the hidden
    output and global width 19: the 11 outputs and the (B, N, H) hidden state."""
    model = transdim_model(device, hidden, n=N)
    trunk, _, _ = model.pack_for_kernel()
    assert trunk.dims.fold_discrete and not trunk.dims.add_discrete_head
    assert trunk.dims.hidden_glob == 19
    state, ts = transdim_state(device, 64, N)
    mask = state.particle_mask()[:, :, None]
    args = (trunk, ts.reshape(-1, 1, 1), state.continuous, state.discrete, mask)
    launches = epic_forward.launches
    out, hid = epic_forward(*args, output_hidden_local=True)
    torch.cuda.synchronize()
    assert epic_forward.launches == launches + 1
    ref_out, ref_hid = epic_forward_reference(*args, output_hidden_local=True)
    assert tuple(hid.shape) == (64, N, hidden)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(hid, ref_hid, atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        mod_out, mod_hid = model.network.epic(*args[1:], output_hidden_local=True)
    torch.testing.assert_close(out, mod_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(hid, mod_hid, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,N,dim_in,n_heads,n_blocks", [
    (7, 40, 27, 2, 2), (64, 128, 24, 2, 2), (300, 109, 27, 2, 2),
    (5, 1, 24, 2, 2), (9, 33, 43, 4, 1), (6, 77, 128, 1, 3), (4, 128, 16, 2, 2),
    (64, 128, 136, 2, 2), (300, 109, 139, 2, 2), (7, 40, 200, 4, 1), (5, 1, 139, 2, 2),
])
def test_gsdm_stack_matches_plain(device, B, N, dim_in, n_heads, n_blocks):
    """K7 at the reference widths (24, 27) and N = 128, at ragged N, over more
    jets than the grid has blocks, at one slot, at input widths that are, and
    are not, multiples of the 16-row weight tile, up to 128, and above it
    (the `--scaled` stacks' 136 and 139, and 200: passes of 128 columns); the
    same bits on a repeat."""
    from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock, ResnetBlock
    from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import pack_gsdm_stack_params

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj_in = torch.nn.Linear(dim_in, 128)
            self.res = torch.nn.ModuleList(ResnetBlock(128, 0.0, 128) for _ in range(n_blocks))
            self.att = torch.nn.ModuleList(AttnBlock(128, n_heads) for _ in range(n_blocks))

    gen = torch.Generator(device=device).manual_seed(6)
    stack = init_transdimensional_parameters(Stack(), 2).to(device)
    with torch.no_grad():
        for p in stack.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
        packed = pack_gsdm_stack_params(stack.proj_in, list(stack.res), list(stack.att))
        x_in = torch.randn((B, N, dim_in), generator=gen, device=device)
        tp = stack_time_embeddings(torch.randn((B, 128), generator=gen, device=device),
                                   list(stack.res))
    launches = gsdm_stack.launches
    got = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
    again = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
    torch.cuda.synchronize()
    assert gsdm_stack.launches == launches + 2
    ref = gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads)
    assert tuple(got.shape) == (B, N, 128) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)


# K6 and K7 on the tensor cores: N across each warpgroup's 64 rows and the
# 16-row tiles of the attention (and the old 112-row cut), every head width,
# the trunk widths and input widths of the reference and `--scaled` models,
# a batch that is no multiple of the grid
ROW_CUT_N = (1, 40, 63, 64, 65, 109, 112, 113, 128)
ROW_CUT_HEADS = (1, 2, 4)


@pytest.mark.parametrize("N", ROW_CUT_N)
@pytest.mark.parametrize("n_heads", ROW_CUT_HEADS)
def test_survival_head_across_the_row_cut(device, N, n_heads):
    hidden = 16 if (ROW_CUT_N.index(N) + n_heads) % 2 else 128
    model = absorbing_model(device, hidden, n_heads, 2)
    _, head = model.pack_for_kernel()
    B = 133
    t, _, _, mask = scattered_inputs(device, B, N)
    last = torch.randn((B, N, hidden), generator=torch.Generator(device=device).manual_seed(7),
                       device=device)
    tp = project_time_embeddings(model.generator, t, 2, 128)
    got = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    again = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    torch.cuda.synchronize()
    ref = survival_head_reference(head, tp, last, mask.long(), n_heads=n_heads)
    assert tuple(got.shape) == (B, N, 1) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("N", ROW_CUT_N)
@pytest.mark.parametrize("n_heads", ROW_CUT_HEADS)
def test_gsdm_stack_across_the_row_cut(device, N, n_heads):
    from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock, ResnetBlock
    from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import pack_gsdm_stack_params

    dim_in = (24, 27, 136, 139)[(ROW_CUT_N.index(N) + n_heads) % 4]
    gen = torch.Generator(device=device).manual_seed(8)
    proj_in = torch.nn.Linear(dim_in, 128)
    res = [ResnetBlock(128, 0.0, 128) for _ in range(2)]
    att = [AttnBlock(128, n_heads) for _ in range(2)]
    modules = torch.nn.ModuleList([proj_in, *res, *att])
    init_transdimensional_parameters(modules, 3).to(device)
    with torch.no_grad():
        for p in modules.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
        packed = pack_gsdm_stack_params(proj_in, res, att)
        B = 133
        x_in = torch.randn((B, N, dim_in), generator=gen, device=device)
        tp = stack_time_embeddings(torch.randn((B, 128), generator=gen, device=device), res)
    got = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
    again = gsdm_stack(packed, tp, x_in, n_heads=n_heads)
    torch.cuda.synchronize()
    ref = gsdm_stack_reference(packed, tp, x_in, n_heads=n_heads)
    assert tuple(got.shape) == (B, N, 128) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)


def test_transdim_forward_kernel_goes_through_its_kernels(device):
    """forward_kernel on the card: one launch of K1 and two of K7, no plain
    version, and the module path's outputs within 5e-4."""
    model = transdim_model(device)
    state, ts = transdim_state(device, 32, 128)
    nearest = torch.zeros(32, dtype=torch.long, device=device)
    counts = epic_forward.launches, gsdm_stack.launches
    calls = epic_forward_reference.calls, gsdm_stack_reference.calls
    got = model.forward_kernel(state, ts, nearest)
    torch.cuda.synchronize()
    assert (epic_forward.launches, gsdm_stack.launches) == (counts[0] + 1, counts[1] + 2)
    assert (epic_forward_reference.calls, gsdm_stack_reference.calls) == calls
    with torch.no_grad():
        ref = model.network(state, ts, nearest)
    for g, r in zip(got[:5], ref[:5]):
        torch.testing.assert_close(g, r, atol=5e-4, rtol=5e-4)


def test_other_kernels_refuse_a_folded_packing(device):
    """Only K1 takes the folded Linear-discrete input: K2 and K3 raise in
    their wrappers, and the C entry point of the token instantiation returns
    cudaErrorInvalidValue for a folded layout."""
    model = transdim_model(device)
    trunk, _, _ = model.pack_for_kernel()
    state, ts = transdim_state(device, 4, 128)
    mask = state.particle_mask()[:, :, None]
    tokens = torch.zeros((4, 128, 1), dtype=torch.long, device=device)
    with pytest.raises(ValueError, match="folded"):
        sampler_step(trunk, state.continuous, tokens, mask,
                     torch.rand((2, 4, 128), device=device), 0.5, 0.01, gamma=0.125)
    with pytest.raises(ValueError, match="folded"):
        epic_backward(trunk, ts.reshape(-1, 1, 1), state.continuous, tokens, mask,
                      torch.zeros((4, 128, 11), device=device))
    with pytest.raises((ValueError, TypeError)):  # tokens where the values belong
        epic_forward(trunk, ts.reshape(-1, 1, 1), state.continuous, tokens, mask)
    from multimodal_particles_tpu_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty((4, 128, 11), device=device)
    rc = lib.mmp_epic_forward(trunk.tensor_core[0].data_ptr(), ts.data_ptr(), state.continuous.data_ptr(),
                              state.discrete.data_ptr(), mask.data_ptr(), out.data_ptr(), None,
                              4, 128, trunk.dims.c_array(), 0)
    assert rc == 1  # cudaErrorInvalidValue


# ---------------------- K4's other trunks: `--scaled` absorbing and transdim


def close_per_particle(got, ref):
    bound = ATOL + RTOL * ref.abs().amax(dim=-1, keepdim=True)
    assert ((got - ref).abs() <= bound).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("blocks,N", [(2, 109), (6, 128), (1, 37)])
def test_epic_forward_wide_absorbing_trunk_matches_plain(device, blocks, N):
    """K4 with the absorbing generator's 56-wide discrete head and the hidden
    output, per particle; without the hidden output the same heads."""
    model = absorbing_model(device, scaled_blocks=blocks)
    trunk, _ = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.head_hidden == 56
    t, x, k, mask = scattered_inputs(device, 48, N)
    launches = epic_forward_wide.launches
    out, hid = epic_forward_wide(trunk, t, x, k, mask, output_hidden_local=True)
    again = epic_forward_wide(trunk, t, x, k, mask)
    torch.cuda.synchronize()
    assert epic_forward_wide.launches == launches + 2
    ref_out, ref_hid = epic_forward_reference(trunk, t, x, k, mask, output_hidden_local=True)
    assert tuple(hid.shape) == (48, N, 128)
    close_per_particle(out, ref_out)
    close_per_particle(hid, ref_hid)
    assert torch.equal(again, out)
    assert (out[0, :, :3] == 0).all()  # the empty jet's masked continuous head


@pytest.mark.parametrize("blocks,N", [(2, 128), (6, 128), (1, 40)])
def test_epic_forward_wide_folded_input_matches_plain(device, blocks, N):
    """K4 with the folded Linear-discrete input, no head, the hidden output,
    per particle, and against the module trunk."""
    model = transdim_model(device, n=N, scaled_blocks=blocks)
    trunk, _, _ = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.fold_discrete
    state, ts = transdim_state(device, 64, N)
    mask = state.particle_mask()[:, :, None]
    args = (trunk, ts.reshape(-1, 1, 1), state.continuous, state.discrete, mask)
    launches = epic_forward_wide.launches
    out, hid = epic_forward_wide(*args, output_hidden_local=True)
    torch.cuda.synchronize()
    assert epic_forward_wide.launches == launches + 1
    ref_out, ref_hid = epic_forward_reference(*args, output_hidden_local=True)
    close_per_particle(out, ref_out)
    close_per_particle(hid, ref_hid)
    with torch.no_grad():
        mod_out, mod_hid = model.network.epic(*args[1:], output_hidden_local=True)
    close_per_particle(out, mod_out)
    close_per_particle(hid, mod_hid)


def test_wide_backward_refuses_the_absorbing_and_transdim_packings(device):
    """K5 is written for MBM's packing: its wrapper raises and its C entry
    points return cudaErrorInvalidValue for a 56-wide head or a folded input."""
    import ctypes

    from multimodal_particles_tpu_torch.ops import _build

    trunk, _ = absorbing_model(device, scaled_blocks=1).pack_for_kernel()
    fold, _, _ = transdim_model(device, scaled_blocks=1).pack_for_kernel()
    t, x, k, mask = scattered_inputs(device, 4, 32)
    g = torch.zeros((4, 32, 11), device=device)
    with pytest.raises(ValueError, match="hidden width 8"):
        epic_backward_wide(trunk, t, x, k, mask, g)
    with pytest.raises(ValueError, match="folded"):
        epic_backward_wide(fold, t, x, torch.zeros((4, 32, 8), device=device), mask, g)
    lib = _build.load_library()
    grid, floats = ctypes.c_int(), ctypes.c_longlong()
    for packed in (trunk, fold):
        rc = lib.mmp_epic_wide_backward_workspace(4, 32, packed.dims.c_array(),
                                                  ctypes.byref(grid), ctypes.byref(floats))
        assert rc == 1  # cudaErrorInvalidValue


def test_scaled_absorbing_forward_sampling_goes_through_k4_and_k6(device):
    """forward_sampling at every width 128: one launch of K4 (hidden output,
    56-wide head) and one of K6, no plain version, the module path's heads
    within 2e-4 of their scale."""
    from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState

    model = absorbing_model(device, scaled_blocks=2)
    assert model._pallas_enabled(device)
    t, x, k, mask = scattered_inputs(device, 32, 109)
    state = AbsorbingBridgeState(t, x, k, mask.long())
    counts = epic_forward_wide.launches, survival_head.launches, epic_forward.launches
    calls = epic_forward_reference.calls, survival_head_reference.calls
    heads = model.forward_sampling(state)
    torch.cuda.synchronize()
    assert (epic_forward_wide.launches, survival_head.launches, epic_forward.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    assert (epic_forward_reference.calls, survival_head_reference.calls) == calls
    with torch.no_grad():
        ref = model.forward(state)
    for name in ("continuous", "discrete", "absorbing"):
        r = getattr(ref, name)
        torch.testing.assert_close(getattr(heads, name), r, rtol=2e-4,
                                   atol=2e-4 * max(r.abs().max().item(), 1.0))


def test_scaled_transdim_forward_kernel_goes_through_k4_and_k7(device):
    """forward_kernel at every width 128: one launch of K4 (folded input,
    hidden output) and two of K7 at Din 136 and 139, no plain version, the
    module path's outputs within 5e-4 of their scale."""
    model = transdim_model(device, scaled_blocks=2)
    assert model._pallas_enabled(device)
    state, ts = transdim_state(device, 32, 128)
    nearest = torch.zeros(32, dtype=torch.long, device=device)
    counts = epic_forward_wide.launches, gsdm_stack.launches, epic_forward.launches
    calls = epic_forward_reference.calls, gsdm_stack_reference.calls
    got = model.forward_kernel(state, ts, nearest)
    torch.cuda.synchronize()
    assert (epic_forward_wide.launches, gsdm_stack.launches, epic_forward.launches) == (
        counts[0] + 1, counts[1] + 2, counts[2])
    assert (epic_forward_reference.calls, gsdm_stack_reference.calls) == calls
    with torch.no_grad():
        ref = model.network(state, ts, nearest)
    for g, r in zip(got[:5], ref[:5]):
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-4 * max(r.abs().max().item(), 1.0))


def k4_instance(device, name, N):
    """One of K4's four template instances at the scaled widths, 2 blocks:
    (packed, t, x, k or the channel values, mask, hidden output)."""
    if name in ("tokens", "tokens_wide_head"):
        if name == "tokens":
            packed = packed_model(device, 128, 2, wide=True)
        else:
            packed, _ = absorbing_model(device, scaled_blocks=2).pack_for_kernel()
        return (packed, *scattered_inputs(device, 16, N), name != "tokens")
    model = transdim_model(device, scaled_blocks=2)
    packed, _, _ = model.pack_for_kernel()
    if name == "fold_wide_head":  # the folded input under a 56-wide head
        head = absorbing_model(device, scaled_blocks=2).generator.discrete_head_mlp
        d = dataclasses.replace(packed.dims, add_discrete_head=True, head_hidden=56)
        packed = pack_encoder(model.network, d, "wide", head=head)
    state, ts = transdim_state(device, 16, N)
    return (packed, ts.reshape(-1, 1, 1), state.continuous, state.discrete,
            state.particle_mask()[:, :, None], True)


@pytest.mark.parametrize("N", [1, 40, 109, 112, 113, 128])
@pytest.mark.parametrize("name", ["tokens", "tokens_wide_head", "fold", "fold_wide_head"])
def test_epic_forward_wide_instances_across_the_row_cut(device, name, N):
    """Each of K4's four instances (tokens or the folded input, times the
    8-wide or the 56-wide head) with its tensor-core products over ⌈N/16⌉
    row tiles, N on both sides of a tile's edge: per particle against the
    plain version, the hidden output included, the same bits on a repeat."""
    packed, t, x, k, mask, hidden = k4_instance(device, name, N)
    assert bool(packed.dims.fold_discrete) == name.startswith("fold")
    assert (packed.dims.head_hidden == 56) == name.endswith("wide_head")
    launches = epic_forward_wide.launches
    got = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden)
    again = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden)
    torch.cuda.synchronize()
    assert epic_forward_wide.launches == launches + 2
    ref = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=hidden)
    got, again, ref = ((a,) if not hidden else a for a in (got, again, ref))
    for a, b, r in zip(got, again, ref):
        close_per_particle(a, r)
        assert torch.equal(a, b)


# ------------------------------------------------------ K8, the attention core


def attention_inputs(device, B, N, C=128, seed=7, masked=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, N, C), generator=gen, device=device) for _ in range(3))
    mask = None
    if masked:
        mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.5).float()
        mask[0] = 0.0  # every key of jet 0 masked
    return q, k, v, mask


@pytest.mark.parametrize("B,N,heads", [(8, 128, 2), (4, 109, 2), (8, 64, 1), (300, 128, 4),
                                       (5, 1, 2), (9, 33, 2)])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_attention_core_matches_plain(device, B, N, heads, masked):
    """K8 against the einsum at the JAX test's shapes and others, with a key
    mask (one jet wholly masked) and without; the same bits on a repeat."""
    from multimodal_particles_tpu_torch.ops.attention_cuda import (
        attention_core,
        attention_core_reference,
    )

    q, k, v, mask = attention_inputs(device, B, N, masked=masked)
    launches = attention_core.launches
    got = attention_core(q, k, v, mask, n_heads=heads)
    again = attention_core(q, k, v, mask, n_heads=heads)
    torch.cuda.synchronize()
    assert attention_core.launches == launches + 2
    ref = attention_core_reference(q, k, v, mask, n_heads=heads)
    assert tuple(got.shape) == (B, N, 128) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("N", [1, 17, 109, 128])
@pytest.mark.parametrize("heads", [4, 2, 1], ids=["hd32", "hd64", "hd128"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_attention_core_at_every_head_width(device, N, heads, masked):
    """The tensor-core K8 at every head width it takes (32, 64, 128
    channels) and at N on both sides of its 16-row and 64-key tiles: within
    the JAX test's atol, a wholly masked jet gives the mean of its values,
    nothing past N is written, the same bits on a repeat."""
    from multimodal_particles_tpu_torch.ops.attention_cuda import (
        attention_core,
        attention_core_reference,
    )

    q, k, v, mask = attention_inputs(device, 6, N, seed=11, masked=masked)
    got = attention_core(q, k, v, mask, n_heads=heads)
    again = attention_core(q, k, v, mask, n_heads=heads)
    torch.cuda.synchronize()
    ref = attention_core_reference(q, k, v, mask, n_heads=heads)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
    if masked:
        torch.testing.assert_close(got[0], v[0].mean(0).expand(N, -1), atol=2e-5, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("flag", [True, "auto"])
def test_attn_block_fused_core_matches_the_einsum_path(device, flag):
    """AttnBlock(use_pallas=True / "auto") on the card: forward by K8,
    backward by autograd of the einsum; the output and every parameter's and
    the input's gradient against use_pallas=False, the key bias's against 0."""
    from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock
    from multimodal_particles_tpu_torch.ops.attention_cuda import attention_core

    torch.manual_seed(0)
    ref_block = AttnBlock(128, n_heads=2, use_pallas=False).to(device)
    block = AttnBlock(128, n_heads=2, use_pallas=flag).to(device)
    block.load_state_dict(ref_block.state_dict())
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.randn((16, 109, 128), generator=gen, device=device)
    mask = (torch.rand((16, 109, 1), generator=gen, device=device) < 0.5).float()
    mask[3] = 0.0
    g = torch.randn((16, 109, 128), generator=gen, device=device)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    launches = attention_core.launches
    out = block(xs[0], mask)
    ref = ref_block(xs[1], mask)
    assert attention_core.launches == launches + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    out.backward(g)
    ref.backward(g)
    pairs = [("x", xs[0].grad, xs[1].grad)] + [
        (name, p.grad, dict(ref_block.named_parameters())[name].grad)
        for name, p in block.named_parameters()]
    for name, a, r in pairs:
        if name == "k.bias":  # zero in exact arithmetic
            assert a.abs().max() <= 1e-4 * block.k.weight.grad.abs().max()
            continue
        scale = max(r.abs().max().item(), 1e-6)
        assert ((a - r).abs() <= 1e-4 * scale + 1e-3 * r.abs()).all(), name
    # shapes K8 does not take go to the einsum path under "auto", and raise under True
    small = torch.randn((2, 257, 128), device=device)
    if flag == "auto":
        launches = attention_core.launches
        torch.testing.assert_close(block(small), ref_block(small), atol=1e-5, rtol=1e-5)
        assert attention_core.launches == launches
    else:
        with pytest.raises(ValueError, match="attention kernel takes"):
            block(small)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(device):
    from multimodal_particles_tpu_torch.ops import _build
    from multimodal_particles_tpu_torch.ops.attention_cuda import attention_core

    q, k, v, mask = attention_inputs(device, 4, 32)
    with pytest.raises(ValueError):
        attention_core(q, k, v, mask, n_heads=3)  # heads that do not divide 128
    with pytest.raises(ValueError):
        attention_core(q[..., :64].contiguous(), k[..., :64].contiguous(),
                       v[..., :64].contiguous(), n_heads=2)
    with pytest.raises(TypeError):
        attention_core(q, k.double(), v, n_heads=2)
    with pytest.raises(ValueError):
        attention_core(q, k, v, mask[:, :16].contiguous(), n_heads=2)
    lib = _build.load_library()
    out = torch.empty_like(q)
    rc = lib.mmp_attention_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
                                4, 4, 32, 128, 3, 0)
    assert rc == 1  # cudaErrorInvalidValue


# ------------------------------------------- K6, K7 and K8 at every width and head count

WIDTHS = [(128, 8), (128, 128), (256, 8), (256, 64), (384, 4), (384, 6), (384, 128), (512, 16)]


@pytest.mark.parametrize("width,n_heads", WIDTHS,
                         ids=[f"C{c}-heads{h}" for c, h in WIDTHS])
def test_head_kernels_at_every_width(device, width, n_heads):
    """K6, K7 and K8 at transformer widths 128-512 (a cluster of width / 128
    blocks a jet) and heads 1 to 128 channels wide against their plain
    versions: K6 and K7 at 2e-4 (atol = rtol), K8 at 2e-5 (atol), N on both
    sides of the 64-row warpgroups, a jet count that is no multiple of the
    grid's clusters, a trunk hidden width that is no multiple of 8 (K6); the
    same bits on a repeat."""
    B = 133
    absorbing = absorbing_model(device, hidden=20, n_heads=n_heads, n_blocks=1, width=width)
    _, head = absorbing.pack_for_kernel()
    t, _, _, mask = scattered_inputs(device, B, 109)
    last = torch.randn((B, 109, 20), generator=torch.Generator(device=device).manual_seed(5),
                       device=device)
    tp = project_time_embeddings(absorbing.generator, t, 1, width)
    got = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    again = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, survival_head_reference(head, tp, last, mask.long(),
                                                            n_heads=n_heads),
                               atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)

    model = transdim_model(device, n_heads=n_heads, n_blocks=1, width=width)
    net = model.network
    _, _, vec_stack = model.pack_for_kernel()
    gen = torch.Generator(device=device).manual_seed(6)
    for n in (40, 128):
        x_in = torch.randn((B, n, vec_stack.dim_in), generator=gen, device=device)
        with torch.no_grad():
            tp7 = stack_time_embeddings(net.time_embedding(torch.rand((B,), generator=gen,
                                                                      device=device)),
                                        net.blocks("vec_")[0])
        got = gsdm_stack(vec_stack, tp7, x_in, n_heads=n_heads)
        again = gsdm_stack(vec_stack, tp7, x_in, n_heads=n_heads)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, gsdm_stack_reference(vec_stack, tp7, x_in,
                                                             n_heads=n_heads),
                                   atol=2e-4, rtol=2e-4)
        assert torch.equal(got, again)

    from multimodal_particles_tpu_torch.ops.attention_cuda import (
        attention_core,
        attention_core_reference,
    )
    for n in (17, 128):
        q, k, v, mask = attention_inputs(device, 64, n, C=width)
        for m in (mask, None):
            got = attention_core(q, k, v, m, n_heads=n_heads)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, attention_core_reference(q, k, v, m, n_heads=n_heads),
                                       atol=2e-5, rtol=0)


# ------------------------------------------- K6, K7 and K8 past 128 slots

LONG_N = (129, 200, 256)
LONG_PAIRS = [(128, 2), (128, 1), (128, 128), (384, 4), (512, 16)]


@pytest.mark.parametrize("N", LONG_N)
@pytest.mark.parametrize("width,n_heads", LONG_PAIRS,
                         ids=[f"C{c}-heads{h}" for c, h in LONG_PAIRS])
def test_head_kernels_past_128_slots(device, width, n_heads, N):
    """K6, K7 and K8 on jets of 129 to 256 slots against their plain
    versions: K6 and K7 as clusters of width / 128 channel blocks × 2 row
    blocks a jet (up to 8 blocks at width 512), K8 a block a (jet, head,
    query half) with the keys in two blocks of 128; at 2e-4 (K6, K7, atol =
    rtol) and 2e-5 (K8, atol), heads of 1 to 128 channels (and of 96, across
    two channel blocks), more jets than the grid's clusters, a random
    non-prefix mask (K6) and a key mask that masks every key of jet 0 (K8,
    whose output there is the mean of the values); the same bits on a
    repeat."""
    from multimodal_particles_tpu_torch.ops.attention_cuda import (
        attention_core,
        attention_core_reference,
    )

    B = 133
    absorbing = absorbing_model(device, hidden=20, n_heads=n_heads, n_blocks=1, width=width)
    _, head = absorbing.pack_for_kernel()
    t, _, _, mask = scattered_inputs(device, B, N)
    last = torch.randn((B, N, 20), generator=torch.Generator(device=device).manual_seed(5),
                       device=device)
    tp = project_time_embeddings(absorbing.generator, t, 1, width)
    got = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    again = survival_head(head, tp, last, mask.long(), n_heads=n_heads)
    torch.cuda.synchronize()
    ref = survival_head_reference(head, tp, last, mask.long(), n_heads=n_heads)
    assert tuple(got.shape) == (B, N, 1) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)

    model = transdim_model(device, n_heads=n_heads, n_blocks=1, width=width, n=N)
    net = model.network
    _, _, vec_stack = model.pack_for_kernel()
    gen = torch.Generator(device=device).manual_seed(6)
    x_in = torch.randn((B, N, vec_stack.dim_in), generator=gen, device=device)
    with torch.no_grad():
        tp7 = stack_time_embeddings(net.time_embedding(torch.rand((B,), generator=gen,
                                                                  device=device)),
                                    net.blocks("vec_")[0])
    got = gsdm_stack(vec_stack, tp7, x_in, n_heads=n_heads)
    again = gsdm_stack(vec_stack, tp7, x_in, n_heads=n_heads)
    torch.cuda.synchronize()
    ref = gsdm_stack_reference(vec_stack, tp7, x_in, n_heads=n_heads)
    assert tuple(got.shape) == (B, N, width) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert torch.equal(got, again)

    q, k, v, mask = attention_inputs(device, B, N, C=width)
    for m in (mask, None):
        got = attention_core(q, k, v, m, n_heads=n_heads)
        again = attention_core(q, k, v, m, n_heads=n_heads)
        torch.cuda.synchronize()
        ref = attention_core_reference(q, k, v, m, n_heads=n_heads)
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
        if m is not None:
            torch.testing.assert_close(got[0], v[0].mean(0).expand(N, -1), atol=2e-5, rtol=0)
        assert torch.equal(got, again)


def test_head_kernels_refuse_257_slots(device):
    """At N = 257 the three wrappers raise and the three C entry points
    return cudaErrorInvalidValue; nothing is launched."""
    from multimodal_particles_tpu_torch.ops import _build
    from multimodal_particles_tpu_torch.ops.attention_cuda import attention_core

    B, N = 2, 257
    absorbing = absorbing_model(device)
    _, head = absorbing.pack_for_kernel()
    t, _, _, mask = scattered_inputs(device, B, N)
    last = torch.randn((B, N, 16), device=device)
    tp = project_time_embeddings(absorbing.generator, t, 2, 128)
    model = transdim_model(device, n=128)
    _, _, vec_stack = model.pack_for_kernel()
    x_in = torch.randn((B, N, vec_stack.dim_in), device=device)
    tp7 = tuple(torch.randn((B, 128), device=device) for _ in range(2))
    q, k, v, amask = attention_inputs(device, B, N)
    launches = survival_head.launches, gsdm_stack.launches, attention_core.launches
    with pytest.raises(ValueError, match="outside"):
        survival_head(head, tp, last, mask.long(), n_heads=2)
    with pytest.raises(ValueError, match="outside"):
        gsdm_stack(vec_stack, tp7, x_in, n_heads=2)
    with pytest.raises(ValueError, match="attention kernel takes"):
        attention_core(q, k, v, amask, n_heads=2)
    assert (survival_head.launches, gsdm_stack.launches, attention_core.launches) == launches
    lib = _build.load_library()
    out = torch.empty_like(q)
    scratch = torch.empty((8, 2 * 128 * 132), device=device)
    tps = torch.stack(tp)
    assert lib.mmp_attention_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                  out.data_ptr(), 8, B, N, 128, 2, 0) == 1
    assert lib.mmp_survival_head(head.flat.data_ptr(), head.tensor_core.data_ptr(),
                                 tps.data_ptr(), last.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), scratch.data_ptr(), 8, B, N, 16, 2, 2, 128,
                                 0) == 1
    assert lib.mmp_gsdm_stack(vec_stack.flat.data_ptr(), vec_stack.tensor_core.data_ptr(),
                              tps.data_ptr(), x_in.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), 8, B, N, vec_stack.dim_in, 2, 2, 128, 0) == 1


# ------------------------------------------- encoder switches, contexts, bf16

SWITCHES = {
    "time_linear": {"encoder": {"embedding_time": "Linear"}},
    "continuous_none": {"encoder": {"embedding_features_continuous": None}},
    "discrete_linear": {"encoder": {"embedding_features_discrete": "Linear"}},
    "both_contexts": {"data": {"dim_context_continuous": 2, "dim_context_discrete": 1,
                               "vocab_size_context": 10},
                      "encoder": {"dim_emb_context_continuous": 16,
                                  "dim_emb_context_discrete": 16}},
}


def switched_model(device, family, sections, dtype="float32"):
    """A seeded MBM or AbsorbingFlow with `sections` ({section: {field:
    value}}) and the compute dtype, on the card, and a (B = 64) state and
    batch with the contexts it asks for."""
    from multimodal_particles_tpu_torch.models.generative.states import (
        AbsorbingBridgeState,
        HybridState,
    )

    config = MultimodalBridgeMatchingConfig() if family == "mbm" else AbsorbingConfig()
    config.parallel.compute_dtype = dtype
    for section, fields in sections.items():
        for name, value in fields.items():
            setattr(getattr(config, section), name, value)
    cls, init = ((MultiModalBridgeMatching, init_mbm_parameters) if family == "mbm"
                 else (AbsorbingFlow, init_absorbing_parameters))
    model = init(cls(config), 0).to(device).eval()
    n = config.data.max_num_particles
    t, x, k, mask = scattered_inputs(device, 64, n)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = MultimodalDatabatch(x, k, mask)
    if config.data.dim_context_continuous:
        batch.context_continuous = torch.randn((64, 2), generator=gen, device=device)
        batch.context_discrete = torch.randint(0, 10, (64, 1), generator=gen, device=device)
    state = (HybridState(t, x, k, mask) if family == "mbm"
             else AbsorbingBridgeState(t, x, k, mask.long()))
    return model, state, batch


def cpu_forward(model, state, batch):
    """The model's module forward on the CPU from the same weights and inputs."""
    cpu = dataclasses.replace(state, **{f.name: getattr(state, f.name).cpu()
                                        for f in dataclasses.fields(state)})
    cpu_batch = MultimodalDatabatch(**{f.name: None if getattr(batch, f.name) is None
                                       else getattr(batch, f.name).cpu()
                                       for f in dataclasses.fields(batch)})
    with torch.no_grad():
        return copy.deepcopy(model).cpu().forward(cpu, cpu_batch)


@pytest.mark.parametrize("family", ["mbm", "absorbing"])
@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_module_forward_on_the_card_matches_the_cpu(device, family, switch):
    """Each switch the trunk kernels do not take runs the module path on the
    card (no kernel launched) and gives the CPU's heads within 1e-4."""
    model, state, batch = switched_model(device, family, SWITCHES[switch])
    counts = epic_forward.launches, epic_forward_wide.launches, sampler_step.launches
    with torch.no_grad():
        heads = model.forward(state, batch)
    torch.cuda.synchronize()
    assert (epic_forward.launches, epic_forward_wide.launches, sampler_step.launches) == counts
    ref = cpu_forward(model, state, batch)
    for name in ("continuous", "discrete", "absorbing"):
        torch.testing.assert_close(getattr(heads, name).cpu(), getattr(ref, name),
                                   rtol=RTOL, atol=ATOL)


def test_conditional_absorbing_sampling_takes_the_module_trunk_and_k6(device):
    """A context turns the trunk kernels off: forward_sampling is the module
    trunk and one launch of K6, within K6's tolerance of the module path."""
    model, state, batch = switched_model(device, "absorbing", SWITCHES["both_contexts"])
    assert model.pack_for_kernel()[0] is None
    counts = epic_forward.launches, survival_head.launches
    heads = model.forward_sampling(state, batch=batch)
    torch.cuda.synchronize()
    assert (epic_forward.launches, survival_head.launches) == (counts[0], counts[1] + 1)
    with torch.no_grad():
        ref = model.forward(state, batch)
    for name in ("continuous", "discrete", "absorbing"):
        torch.testing.assert_close(getattr(heads, name), getattr(ref, name), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["mbm", "absorbing"])
def test_bf16_module_forward_on_the_card_matches_the_cpu(device, family):
    """The bf16 module forward (the conditional model, whose gates are off)
    on the card against the CPU's: the gap a small share of the CPU's own
    float32-vs-bf16 gap (chip_smoke.py's BF16_MEAN_SHARE 0.05 on average, and
    below the control at its largest: cuBLAS's order of the bf16 sums flips
    an early rounding in a few jets, scripts/bf16_card_gap.py); heads in
    float32."""
    model, state, batch = switched_model(device, family, SWITCHES["both_contexts"], "bfloat16")
    with torch.no_grad():
        heads = model.forward(state, batch)
    ref = cpu_forward(model, state, batch)
    model.config.parallel.compute_dtype = "float32"
    ref_f32 = cpu_forward(model, state, batch)
    for name in ("continuous", "discrete") + (("absorbing",) if family == "absorbing" else ()):
        got = getattr(heads, name)
        assert got.dtype == torch.float32
        gap = (got.cpu() - getattr(ref, name)).abs()
        control = (getattr(ref_f32, name) - getattr(ref, name)).abs()
        assert gap.mean() <= 0.05 * control.mean(), name
        assert gap.max() <= control.max(), name


def test_bf16_config_berlin_keeps_the_float32_kernels(device):
    """A bf16 config-berlin model serves through K2 with the float32
    config's bits: the kernel gates do not read the dtype (as in JAX)."""
    f32 = init_mbm_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
    config = MultimodalBridgeMatchingConfig()
    config.parallel.compute_dtype = "bfloat16"
    config.bridge.num_timesteps = f32.config.bridge.num_timesteps = 6
    bf16 = MultiModalBridgeMatching(config)
    bf16.load_state_dict(f32.state_dict())
    batch = gauss_noise_source_batch(64, 128, 3, 8, torch.Generator(device=device).manual_seed(2),
                                     device=device)
    outs = []
    for model in (f32.to(device).eval(), bf16.to(device).eval()):
        before = sampler_step.launches
        outs.append(model.predict(batch, generator=torch.Generator(device=device).manual_seed(3)))
        assert sampler_step.launches == before + 5
    assert torch.equal(outs[0].continuous, outs[1].continuous)
    assert torch.equal(outs[0].discrete, outs[1].discrete)


# ------------------------------------------------------ K4 and K5 past 128 slots

# (name, packed model args): MBM's token input at every width 128 (the
# one-block kernel's shape at N ≤ 128), 256 and 512 (clusters of 2 × 2 and
# 4 × 2 blocks past 128 slots)
LONG_WIDE_CASES = {"all128": (128, {}), "all256": (256, {}), "all512": (512, {})}


def long_wide_inputs(device, B, N, seed=4, sparse=False):
    """t, x, k, mask at N > 128 slots: jet 0 with one live particle, at slot
    N − 1; jet 1 with every live slot past 128; the last two jets empty; the
    others random non-prefix masks (each slot alive with probability 0.6, or
    with `sparse` about 19 live slots a jet and every other jet's last slot
    alive)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    alive = 19 / N if sparse else 0.6
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < alive).float()
    mask[0] = 0.0
    mask[0, N - 1] = 1.0
    mask[1, :128] = 0.0
    if sparse:  # every other jet with a particle at the last slot
        mask[2::2, N - 1] = 1.0
    mask[-2:] = 0.0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, x, k, mask, gen


@pytest.mark.parametrize("N", [129, 256])
@pytest.mark.parametrize("case", list(LONG_WIDE_CASES))
def test_epic_forward_wide_past_128_slots(device, case, N):
    """K4 on jets of 129 and 256 slots (a cluster of hidden / 128 × 2 row
    blocks) against its plain version per particle, 2 blocks with skip and
    head and 1 without; one jet whose only particle lies at the last slot, one
    whose live slots all lie past 128; the same bits on a repeat."""
    hidden, overrides = LONG_WIDE_CASES[case]
    t, x, k, mask, _ = long_wide_inputs(device, 40, N)
    for blocks, skip, head in ((2, True, True), (1, False, False)):
        packed = packed_model(device, hidden, blocks, skip, head, wide=True, **overrides)
        hold_wide_forward(packed, t, x, k, mask)


@pytest.mark.parametrize("N", [129, 256])
@pytest.mark.parametrize("name", ["tokens_wide_head", "fold", "fold_wide_head"])
def test_epic_forward_wide_instances_past_128_slots(device, name, N):
    """K4's other instances (the 56-wide head, the folded input, both) with
    the hidden output at N = 129 and 256, per particle, the same bits on a
    repeat."""
    packed, t, x, k, mask, hidden = k4_instance(device, name, N)
    got = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden)
    again = epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden)
    torch.cuda.synchronize()
    ref = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=hidden)
    for a, b, r in zip(got, again, ref):
        close_per_particle(a, r)
        assert torch.equal(a, b)


@pytest.mark.parametrize("hidden", [256, 512])
def test_epic_forward_wide_second_row_block_dead_gives_one_row_blocks_bits(device, hidden):
    """A jet of 256 slots whose live particles all lie in the first 128 runs
    through the two-row-block cluster with the first row block on the N = 128
    kernel's plan and a dead second one: its first 128 rows are the N = 128
    kernel's bits (the row peers' sums add zeros)."""
    packed = packed_model(device, hidden, 2, wide=True)
    t, x, k, mask, _ = inputs(device, 24, 128)
    pad = lambda a: torch.cat([a, torch.zeros_like(a)], dim=1).contiguous()
    short = epic_forward_wide(packed, t, x, k, mask)
    long = epic_forward_wide(packed, t, pad(x), pad(k), pad(mask))
    torch.cuda.synchronize()
    assert torch.equal(long[:, :128], short)
    assert (long[:, 128:, :3] == 0).all()


@pytest.mark.parametrize("N", [129, 256])
@pytest.mark.parametrize("case", list(LONG_WIDE_CASES))
def test_epic_backward_wide_past_128_slots(device, case, N):
    """K5 on jets of 129 and 256 slots against plain autograd per leaf, over
    more jets than the persistent grid has clusters, with dense and sparse
    masks (the near-kink window leaves out most dense jets of many
    particles), skip and head on and off; the same bits on a repeat."""
    hidden, overrides = LONG_WIDE_CASES[case]
    B = 150
    for sparse, (skip, head) in ((False, (True, True)), (True, (True, True)),
                                 (True, (False, False))):
        packed = packed_model(device, hidden, 2, skip, head, wide=True, **overrides)
        t, x, k, mask, gen = long_wide_inputs(device, B, N, sparse=sparse)
        near = near_kink_jets(packed, t, x, k, mask)
        g = torch.randn((B, N, 11), generator=gen, device=device) * (~near)[:, None, None]
        if sparse:  # enough jets held with a particle past slot 128
            held = ((~near) & (mask[:, 128:, 0].sum(dim=1) > 0)).sum()
            assert held >= B // 16, int(held)
        hold_wide_backward(packed, t, x, k, mask, g)


def test_wide_kernels_refuse_257_slots(device):
    """At N = 257 both wrappers raise and both C entry points return
    cudaErrorInvalidValue; nothing is launched."""
    from multimodal_particles_tpu_torch.ops import _build

    wide = packed_model(device, 128, 1, wide=True)
    t, x, k, mask, gen = inputs(device, 2, 257)
    g = torch.randn((2, 257, 11), generator=gen, device=device)
    launches = epic_forward_wide.launches, epic_backward_wide.launches
    with pytest.raises(ValueError, match="outside"):
        epic_forward_wide(wide, t, x, k, mask)
    with pytest.raises(ValueError, match="outside"):
        epic_backward_wide(wide, t, x, k, mask, g)
    assert (epic_forward_wide.launches, epic_backward_wide.launches) == launches
    lib = _build.load_library()
    stages, tables = wide.tensor_core
    out = torch.empty((2, 257, 11), device=device)
    k32 = k.to(torch.int32).contiguous()
    assert lib.mmp_epic_wide_forward(wide.flat.data_ptr(), stages.data_ptr(), tables.data_ptr(),
                                     t.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(),
                                     out.data_ptr(), None, 2, 257, wide.dims.c_array(), 0) == 1
    import ctypes
    grid, floats = ctypes.c_int(0), ctypes.c_longlong(0)
    assert lib.mmp_epic_wide_backward_workspace(2, 257, wide.dims.c_array(), ctypes.byref(grid),
                                                ctypes.byref(floats)) == 1


def scaled_transdim_model(device, width, n):
    """The transdimensional model with its trunk at every width `width` (2
    blocks: the `--scaled` and scaled-256 trunks) and n slots; its stacks
    read width + 8 and width + 11 columns."""
    config = TransdimensionalEpicConfig()
    config.data.max_num_particles = n
    e = config.encoder
    e.num_blocks = 2
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = width
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = width
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), 0).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=device))
    return model.eval()


@pytest.mark.parametrize("N", [129, 256])
@pytest.mark.parametrize("width", [128, 256])
def test_gsdm_stack_past_128_slots_at_the_scaled_stack_inputs(device, width, N):
    """K7's two-row-block instances at the input widths the scaled and
    scaled-256 transdim paths feed them past 128 slots (Din 136 / 139 and
    264 / 267) against the plain version at 2e-4, jet 0 of one live slot;
    the same bits on a repeat; then the model's `forward_kernel` at that N
    through one K4 and two K7 launches, within 5e-4 of the module path."""
    model = scaled_transdim_model(device, width, N)
    net = model.network
    _, rate_stack, vec_stack = model.pack_for_kernel()
    assert (rate_stack.dim_in, vec_stack.dim_in) == (width + 8, width + 11)
    gen = torch.Generator(device=device).manual_seed(9)
    B = 133
    for packed, blocks in ((rate_stack, net.blocks()[0]), (vec_stack, net.blocks("vec_")[0])):
        x_in = torch.randn((B, N, packed.dim_in), generator=gen, device=device)
        x_in[0, 1:] = 0.0
        with torch.no_grad():
            tp = stack_time_embeddings(net.time_embedding(torch.rand((B,), generator=gen,
                                                                     device=device)), blocks)
        got = gsdm_stack(packed, tp, x_in, n_heads=2)
        again = gsdm_stack(packed, tp, x_in, n_heads=2)
        torch.cuda.synchronize()
        ref = gsdm_stack_reference(packed, tp, x_in, n_heads=2)
        assert torch.isfinite(got).all() and torch.equal(got, again)
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert model._pallas_enabled(device) and model.kernel_refusal() is None
    state, ts = transdim_state(device, 32, N)
    nearest = torch.zeros(32, dtype=torch.long, device=device)
    counts = epic_forward_wide.launches, gsdm_stack.launches
    got = model.forward_kernel(state, ts, nearest)
    torch.cuda.synchronize()
    assert (epic_forward_wide.launches, gsdm_stack.launches) == (counts[0] + 1, counts[1] + 2)
    with torch.no_grad():
        ref = model.network(state, ts, nearest)
    for g, r in zip(got[:5], ref[:5]):
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-4 * max(r.abs().max().item(), 1.0))


@pytest.mark.parametrize("N", [129, 256])
def test_scaled_mbm_and_absorbing_take_the_wide_kernels_past_128_slots(device, N):
    """At max_num_particles 129 and 256 the MBM wide gate is on and a train
    step runs K4 + K5 (every encoder gradient finite), and AbsorbingFlow
    packs its trunk for K4 (its `forward_sampling` one K4 and one K6 launch,
    within 2e-4 of the module path)."""
    config = MultimodalBridgeMatchingConfig()
    scale_encoder(config, 2)
    config.data.max_num_particles = N
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, 0)
    model = model.to(device)
    assert model.wide_kernel_enabled(device)
    t, x, k, mask, _ = long_wide_inputs(device, 16, N)
    fwd, bwd = epic_forward_wide.launches, epic_backward_wide.launches
    packed = pack_wide_encoder_params(model.encoder, config, differentiable=True)
    (epic_train_forward_wide(packed, t, x, k, mask) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert (epic_forward_wide.launches, epic_backward_wide.launches) == (fwd + 1, bwd + 1)
    for name, p in model.encoder.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name

    from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState

    absorbing = absorbing_model(device, scaled_blocks=2)
    absorbing.config.data.max_num_particles = N
    trunk, _ = absorbing.pack_for_kernel()
    assert trunk is not None and trunk.layout == "wide"
    t, x, k, mask = scattered_inputs(device, 16, N)
    state = AbsorbingBridgeState(t, x, k, mask.long())
    counts = epic_forward_wide.launches, survival_head.launches
    heads = absorbing.forward_sampling(state)
    torch.cuda.synchronize()
    assert (epic_forward_wide.launches, survival_head.launches) == (counts[0] + 1, counts[1] + 1)
    with torch.no_grad():
        ref = absorbing.forward(state)
    for name in ("continuous", "discrete", "absorbing"):
        r = getattr(ref, name)
        torch.testing.assert_close(getattr(heads, name), r, rtol=2e-4,
                                   atol=2e-4 * max(r.abs().max().item(), 1.0))


# ------------------- K1, K2 and K3 at every narrow width and past 256 slots


PADDED_WIDTHS = [8, 20, 24, 40, 48, 56]  # zero-padded to 16, 32, 32, 48, 48 (its own), 64
PAST_256_N = [257, 300, 384, 511, 512]


@pytest.mark.parametrize("N", [128, 200])
@pytest.mark.parametrize("hidden", PADDED_WIDTHS)
def test_epic_forward_at_padded_widths(device, hidden, N):
    """K1 on a packing zero-padded to the next instance: its outputs and its
    hidden output, at the model's width, against the plain version, per
    particle (as at hidden 64: at hidden 20, N = 128 one logit of 0.0036, a
    difference of larger terms, parts by 1.2e-4 between two float32 sums in
    other orders on an H100)."""
    packed = k1_packed(device, hidden)
    assert packed.dims.hidden_local == hidden and packed.dims.hidden >= hidden
    k1_case(device, packed, N, per_particle=True)


@pytest.mark.parametrize("N", PAST_256_N)
@pytest.mark.parametrize("hidden", [16, 24, 64])
def test_epic_forward_past_256_slots(device, hidden, N):
    """K1 on jets of 257 to 512 slots, a cluster of two row blocks a jet
    (per particle, as past 128)."""
    k1_case(device, k1_packed(device, hidden), N)


@pytest.mark.parametrize("head_width,fold", [(56, False), (None, True)], ids=["head56", "folded"])
def test_epic_forward_family_trunks_past_256_slots(device, head_width, fold):
    """The absorbing trunk's instance (the 56-wide head) and the
    transdimensional one's (the folded input, no head) at hidden 24, N = 384."""
    k1_case(device, k1_packed(device, 24, head_width=head_width, fold=fold), 384)


K2_EDGE_CASES = ([(hidden, N) for hidden in (8, 24, 48, 64) for N in (128, 200)]
                 + [(hidden, N) for hidden in (16, 24, 64) for N in PAST_256_N])


@pytest.mark.parametrize("hidden,N", K2_EDGE_CASES)
def test_sampler_step_at_padded_widths_and_past_256_slots(device, hidden, N):
    """K2 at the padded widths and the new instance, and on jets of 257 to
    512 slots, against its plain version."""
    sampler_case(device, hidden, N, 0.5)


@pytest.mark.parametrize("hidden", [8, 24, 40, 48, 56])
def test_epic_backward_at_padded_widths(device, hidden):
    """K3 on a packing zero-padded to the next instance (its gradient on the
    pads held to the plain version's 0 with the rest), N = 128 and 200."""
    packed = packed_model(device, hidden, 2)
    for N in (128, 200):
        hold_k3(packed, *k3_inputs(device, 133, N))


@pytest.mark.parametrize("N", PAST_256_N)
@pytest.mark.parametrize("hidden", [16, 24, 64])
def test_epic_backward_past_256_slots(device, hidden, N):
    """K3 on jets of 257 to 512 slots (two row blocks a jet) on random masks,
    then on sparse scattered masks, of whose jets held out of the near-kink
    window B/16 must have a particle past slot 256."""
    packed = packed_model(device, hidden, {16: 2, 24: 2, 64: 4}[hidden])
    hold_k3(packed, *k3_inputs(device, 133, N))
    B = 256
    t, x, k, mask, gen = k3_inputs(device, B, N, seed=8)
    sparse = (torch.rand((B, N, 1), generator=gen, device=device) < 19 / N).float()
    sparse[::2, N - 1] = 1.0
    mask.copy_(sparse)
    x.mul_(mask)
    k.mul_(mask.long())
    near = near_kink_jets(packed, t, x, k, mask)
    held = ((~near) & (mask[:, 256:, 0].sum(dim=1) > 0)).sum()
    assert held >= B // 16, int(held)
    hold_k3(packed, t, x, k, mask, gen)


def test_narrow_kernels_refuse_hidden_72_and_513_slots(device):
    """At hidden 72 (no instance, past the padding's 64) and at N = 513 the
    three wrappers raise and the three C entry points return
    cudaErrorInvalidValue; nothing is launched."""
    import ctypes

    from multimodal_particles_tpu_torch.ops import _build

    lib = _build.load_library()
    launches = epic_forward.launches, sampler_step.launches, epic_backward.launches
    wide72 = k1_packed(device, 72)
    assert wide72.dims.hidden == 72 and wide72.tensor_core[0].numel() > 0
    t, x, k, mask, gen = inputs(device, 2, 64)
    with pytest.raises(ValueError, match="hidden width 72"):
        epic_forward(wide72, t, x, k, mask)
    packed = packed_model(device, sampler=True)
    t, x, k, mask, gen = inputs(device, 2, 513)
    g = torch.randn((2, 513, 11), generator=gen, device=device)
    u = torch.rand((2, 2, 513), generator=gen, device=device)
    with pytest.raises(ValueError, match="outside"):
        epic_forward(packed, t, x, k, mask)
    with pytest.raises(ValueError, match="outside"):
        sampler_step(packed, x, k, mask, u, 0.5, 0.01, gamma=0.125)
    with pytest.raises(ValueError, match="outside"):
        epic_backward(packed, t, x, k, mask, g)
    assert (epic_forward.launches, sampler_step.launches, epic_backward.launches) == launches
    (buf,) = packed.tensor_core
    k32 = k.to(torch.int32).contiguous()
    out = torch.empty((2, 513, 11), device=device)
    x_out, k_out = torch.empty_like(x), torch.empty_like(k32)
    for dims, n, buffer in ((packed.dims, 513, buf), (wide72.dims, 64, wide72.tensor_core[0])):
        assert lib.mmp_epic_forward(buffer.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(),
                                    mask.data_ptr(), out.data_ptr(), None, 2, n,
                                    dims.c_array(), 0) == 1
        assert lib.mmp_sampler_step(buffer.data_ptr(), x.data_ptr(), k32.data_ptr(),
                                    mask.data_ptr(), u.data_ptr(), x_out.data_ptr(),
                                    k_out.data_ptr(), 0.5, 0.01, 0.125, 2, n,
                                    dims.c_array(), 0) == 1
        grid, floats = ctypes.c_int(0), ctypes.c_longlong(0)
        assert lib.mmp_epic_backward_workspace(2, n, dims.c_array(), ctypes.byref(grid),
                                               ctypes.byref(floats)) == 1
        assert lib.mmp_epic_backward(buffer.data_ptr(), packed.flat.data_ptr(), t.data_ptr(),
                                     x.data_ptr(), k32.data_ptr(), mask.data_ptr(), g.data_ptr(),
                                     out.data_ptr(), None, out.data_ptr(), 2, 2, n,
                                     dims.c_array(), 0) == 1
    torch.cuda.synchronize()
