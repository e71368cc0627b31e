#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi); no card → fail
  2. build    compile ops/csrc/*.cu with nvcc (sm_90a) and load the library
  3. K1       fused EPiC forward vs its plain PyTorch version, config-berlin
              (elementwise atol/rtol 1e-4) and hidden 64 / 4 blocks (per
              particle: rtol scaled by the particle's largest output),
              B=1024, N=128, random masks with empty jets; then both timed
              with CUDA events at B=32768
  4. K2       one fused sampler step vs its plain version at three times with
              the same uniforms; then both timed at B=32768
  5. slice    MultiModalBridgeMatching(config-berlin, 100 timesteps).predict
              serves requests of 1024, 8192 and 32768 jets; each request
              must launch K2 99 times and call no plain version. Each
              response also carries the model's heads at the last time,
              which `forward_kernel` computes with one launch of K1.
  6. paths    the 99-step kernel path vs the plain module path at B=1024
              with the same generator seed (informational, loose bounds:
              ≤ 1% token mismatch, median |Δx|/max(|x|, 1) ≤ 1e-4)

The line before the last lists every kernel; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. Uses
torch, numpy, the standard library and the port only. fp32 with TF32 off.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.data import gauss_noise_source_batch
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_forward_reference,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import (
    sampler_step,
    sampler_step_reference,
)

ROOT = Path(__file__).resolve().parent
ATOL = RTOL = 1e-4
MAX_TOKEN_MISMATCH = 0.01
N = 128
SEED = 0
REQUEST_SIZES = (1024, 8192, 32768)
CHECK_B = 1024
TIMING_B = 32768


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_model(device, hidden=16, num_blocks=2, num_timesteps=100):
    config = MultimodalBridgeMatchingConfig()
    config.encoder.dim_hidden_local = config.encoder.dim_hidden_glob = hidden
    config.encoder.num_blocks = num_blocks
    config.bridge.num_timesteps = num_timesteps
    model = MultiModalBridgeMatching(config)
    init_mbm_parameters(model, SEED)
    return model.to(device).eval()


def random_inputs(B, device, gen):
    """t, x, k, mask at N=128: multiplicities uniform in [1, N], the first
    4 jets empty, and a Bernoulli(0.9) mask on top in every other jet."""
    batch = gauss_noise_source_batch(B, N, 3, 8, gen, device=device)
    mask = batch.source_mask
    mask[:4] = 0.0
    holes = torch.rand(mask.shape, generator=gen, device=device) < 0.1
    mask[1::2] = torch.where(holes[1::2], 0.0, mask[1::2])
    t = torch.rand((B, 1, 1), generator=gen, device=device)
    return t, batch.source_continuous, batch.source_discrete, mask


def compare(got, ref):
    """Elementwise |err| <= ATOL + RTOL·|ref|, and the per-particle form
    |err| <= ATOL + RTOL·max|ref| over the particle's output row."""
    err = (got - ref).abs()
    row_scale = ref.abs().amax(dim=-1, keepdim=True)
    return {
        "max_abs_err": err.max().item(),
        "max_rel_err": (err / ref.abs().clamp_min(1e-3)).max().item(),
        "within_tol": bool((err <= ATOL + RTOL * ref.abs()).all().item()),
        "within_tol_per_particle": bool((err <= ATOL + RTOL * row_scale).all().item()),
    }


def cuda_ms(fn, iters=10):
    """Mean time of one call, by CUDA events over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kernel_fn, plain_fn):
    """Plain, kernel, kernel, plain; each number is the mean of its two turns."""
    p1, k1, k2, p2 = cuda_ms(plain_fn), cuda_ms(kernel_fn), cuda_ms(kernel_fn), cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_k1(device, card):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = []
    # config-berlin is held elementwise. At hidden 64 / 4 blocks the outputs
    # reach ~1e4 and small ones are differences of such terms: the plain
    # version in float32 itself misses its float64 evaluation by 7-33x the
    # elementwise bound there, so that width is held per particle.
    for hidden, blocks, gate in ((16, 2, "within_tol"), (64, 4, "within_tol_per_particle")):
        model = make_model(device, hidden, blocks)
        packed = pack_mbm_encoder_params(model.encoder, model.config)
        t, x, k, mask = random_inputs(CHECK_B, device, gen)
        got = epic_forward(packed, t, x, k, mask)
        torch.cuda.synchronize()
        cmp = compare(got, epic_forward_reference(packed, t, x, k, mask))
        cmp.update(hidden=hidden, num_blocks=blocks, B=CHECK_B, N=N, gate=gate,
                   finite=bool(torch.isfinite(got).all().item()),
                   empty_jets_zero_cont=bool((got[:4, :, :3] == 0).all().item()))
        results.append(cmp)
        emit({"phase": "K1", **cmp})
        if not (cmp[gate] and cmp["finite"] and cmp["empty_jets_zero_cont"]):
            raise RuntimeError(f"K1 disagrees with its plain version: {cmp}")

    model = make_model(device)
    packed = pack_mbm_encoder_params(model.encoder, model.config)
    t, x, k, mask = random_inputs(TIMING_B, device, gen)
    ms, plain_ms = time_pair(lambda: epic_forward(packed, t, x, k, mask),
                             lambda: epic_forward_reference(packed, t, x, k, mask))
    timing = {"phase": "K1_time", "B": TIMING_B, "N": N, "ms": ms, "plain_ms": plain_ms, "card": card}
    emit(timing)
    return max(r["max_abs_err"] for r in results), ms, plain_ms


def phase_k2(device, card):
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    model = make_model(device)
    packed = pack_mbm_encoder_params(model.encoder, model.config)
    gamma = model.config.bridge.gamma
    _, dt = model.time_grid()
    _, x, k, mask = random_inputs(CHECK_B, device, gen)
    k = k.to(torch.int32)
    u = torch.rand((2, CHECK_B, N), generator=gen, device=device)
    real = mask[..., 0] > 0
    worst = 0.0
    for t in (0.0101, 0.5, 1.0 - 1e-4):
        x_new, k_new = sampler_step(packed, x, k, mask, u, t, dt, gamma=gamma)
        torch.cuda.synchronize()
        x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, t, dt, gamma=gamma)
        cmp = compare(x_new, x_ref)
        mismatch = ((k_new != k_ref)[..., 0] & real).sum().item() / real.sum().item()
        jumps = ((k_ref != k)[..., 0] & real).sum().item() / real.sum().item()
        cmp.update(t=t, dt=dt, token_mismatch=mismatch, jump_fraction=jumps)
        emit({"phase": "K2", **cmp})
        worst = max(worst, cmp["max_abs_err"])
        if not cmp["within_tol"] or mismatch > MAX_TOKEN_MISMATCH:
            raise RuntimeError(f"K2 disagrees with its plain version: {cmp}")

    _, x, k, mask = random_inputs(TIMING_B, device, gen)
    k = k.to(torch.int32)
    u = torch.rand((2, TIMING_B, N), generator=gen, device=device)
    ms, plain_ms = time_pair(
        lambda: sampler_step(packed, x, k, mask, u, 0.5, dt, gamma=gamma),
        lambda: sampler_step_reference(packed, x, k, mask, u, 0.5, dt, gamma=gamma),
    )
    emit({"phase": "K2_time", "B": TIMING_B, "N": N, "ms": ms, "plain_ms": plain_ms, "card": card})
    return worst, ms, plain_ms


def check_generated(out, batch, B):
    x, k = out.continuous, out.discrete
    mask = batch.source_mask
    ok = {
        "shape": tuple(x.shape) == (B, N, 3) and tuple(k.shape) == (B, N, 1),
        "finite": bool(torch.isfinite(x).all().item()),
        "tokens_in_range": bool(((k >= 0) & (k < 8)).all().item()),
        "masked_slots_zero": bool(((x * (1 - mask)) == 0).all().item()
                                  and ((k * (1 - mask).long()) == 0).all().item()),
        "empty_jet_zero": bool((x[-1] == 0).all().item() and (k[-1] == 0).all().item()),
    }
    if not all(ok.values()):
        raise RuntimeError(f"generated jets fail their checks: {ok}")
    return ok


def phase_slice(device, card):
    model = make_model(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    batches = [gauss_noise_source_batch(B, N, 3, 8, gen, device=device, num_empty=1)
               for B in REQUEST_SIZES]
    torch.cuda.synchronize()

    # the main path's run: every count starts at 0 here
    sampler_step.launches = epic_forward.launches = 0
    sampler_step_reference.calls = epic_forward_reference.calls = 0
    for B, batch in zip(REQUEST_SIZES, batches):
        before_k2, before_k1 = sampler_step.launches, epic_forward.launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.predict(batch, generator=gen)
        heads = model.forward_kernel(out.replace(
            time=torch.full((B, 1, 1), model.time_grid()[0][-1], device=device)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        k2, k1 = sampler_step.launches - before_k2, epic_forward.launches - before_k1
        checks = check_generated(out, batch, B)
        if not bool(torch.isfinite(heads.discrete).all().item()):
            raise RuntimeError("final heads are not finite")
        rec = {"phase": "slice", "B": B, "N": N, "steps": k2, "K2_launches": k2,
               "K1_launches": k1, "seconds": seconds, "jets_per_s": B / seconds,
               "card": card, **checks}
        emit(rec)
        if k2 != 99 or k1 != 1:
            raise RuntimeError(f"request of {B} jets launched K2 {k2} and K1 {k1} times")
    plain_calls = sampler_step_reference.calls + epic_forward_reference.calls
    launches = {"epic_forward": epic_forward.launches, "sampler_step": sampler_step.launches}
    emit({"phase": "slice_counts", "launches": launches, "plain_calls": plain_calls})
    if plain_calls != 0:
        raise RuntimeError(f"the main path called a plain version {plain_calls} times")
    return launches


def phase_paths(device):
    model = make_model(device)
    batch = gauss_noise_source_batch(
        CHECK_B, N, 3, 8, torch.Generator(device=device).manual_seed(SEED + 4), device=device,
        num_empty=1)
    out_kernel = model.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 5))
    model.config.parallel.use_pallas = False
    out_plain = model.predict(batch, generator=torch.Generator(device=device).manual_seed(SEED + 5))
    model.config.parallel.use_pallas = "auto"
    real = batch.source_mask[..., 0] > 0
    mismatch = ((out_kernel.discrete != out_plain.discrete)[..., 0] & real).sum().item() / real.sum().item()
    x_plain = out_plain.continuous.abs()[real]
    dx = (out_kernel.continuous - out_plain.continuous).abs()[real]
    rel = dx / x_plain.clamp_min(1.0)
    q = torch.tensor([0.5, 0.99, 1.0], device=device)
    rec = {"phase": "paths", "B": CHECK_B, "steps": 99, "token_mismatch": mismatch,
           "median_abs_dx": dx.median().item(), "max_abs_dx": dx.max().item(),
           "median_rel_dx": rel.median().item(), "max_rel_dx": rel.max().item(),
           "abs_x_q50_q99_max": torch.quantile(x_plain, q).tolist()}
    emit(rec)
    # the untrained model's flow expands |x| a hundredfold over the 99 steps
    # and rounding differences grow with it, so the bound is relative
    if mismatch > MAX_TOKEN_MISMATCH or rec["median_rel_dx"] > 1e-4:
        raise RuntimeError(f"kernel path and plain path diverge: {rec}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    build = _build.build_library()
    _build.load_library()
    ptxas = [line.strip() for line in build.log.splitlines() if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": build.seconds, "library": str(build.path.relative_to(ROOT)),
          "ptxas": ptxas})

    k1_err, k1_ms, k1_plain = phase_k1(device, card)
    k2_err, k2_ms, k2_plain = phase_k2(device, card)
    launches = phase_slice(device, card)
    phase_paths(device)

    kernels = [
        {"name": "epic_forward", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/epic_forward.cu",
         "replaces": "multimodal_particles_tpu/ops/epic_pallas.py:432",
         "launches": launches["epic_forward"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "sampler_step", "route": "cuda",
         "source": "multimodal_particles_tpu_torch/ops/csrc/sampler_step.cu",
         "replaces": "multimodal_particles_tpu/ops/sampler_pallas.py:152",
         "launches": launches["sampler_step"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
