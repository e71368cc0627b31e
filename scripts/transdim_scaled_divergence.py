#!/usr/bin/env python3
"""Where the scaled transdimensional flow's kernel path parts from its module
path, on one GPU.

    python3 scripts/transdim_scaled_divergence.py [--seeds 25 125] [--B 256]

At the `--scaled` backbone (chip_smoke.py's `make_transdim(scaled=True,
gains=True)`), the 48-step sampler runs from the same injected draws
(`chip_smoke.transdim_path_draws`, the batch and the draws from the seed) on:

  module     the `nn.Module` path (use_pallas False), the reference;
  kernel     K4 and K7, every call of either also through its plain version
             on the same inputs (`chip_smoke.KernelShadow`: per call and
             jet, the error over its bound);
  k4_only    K4, with K7's plain version in its place;
  k7_only    K7, with K4's plain version in its place;
  nudge_*    the module path from draws 1 ulp away (`chip_smoke.nudged_draws`),
             and `nudge_init_up_kernel` the kernel path from the first of them:
             the flow's own sensitivity.

Each run is compared with `module` jet by jet (`chip_smoke.jet_divergence`:
over jets of equal final multiplicity, max |Δx| over the jet relative to the
jet's largest |x| on the module path, at least 1). For the jet that parts most
between kernel and module, both trajectories are followed step by step: the
step where they first part by more than 1e-3 of the jet's scale, the jet's
multiplicity at each step, the shadow's worst error over bound on that jet
up to there, and the K7 calls on it whose plain output is not finite. One
JSON line a seed.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference  # noqa: E402
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import gsdm_stack_reference  # noqa: E402

PART = 1e-3  # a jet has parted when max |Δx| exceeds this share of its scale


def plain_k4(packed, t, x, k, mask, output_hidden_local=False):
    return epic_forward_reference(packed, t, x, k, mask, output_hidden_local)


def plain_k7(packed, temb, x_in, *, n_heads):
    return gsdm_stack_reference(packed, temb, x_in, n_heads=n_heads)


def run(model, batch, draws, use_pallas, k4=None, k7=None):
    """predict with K4's or K7's wrapper in the model's module replaced by
    `k4`/`k7` where given; the final state, and each network evaluation's
    flat latents and multiplicities."""
    m = cs.transdim_module
    saved = m.epic_forward_wide, m.gsdm_stack
    m.epic_forward_wide, m.gsdm_stack = k4 or saved[0], k7 or saved[1]
    lats, dims = [], []
    inner = model.net_forward

    def recording(state, *args, **kwargs):
        lats.append(state.get_flat_lats().clone())
        dims.append(state.dims.clone())
        return inner(state, *args, **kwargs)

    model.net_forward = recording
    model.config.parallel.use_pallas = use_pallas
    try:
        out = model.predict(batch, draws=draws)
    finally:
        m.epic_forward_wide, m.gsdm_stack = saved
        del model.net_forward
    torch.cuda.synchronize()
    return out, torch.stack(lats), torch.stack(dims)


def one_seed(seed, B, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = cs.transdim_training_batch(B, cs.TD_N, 3, 8, gen, device=device)
    model = cs.make_transdim(device, batch, scaled=True, gains=True)
    draws = cs.transdim_path_draws(B, gen, device)
    nudged = cs.nudged_draws(draws)
    runs = {"module": run(model, batch, draws, False)}
    with cs.KernelShadow() as shadow:
        runs["kernel"] = run(model, batch, draws, True)
    runs["k4_only"] = run(model, batch, draws, True, k7=plain_k7)
    runs["k7_only"] = run(model, batch, draws, True, k4=plain_k4)
    for name, d in nudged.items():
        runs[f"nudge_{name}"] = run(model, batch, d, False)
    runs["nudge_init_up_kernel"] = run(model, batch, nudged["init_up"], True)

    module, module_lats, module_dims = runs["module"]
    rec = {"seed": seed, "B": B, "N": cs.TD_N, "steps": cs.TD_STEPS, "card": cs.card_line(),
           "max_abs_x_module": module.get_flat_lats().abs().max().item(),
           "kernel_err_over_bound": shadow.worst()}
    for name, (out, _, _) in runs.items():
        if name != "module":
            rec[name] = cs.jet_divergence(out, module)[3]

    # the jet that parts most between kernel and module, step by step
    kernel, kernel_lats, kernel_dims = runs["kernel"]
    scale = module.get_flat_lats().abs().amax(1).clamp_min(1.0)
    split = (kernel.get_flat_lats() - module.get_flat_lats()).abs().amax(1) / scale
    split = torch.where(kernel.dims == module.dims, split, torch.zeros_like(split))
    j = int(split.argmax().item())
    step_scale = module_lats[:, j].abs().amax(1).clamp_min(1.0)
    by_step = (kernel_lats[:, j] - module_lats[:, j]).abs().amax(1) / step_scale
    nudge_lats = runs["nudge_init_up"][1]
    nudge_by_step = (nudge_lats[:, j] - module_lats[:, j]).abs().amax(1) / step_scale
    parted = torch.nonzero(by_step > PART)
    first = int(parted[0].item()) if len(parted) else None
    dims_differ = torch.nonzero(kernel_dims[:, j] != module_dims[:, j])
    upto = len(by_step) if first is None else first + 1
    trunk, stack = torch.stack(shadow.trunk), torch.stack(shadow.stack)  # (calls, B), (2·calls, B)
    rec["worst_jet"] = {
        "jet": j, "dims": int(module.dims[j].item()), "split": split[j].item(),
        "scale_module": module.get_flat_lats()[j].abs().max().item(),
        "scale_kernel": kernel.get_flat_lats()[j].abs().max().item(),
        "first_step_parted": first,
        "first_step_dims_differ": int(dims_differ[0].item()) if len(dims_differ) else None,
        "k4_err_over_bound_until_parted": trunk[:upto, j].max().item(),
        "k7_err_over_bound_until_parted": stack[:2 * upto, j].max().item(),
        "k7_plain_not_finite_calls_until_parted":
            int(torch.stack(shadow.undefined["gsdm_stack"])[:2 * upto, j].sum().item()),
        "k7_plain_not_finite_calls": int(torch.stack(shadow.undefined["gsdm_stack"])[:, j].sum().item()),
        "dims_by_step": module_dims[:, j].tolist(),
        "split_by_step": by_step.tolist(),
        "nudge_init_up_split_by_step": nudge_by_step.tolist(),
    }
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[cs.SEED + 25, cs.SEED + 125])
    parser.add_argument("--B", type=int, default=cs.TD_PATHS_B)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(one_seed(seed, args.B, torch.device("cuda"))), flush=True)


if __name__ == "__main__":
    main()
