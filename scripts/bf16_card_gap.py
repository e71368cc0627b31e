#!/usr/bin/env python3
"""How far the port's bfloat16 module forward on a CUDA card lies from the
same forward on the CPU.

    python3 scripts/bf16_card_gap.py [--seeds 3] [--sizes 64 1024 4096]

For the conditional MBM (config-berlin widths, N = 128, both contexts of
chip_smoke.py's phases 43-45) and the conditional AbsorbingFlow (its
defaults, N = 109), each with seeded weights under `compute_dtype:
"bfloat16"`, and each seed and batch size: the card's heads against the CPU's
from the same weights and inputs, printed per head as shares of the CPU's
own float32-vs-bf16 gap (`mean_share`: mean |card − CPU bf16| over mean
|CPU float32 − CPU bf16|; `max_share`: the largest of each), the share of
jets whose heads differ at all (`parted_jets`), and the largest float32
card-vs-CPU difference beside it. One JSON line a case. Needs one card.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from multimodal_particles_tpu_torch.data import MultimodalDatabatch  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.states import (  # noqa: E402
    AbsorbingBridgeState,
    HybridState,
)


def case(family, seed, B, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    if family == "mbm":
        config = cs.bf16_config(cs.apply_sections(cs.make_config(), cs.CONTEXT))
        model = cs.init_mbm_parameters(cs.MultiModalBridgeMatching(config), seed)
        t, x, k, mask = cs.random_inputs(B, device, gen)
        state = HybridState(t, x, k, mask)
    else:
        config = cs.bf16_config(cs.apply_sections(cs.AbsorbingConfig(), cs.CONTEXT))
        model = cs.init_absorbing_parameters(cs.AbsorbingFlow(config), seed)
        t, x, k, mask = cs.scattered_inputs(B, cs.ABS_N, device, gen)
        state = AbsorbingBridgeState(t, x, k, mask.long())
    model = model.to(device).eval()
    batch = cs.with_contexts(MultimodalDatabatch(x, k, mask), config, gen, device)
    heads, ref = cs.card_against_cpu(model, state, batch)
    f32 = cs.twin(model, cs.apply_sections(copy.deepcopy(config),
                                           {"parallel": {"compute_dtype": "float32"}}))
    heads32, ref32 = cs.card_against_cpu(f32, state, batch)
    out = {"family": family, "seed": seed, "B": B}
    for name in ("continuous", "discrete", "absorbing"):
        if family == "mbm" and name == "absorbing":  # the state's own mask
            continue
        got, bf16, fp32 = getattr(heads, name).cpu(), getattr(ref, name), getattr(ref32, name)
        gap, control = (got - bf16).abs(), (fp32 - bf16).abs()
        out[name] = {"mean_share": (gap.mean() / control.mean()).item(),
                     "max_share": (gap.max() / control.max()).item(),
                     "parted_jets": (gap.reshape(B, -1) > 0).any(dim=1).float().mean().item(),
                     "float32_card_cpu_max": (getattr(heads32, name).cpu() - fp32).abs().max().item()}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--sizes", type=int, nargs="+", default=[64, 1024, 4096])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bf16_card_gap: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    for family in ("mbm", "absorbing"):
        for seed in range(args.seeds):
            for B in args.sizes:
                print(json.dumps(case(family, seed, B, device)), flush=True)


if __name__ == "__main__":
    main()
