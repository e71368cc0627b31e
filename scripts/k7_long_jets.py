#!/usr/bin/env python3
"""K7 on jets of more than 128 slots, on one GPU: its worst calls on the
seeded transdimensional flow against a float64 evaluation, and its time
against N.

    python3 scripts/k7_long_jets.py [--n 256] [--calls 3] [--time-n 128 129 192 256]
                                    [--scaled WIDTH] [--save FILE]

The flow is chip_smoke.py's `paths_transdim` check at N = `--n` (the
reference transdimensional config, the 48-step sampler from injected draws,
`chip_smoke.phase_paths_transdim`), which runs every K7 call of the kernel
path also through its plain version (`chip_smoke.KernelShadow`: per jet, the
error over the gate's bound 2e-4·(1 + max|ref|)). The `--calls` worst calls
are kept and evaluated again: the kernel, the plain version in float32 on
the card and on the CPU, and the plain version in float64 on the card; one
JSON line each with the worst jet's share against each, its live rows and
magnitudes. The phase's own line (and its pass or fail) comes first. With
`--scaled WIDTH` the flow is the scaled one (every trunk width WIDTH, the
stacks reading WIDTH + 8 and WIDTH + 11 columns, the data-dependent gains:
`paths_transdim_scaled`); with `--save FILE` the worst call's inputs, time
rows and kernel output of its 8 worst jets go to FILE (torch.save). Then
K7 at B=4096, 128 × 2 heads, Din 27, timed with CUDA events at each N of
`--time-n`: at 129 a jet already takes two row blocks (two SMs).
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from multimodal_particles_tpu_torch.ops import _build  # noqa: E402
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (  # noqa: E402
    PackedGsdmStack,
    gsdm_stack,
    gsdm_stack_reference,
)


def on_cpu(packed):
    return PackedGsdmStack(packed.flat.cpu(), {k: v.cpu() for k, v in packed.tensors.items()},
                           packed.dim_in, packed.n_blocks, packed.tensor_core.cpu(),
                           packed.channels)


def share(got, ref):
    """Per jet: the largest error over the bound of `paths_transdim`'s shadow."""
    return cs.jet_err_over_bound(got.double(), ref.double(), cs.K7_TOL)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--time-n", type=int, nargs="*", default=[128, 129, 192, 256])
    parser.add_argument("--scaled", type=int, default=0, help="the trunk's width (0: reference)")
    parser.add_argument("--save", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_long_jets: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = cs.card_line()
    _build.load_library()

    kept = []  # (worst share of the call, packed, time rows, input)
    shadow_stack = cs.KernelShadow._stack

    def keeping(self, packed, temb, x_in, *, n_heads):
        out = shadow_stack(self, packed, temb, x_in, n_heads=n_heads)
        kept.append((self.stack[-1].max().item(), packed, [t.clone() for t in temb],
                     x_in.clone(), n_heads))
        kept.sort(key=lambda call: -call[0])
        del kept[args.calls:]
        return out

    cs.KernelShadow._stack = keeping
    try:
        cs.phase_paths_transdim(device, scaled=args.scaled or False,
                                phase=f"paths_transdim_n{args.n}", n=args.n)
        passed = True
    except RuntimeError:
        passed = False
    finally:
        cs.KernelShadow._stack = shadow_stack
    print(json.dumps({"phase": "k7_long_jets_check", "n": args.n, "scaled": args.scaled,
                      "passed": passed, "card": card}), flush=True)

    for worst, packed, temb, x_in, n_heads in kept:
        got = gsdm_stack(packed, temb, x_in, n_heads=n_heads)
        plain = gsdm_stack_reference(packed, temb, x_in, n_heads=n_heads)
        plain_cpu = gsdm_stack_reference(on_cpu(packed), [t.cpu() for t in temb], x_in.cpu(),
                                         n_heads=n_heads).to(device)
        exact = cs.gsdm_stack_float64(packed, temb, x_in, n_heads)
        kernel_plain, kernel_exact = share(got, plain), share(got, exact)
        j = int(kernel_plain.nan_to_num(0).argmax())
        print(json.dumps({
            "phase": "k7_long_jets_call", "n": args.n, "din": packed.dim_in,
            "worst_in_shadow": worst, "kernel_vs_plain": kernel_plain.max().item(),
            "kernel_vs_float64": kernel_exact.max().item(),
            "plain_vs_float64": share(plain, exact).max().item(),
            "cpu_plain_vs_float64": share(plain_cpu, exact).max().item(),
            "jet": j, "jet_kernel_vs_plain": kernel_plain[j].item(),
            "jet_kernel_vs_float64": kernel_exact[j].item(),
            "jet_plain_vs_float64": share(plain, exact)[j].item(),
            "jet_live_rows": int((x_in[j].abs().sum(-1) > 0).sum().item()),
            "jet_max_abs_in": x_in[j].abs().max().item(),
            "jet_max_abs_out": exact[j].abs().max().item(), "card": card}), flush=True)
        if args.save is not None and worst == kept[0][0]:
            jets = kernel_plain.nan_to_num(0).argsort(descending=True)[:8]
            torch.save({"jets": jets.cpu(), "x_in": x_in[jets].cpu(),
                        "temb": [t[jets].cpu() for t in temb], "kernel": got[jets].cpu(),
                        "plain": plain[jets].cpu(), "n_heads": n_heads,
                        "flat": packed.flat.cpu(), "dim_in": packed.dim_in,
                        "n_blocks": packed.n_blocks, "channels": packed.channels}, args.save)

    model = cs.make_transdim(device, n=max(args.time_n))
    _, _, vec_stack = model.pack_for_kernel()
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    for n in args.time_n:
        x_in = torch.randn((cs.TD_B, n, vec_stack.dim_in), generator=gen, device=device)
        temb = tuple(torch.randn((cs.TD_B, 128), generator=gen, device=device)
                     for _ in range(vec_stack.n_blocks))
        ms = cs.cuda_ms(lambda: gsdm_stack(vec_stack, temb, x_in, n_heads=2))
        print(json.dumps({"phase": "k7_long_jets_time", "B": cs.TD_B, "N": n,
                          "din": vec_stack.dim_in, "ms": ms, "card": card}), flush=True)


if __name__ == "__main__":
    main()
