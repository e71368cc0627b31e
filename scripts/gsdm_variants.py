#!/usr/bin/env python3
"""Where K6's and K7's time goes: the survival head and the gsdm stack timed
beside copies of their sources with one part taken out or changed, on one
GPU, in one process.

    python3 scripts/gsdm_variants.py [--other DIR]

Each variant is `ops/csrc/survival_head.cu` and `gsdm_stack.cu` (with the
sources of their wider widths, which their entry points call) with
`gsdm_blocks.cuh` edited as text (EDITS below) and built with nvcc into a
temporary directory, the builds and their sources in parallel. Some variants compute wrong
outputs on purpose; each line gives its largest error against the plain
version as a share of the kernels' gate (|err| ≤ 2e-4 + 2e-4·|ref|), so that
a variant that leaves its part in place shows as one that agrees:

  here          the working tree's kernels
  swizzled      the other shared-memory plan: unpadded tiles with the column
                bits 2–4 XORed by the row, conflict-free for the float2
                accesses too, and a ring of 4 stages (2 ahead) in the room
                the padding took
  no_products   the wgmma products skipped, with their A operands' loads,
                GroupNorm and split: the time of everything else
  no_attention  the attention skipped (q passes to proj_out as it is)
  one_product   a_hi·w_hi alone in the products and the attention, the
                3×TF32 split's two small products left out: what the
                split's accuracy costs

DIR (for example the parent's `ops/csrc`, unpacked with `git archive`) adds
that revision's kernels as "other", called through their own entry points
(scripts/port_kernel_bits.py takes either). The times are CUDA-event means
over 5 launches, each variant in two turns (forward, then backward order),
at the main path's shapes: K6 at the absorbing family's reference head
(Dh=16, B=4096, N=109), K7 at the transdimensional creation stack (Din=27,
B=4096, N=128) and at the `--scaled` one (Din=139), seeded weights.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import kernel_variants as kv  # noqa: E402
import port_kernel_bits as pkb  # noqa: E402
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (  # noqa: E402
    gsdm_stack_reference,
    stack_time_embeddings,
)
from multimodal_particles_tpu_torch.ops.survival_cuda import (  # noqa: E402
    project_time_embeddings,
    survival_head_reference,
)

HEADER = "gsdm_blocks.cuh"
# width 128's instances and the entry points, and the wider widths' and the
# longer jets' instances that the entry points call (a revision before them
# has none)
SOURCES = ("survival_head.cu", "gsdm_stack.cu",
           *(f"{stem}_c{w}.cu" for stem in ("survival_head", "gsdm_stack") for w in (256, 384, 512)),
           *(f"{stem}{c}_r2.cu" for stem in ("survival_head", "gsdm_stack")
             for c in ("", "_c256", "_c384", "_c512")))
TOL = 2e-4
# variant → [(old text, new text)] in gsdm_blocks.cuh
HEADER_EDITS = {
    "swizzled": [
        ("constexpr int LDT = 132;", "constexpr int LDT = 128;"),
        # for r mod 8 = 4a + 2b + c: (a, a ^ c, b) into column bits 2, 3, 4
        ("  return 0 * r;",
         "  return ((r >> 2) & 1) << 2 | ((r ^ (r >> 2)) & 1) << 3 | ((r >> 1) & 1) << 4;"),
        ("constexpr int RING = 3;", "constexpr int RING = 4;"),
    ],
    "no_products": [
        ("  fence_operands(acc);\n  auto step = [&]",
         "  fence_operands(acc);\n"
         "  if (nkt > 0) { cp_async_wait<0>(); __syncthreads(); ring.seq += nkt; return; }\n"
         "  auto step = [&]"),
    ],
    "no_attention": [("  if (row0 >= N) return;\n", "  if (row0 >= N || N > 0) return;\n")],
    "one_product": [
        ("  wgmma_m64n128k8(acc, al, w_hi);\n  wgmma_m64n128k8(acc, ah, w_lo);\n", ""),
        ("  mma(d, al, bh);\n  mma(d, ah, bl);\n", ""),
    ],
}


EDITS = {name: [(HEADER, old, new) for old, new in edits] for name, edits in HEADER_EDITS.items()}


def bind(lib, src):
    """K6's and K7's entry points: before their tensor-core products they
    take no stream, before any width but 128 no width (port_kernel_bits reads
    `gsdm_tensor_core` and `gsdm_width`)."""
    lib.gsdm_tensor_core = "Ring" in (src / HEADER).read_text()
    lib.gsdm_width = "MAX_CL" in (src / HEADER).read_text()
    entries = {}
    for fn_name in ("mmp_survival_head", "mmp_gsdm_stack"):
        argtypes = list(kv._build._SIGNATURES[fn_name])
        if not lib.gsdm_width:
            del argtypes[-2]
        if not lib.gsdm_tensor_core:
            del argtypes[1]
        entries[fn_name] = argtypes
    kv.bind_entries(lib, entries)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gsdm_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    builds = {"here": (kv.CSRC, []), **{name: (kv.CSRC, edits) for name, edits in EDITS.items()}}
    if args.other is not None:
        builds["other"] = (args.other, [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, SOURCES, bind, Path(tmp))
        for name, lib in libs.items():
            kv.emit({"variant": name, "ptxas": lib.ptxas})
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 41)

        absorbing = cs.make_absorbing(device)
        cfg_g = absorbing.config.generator
        _, head = absorbing.pack_for_kernel()
        t, _, _, mask = cs.scattered_inputs(cs.ABS_B, cs.ABS_N, device, gen)
        last = torch.randn((cs.ABS_B, cs.ABS_N, head.dim_hidden), generator=gen, device=device)
        tp6 = project_time_embeddings(absorbing.generator, t, cfg_g.n_attn_blocks,
                                      cfg_g.transformer_dim)
        shapes = {"K6": (
            lambda lib: pkb.survival_head(lib, head, tp6, last, mask.long(), cfg_g.n_heads),
            survival_head_reference(head, tp6, last, mask.long(), n_heads=cfg_g.n_heads),
            {"B": cs.ABS_B, "N": cs.ABS_N, "Dh": head.dim_hidden})}
        for scaled in (False, True):
            model = cs.make_transdim(device, scaled=scaled)
            net, n_heads = model.network, model.config.encoder.n_heads
            _, _, vec_stack = model.pack_for_kernel()
            x_in = torch.randn((cs.TD_B, cs.TD_N, vec_stack.dim_in), generator=gen, device=device)
            with torch.no_grad():
                tp7 = stack_time_embeddings(
                    net.time_embedding(torch.rand((cs.TD_B,), generator=gen, device=device)),
                    net.blocks("vec_")[0])
            shapes[f"K7 Din {vec_stack.dim_in}"] = (
                lambda lib, p=vec_stack, tp=tp7, x=x_in, nh=n_heads: pkb.gsdm_stack(lib, p, tp, x, nh),
                gsdm_stack_reference(vec_stack, tp7, x_in, n_heads=n_heads),
                {"B": cs.TD_B, "N": cs.TD_N, "Din": vec_stack.dim_in})

        for shape, (run, ref, where) in shapes.items():
            times = kv.time_in_turns(libs, run, cs.cuda_ms, 5)
            for name, lib in libs.items():
                kv._build.load_library = lambda lib=lib: lib
                out = run(lib)
                torch.cuda.synchronize()
                share = ((out - ref).abs() / (TOL + TOL * ref.abs())).max().item()
                kv.emit({"kernel": shape, **where, "variant": name, "ms": times[name],
                         "share_of_gate": share, "finite": kv.finite(out), "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
