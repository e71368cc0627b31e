#!/usr/bin/env python3
"""Where K2's time goes: the fused MBM sampler step timed beside copies of
its source with one part taken out, on one GPU, in one process.

    python3 scripts/k2_variants.py [--other DIR]

Each variant is `ops/csrc/sampler_step.cu` with it or its headers edited as
text (EDITS below, one set for each of the two designs: the FFMA kernel
before the tensor cores and the tensor-core kernel after them, whose
per-warp machinery `narrow_tc.cuh` K2 shares with K1 and whose edits
kernel_variants.py holds; the set is taken by which design the source is)
and built with nvcc into a temporary directory, the builds in parallel. The variants compute wrong outputs on
purpose; each line gives its x' error against the plain version as a share
of K2's gate (atol = rtol = 1e-4) and its token mismatch, so that a variant
that leaves its part in place shows as one that agrees:

  here         the source as it is
  no_products  the per-particle products skipped (local_0's particle part,
               fc_local1's particle third, fc_local2, the output layer, the
               discrete head): the time of everything else
  no_jet_mlp   the per-jet vector-matrix products skipped (the time third of
               local_0, the global MLP, fc_local1's broadcast thirds)
  no_staging   the FFMA kernel: the packed weights no longer staged into
               shared memory for every jet (the stages' barriers stay)
  one_product  the tensor-core kernel: a_hi·w_hi alone, the 3×TF32 split's
               two small products left out: what the split's accuracy costs
  through_l1, per_jet, per_jet_through_l1
               the tensor-core kernel's other designs (each computes what
               "here" does): its persistent blocks reading the buffer through
               L1 in place of staging it once into shared memory; one block a
               jet, which stages the buffer for every jet; one block a jet
               reading it through L1
  three_blocks, five_blocks
               the tensor-core kernel with registers bounded for three or
               five blocks an SM at hidden 16, in place of four

DIR (for example the parent's `ops/csrc`, unpacked with `git archive`) adds
that revision's kernel as "other" and, where it is the other design, its
variants as "other:…". The times are
CUDA-event means over 10 launches, each variant in two turns (forward, then
backward order), at the main path's shape: config-berlin (hidden 16, 2
blocks), B=32768, N=128, t=0.5, seeded weights.
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
from multimodal_particles_tpu_torch.ops.sampler_cuda import (  # noqa: E402
    pack_sampler_params,
    sampler_step_reference,
)

SOURCE = "sampler_step.cu"
# the FFMA design's forward lived in this header; only an earlier revision's
# sources (given with --other) still hold it, and its edits apply to them alone
FFMA_HEADER = "epic_forward.cuh"
# design → variant → [(file, old text, new text)]
EDITS = {
    "ffma": {
        "no_products": [
            (FFMA_HEADER, "    for (int j = 0; j < H; ++j) h[j] = fmaf(w[j * n_l0], xe, h[j]);", ""),
            (FFMA_HEADER, "    for (int j = 0; j < H; ++j) h[j] = fmaf(w[j * n_l0], ke, h[j]);", ""),
            (FFMA_HEADER, "      for (int i = 0; i < H; ++i) acc = fmaf(w[i], h[i], acc);", ""),
            (FFMA_HEADER, "      for (int i = 0; i < H; ++i) acc = fmaf(w[i], l1[i], acc);", ""),
            (FFMA_HEADER,
             "    for (int i = 0; i < H; ++i) acc = fmaf(sw[L.out_c + c * H + i], h[i], acc);", ""),
            (FFMA_HEADER,
             "    for (int i = 0; i < H; ++i) acc = fmaf(sw[L.out_d + v * H + i], h[i], acc);", ""),
            (FFMA_HEADER,
             "      for (int v = 0; v < V; ++v) acc = fmaf(sw[L.h0 + u * V + v], dpre[v], acc);",
             "      for (int v = 0; v < V; ++v) acc += dpre[v];"),
            (FFMA_HEADER,
             "      for (int v = 0; v < V; ++v) disc[v] = fmaf(sw[L.h1 + v * Hd + u], a, disc[v]);",
             "      for (int v = 0; v < V; ++v) disc[v] += a;"),
        ],
        "no_jet_mlp": [
            (FFMA_HEADER, "  const int lane = threadIdx.x & 31;\n  for (int j = lane; j < n_out; j += 32) {\n",
             "  const int lane = threadIdx.x & 31;\n"
             "  if (n_in > 0) { for (int j = lane; j < n_out; j += 32) out[j] = leaky(b[j]);"
             " __syncwarp(); return; }\n  for (int j = lane; j < n_out; j += 32) {\n"),
            (FFMA_HEADER,
             "      for (int i = 0; i < Et; ++i) acc = fmaf(sw[L.w_l0 + j * n_l0 + i], temb[i], acc);",
             ""),
            (FFMA_HEADER,
             "        for (int i = 0; i < Hg; ++i) acc = fmaf(w[i], gnew[i], acc);\n"
             "        for (int i = 0; i < Et; ++i) acc = fmaf(w[Hg + i], temb[i], acc);", ""),
        ],
        "no_staging": [
            (FFMA_HEADER,
             "  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);",
             "  if (n < 0) for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);"),
        ],
    },
    "tensor_cores": {
        **kv.NARROW_TC_EDITS,
        # the other designs: the buffer read through L1 by the persistent
        # blocks; one block a jet, the buffer staged by every jet's block;
        # one block a jet, the buffer read through L1
        "through_l1": [(SOURCE, "  const int staged = total <= MAX_STAGED_BYTES;", "  const int staged = 0;")],
        "per_jet": [(SOURCE, "  const int grid = B < blocks ? B : blocks;", "  const int grid = B;")],
        "per_jet_through_l1": [
            (SOURCE, "  const int staged = total <= MAX_STAGED_BYTES;", "  const int staged = 0;"),
            (SOURCE, "  const int grid = B < blocks ? B : blocks;", "  const int grid = B;"),
        ],
    },
}


def design(csrc):
    return "tensor_cores" if "tf32x3.cuh" in (csrc / SOURCE).read_text() else "ffma"


def bind(lib, src):
    kv.bind_entries(lib, {"mmp_sampler_step": kv._build._SIGNATURES["mmp_sampler_step"]})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    builds = {"here": (kv.CSRC, [])}
    builds.update({name: (kv.CSRC, edits) for name, edits in EDITS[design(kv.CSRC)].items()})
    if args.other is not None:
        builds["other"] = (args.other, [])
        if design(args.other) != design(kv.CSRC):  # the other design's own parts
            builds.update({f"other:{name}": (args.other, edits)
                           for name, edits in EDITS[design(args.other)].items()})
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, (SOURCE,), bind, Path(tmp))
        for name, lib in libs.items():
            kv.emit({"variant": name, "ptxas": lib.ptxas})
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 42)
        model = cs.make_model(device)
        packed = pack_sampler_params(model.encoder, model.config)
        gamma = model.config.bridge.gamma
        _, dt = model.time_grid()
        _, x, k, mask = cs.random_inputs(cs.TIMING_B, device, gen)
        k = k.to(torch.int32)
        u = torch.rand((2, cs.TIMING_B, cs.N), generator=gen, device=device)
        real = mask[..., 0] > 0

        def run(lib):
            return pkb.sampler_step(lib, packed, x, k, mask, u, 0.5, dt, gamma)

        x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, 0.5, dt, gamma=gamma)
        times = kv.time_in_turns(libs, run, cs.cuda_ms, 10)
        for name, lib in libs.items():
            kv._build.load_library = lambda lib=lib: lib
            x_new, k_new = run(lib)
            torch.cuda.synchronize()
            share = ((x_new - x_ref).abs() / (cs.ATOL + cs.RTOL * x_ref.abs())).max().item()
            mismatch = ((k_new != k_ref)[..., 0] & real).sum().item() / real.sum().item()
            kv.emit({"kernel": "K2", "B": cs.TIMING_B, "N": cs.N, "hidden": 16, "variant": name,
                     "ms": times[name], "share_of_gate": share, "token_mismatch": mismatch,
                     "finite": kv.finite(x_new), "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
