#!/usr/bin/env python3
"""Where K1's time goes: the fused narrow EPiC forward timed beside copies of
its sources with one part taken out, on one GPU, in one process.

    python3 scripts/k1_variants.py [--other DIR [DIR ...]]

Each variant is K1's two sources (`ops/csrc/epic_forward.cu`,
`epic_forward_fold.cu`) with the kernel (`epic_forward_kernel.cuh`) or the
per-warp machinery it shares with K2 (`narrow_tc.cuh`, whose edits
kernel_variants.py holds) edited as text, built with nvcc into a temporary
directory, the builds in parallel. The variants compute wrong outputs on
purpose; each line gives its error against the plain version as a share of
K1's gate (atol = rtol = 1e-4, elementwise, on the 11 outputs and, where the
call asks for it, the hidden state), so that a variant that leaves its part
in place shows as one that agrees:

  here           the sources as they are
  no_products    the per-particle products skipped (local_0's particle part,
                 fc_local1's particle third, fc_local2, the output layer, the
                 discrete head): the time of everything else
  no_jet_mlp     the per-jet vector-matrix products skipped (the jet's time
                 terms, the global MLP on warp 0, fc_local1's broadcast thirds)
  no_time_terms  only the jet's time terms through g0, fc_global1 and
                 fc_local1 skipped (local_0's kept)
  time_terms_on_warp0  those time terms all on warp 0, in place of spread
                 over the warps
  one_product    a_hi·w_hi alone, the 3×TF32 split's two small products left
                 out: what the split's accuracy costs
  through_l1     the buffer read through L1 in place of staged once a block
  three_blocks, five_blocks  registers bounded for three or five blocks an
                 SM at hidden 16, in place of four

Each DIR (for example the parent's `ops/csrc`, unpacked with `git
archive`) adds that revision's K1 as "other:<DIR's name>" (the FFMA kernel
before the tensor cores reads the packed weights, through the same
signature). The times are CUDA-event
means over 10 launches, each build in two turns (forward, then backward
order), at the main path's three shapes: config-berlin (hidden 16, 2
blocks, B=32768, N=128), the absorbing generator's trunk (56-wide head,
hidden output, B=4096, N=109) and the transdimensional one (folded input,
no head, hidden output, global width 19, B=4096, N=128), seeded weights.
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
from multimodal_particles_tpu_torch.ops.epic_cuda import (  # noqa: E402
    epic_forward_reference,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)

SOURCES = ("epic_forward.cu", "epic_forward_fold.cu")
KERNEL = "epic_forward_kernel.cuh"
TIME_TERMS = "  for (int v = warp; v < n_time; v += nwarps) {"
EDITS = {
    **kv.NARROW_TC_EDITS,
    "no_time_terms": [(KERNEL, TIME_TERMS, "  for (int v = n_time; v < n_time; v += nwarps) {")],
    "time_terms_on_warp0": [(KERNEL, TIME_TERMS,
                             "  for (int v = warp == 0 ? 0 : n_time; v < n_time; ++v) {")],
    "through_l1": [(KERNEL, "  const int staged = total <= MAX_STAGED_BYTES;", "  const int staged = 0;")],
}


def bind(lib, src):
    kv.bind_entries(lib, {name: kv._build._SIGNATURES[name]
                          for name in ("mmp_epic_forward", "mmp_epic_forward_fold")})
    lib.k1_tensor_core = "narrow_tc.cuh" in (src / SOURCES[0]).read_text()


def shapes(device, gen):
    """(name, packing with K1's buffer, (t, x, k, mask), hidden output) of the
    main path's three calls."""
    model = cs.make_model(device)
    berlin = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
    absorbing, _ = cs.make_absorbing(device).pack_for_kernel()
    transdim, _, _ = cs.make_transdim(device).pack_for_kernel()
    state, ts = cs.transdim_state(cs.TD_B, cs.TD_N, device, gen)
    return [
        ("config-berlin", berlin, cs.random_inputs(cs.TIMING_B, device, gen), False),
        ("absorbing", absorbing, cs.scattered_inputs(cs.ABS_B, cs.ABS_N, device, gen), True),
        ("transdim", transdim, (ts.reshape(cs.TD_B, 1, 1), state.continuous, state.discrete,
                                state.particle_mask()[:, :, None]), True),
    ]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, nargs="+", default=[],
                        help="other revisions' csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    builds = {"here": (kv.CSRC, [])}
    builds.update({name: (kv.CSRC, edits) for name, edits in EDITS.items()})
    builds.update({f"other:{other.name}": (other, []) for other in args.other})
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, SOURCES, bind, Path(tmp))
        for name, lib in libs.items():
            kv.emit({"variant": name, "ptxas": lib.ptxas})
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 41)
        for shape, packed, (t, x, k, mask), hidden in shapes(device, gen):
            def run(lib):
                return pkb.epic_forward(lib, packed, t, x, k, mask, hidden)

            refs = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=True)
            times = kv.time_in_turns(libs, run, cs.cuda_ms, 10)
            for name, lib in libs.items():
                kv._build.load_library = lambda lib=lib: lib
                outs = run(lib)
                torch.cuda.synchronize()
                share = max(pkb.share_of_gate(got, ref, cs.ATOL, cs.RTOL)
                            for got, ref in zip(outs, refs))
                kv.emit({"kernel": "K1", "shape": shape, "B": x.shape[0], "N": x.shape[1],
                         "variant": name, "ms": times[name], "share_of_gate": share,
                         "finite": all(kv.finite(o) for o in outs), "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
