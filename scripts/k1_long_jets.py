#!/usr/bin/env python3
"""How close K1 and its plain version come to a float64 evaluation of the
same function, at N = 128 and at N = 256, on one GPU.

    python3 scripts/k1_long_jets.py [--other DIR]

K1's card gate is elementwise (|err| ≤ 1e-4 + 1e-4·|ref|) up to N = 128 and
per particle (rtol scaled by the particle's largest output) at hidden 64;
this script measures which form float32 evaluations can hold past N = 128,
where a jet's pooled sums run over up to 256 particles. For each encoder
(config-berlin's at hidden 16, 32 and 64; the absorbing trunk with its
56-wide head; the transdimensional trunk with the folded input) and N, one
JSON line gives, as shares of each form of the gate: the plain version in
float32 against the plain version in float64 (the same code on float64
weights and inputs), and each build's kernel against both. DIR (for example
the parent's `ops/csrc`, unpacked with `git archive`) adds that revision's
K1 beside the working tree's, built by `port_kernel_bits.build`. B = 133
jets, random non-prefix masks (keep rate 0.6), the last jet empty, seeded
weights; hidden output on.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import port_kernel_bits as pkb  # noqa: E402
from multimodal_particles_tpu_torch.models.architectures.utils import (  # noqa: E402
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.ops import _build  # noqa: E402
from multimodal_particles_tpu_torch.ops.epic_cuda import (  # noqa: E402
    epic_forward_reference,
    forward_from_temb,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)


def plain64(packed, t, x, k, mask):
    """The plain version on float64 weights and inputs: (out, hidden)."""
    temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]).double(), packed.dims.emb_t)
    cont, disc, h = forward_from_temb(packed.rebind(packed.flat.double()), temb, x.double(),
                                      k.double() if packed.dims.fold_discrete else k,
                                      mask.double(), return_hidden=True)
    return torch.cat([cont, disc], dim=-1), h


def shares(got, ref):
    """The largest share of K1's gate over (out, hidden), elementwise and per particle."""
    return {form: max(pkb.share_of_gate(g.double(), r.double(), cs.ATOL, cs.RTOL, per_particle)
                      for g, r in zip(got, ref))
            for form, per_particle in (("elementwise", False), ("per_particle", True))}


def encoders(device):
    """(name, packing with K1's buffer) of the five encoders."""
    out = []
    for hidden in (16, 32, 64):
        model = cs.make_model(device, hidden)
        out.append((f"config-berlin hidden {hidden}",
                    with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))))
    out.append(("absorbing (56-wide head)", cs.make_absorbing(device).pack_for_kernel()[0]))
    out.append(("transdim (folded input, no head)", cs.make_transdim(device).pack_for_kernel()[0]))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_long_jets: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 43)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"here": ROOT / "multimodal_particles_tpu_torch" / "ops" / "csrc"}
        if args.other is not None:
            dirs["other"] = args.other
        libs = {name: pkb.build(path, Path(tmp) / name, ["K1"]) for name, path in dirs.items()}
        for name, packed in encoders(device):
            for n in (128, 256):
                t, x, k, mask = pkb.inputs(133, n, device, gen)
                if packed.dims.fold_discrete:
                    k = torch.randn((133, n, 8), generator=gen, device=device) * mask
                ref32 = epic_forward_reference(packed, t, x, k, mask, output_hidden_local=True)
                ref64 = plain64(packed, t, x, k, mask)
                rec = {"encoder": name, "B": 133, "N": n, "plain32_vs_plain64": shares(ref32, ref64)}
                for build, lib in libs.items():
                    _build.load_library = lambda lib=lib: lib
                    got = pkb.epic_forward(lib, packed, t, x, k, mask, True)
                    torch.cuda.synchronize()
                    rec[f"{build}_vs_plain32"] = shares(got, ref32)
                    rec[f"{build}_vs_plain64"] = shares(got, ref64)
                print(json.dumps({**rec, "card": card}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
