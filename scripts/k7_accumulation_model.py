#!/usr/bin/env python3
"""A float64 model of K7's products with the tensor cores' accumulation, on
the worst jets that `k7_long_jets.py --save FILE` kept (CPU only).

    python3 scripts/k7_accumulation_model.py FILE [--fma proj_in conv1 ...] [--jets 2]

The tensor cores add each k-step's products into the accumulator rounding
toward zero. On a jet of one live particle among 256 the live row's hidden
state then carries a one-signed error, which its attention (logits ~250,
weights between 0 and 1) magnifies. The model runs the stack's walk
(`blocks_reference`) with every product split as the kernel splits it
(3×TF32) and accumulated per k-step of 8 either exactly or rounded toward
zero, and with the products that `--fma` names (proj_in, conv1, conv2, q, k,
v, proj_out) as fp32 fused multiply-adds in k order rounded to nearest
(K7 past 128 slots runs the ones ops/csrc/gsdm_blocks.cuh names so). One
line per model: each jet's error over
the bound of chip_smoke.py's transdim check, 2e-4·(1 + max|ref|), against
the float64 walk; the first line is the kernel's and the plain version's
outputs that the file holds.
"""

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_particles_tpu_torch.models.architectures.gsdm import swish  # noqa: E402
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (  # noqa: E402
    blocks_reference,
    stack_layout,
)


def tf32_split(x, truncate=False):
    """x (float32) = hi + lo, both TF32: rounded to nearest, or truncated."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        bits = bits & ~0x1FFF if truncate else (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    hi = tf32(x.float())
    return hi.double(), tf32(x.float() - hi).double()


def toward_zero(y):
    """float64 → float32, rounded toward zero."""
    f = y.float()
    return torch.where(f.double().abs() > y.abs(), torch.nextafter(f, torch.zeros_like(f)),
                       f).double()


def product(a, w, mode, truncate_a=False, truncate_w=False):
    """a (..., K) @ w (..., K, n): "fma" fp32 fused multiply-adds in k order;
    else three TF32 products a k-step of 8, accumulated exactly ("exact") or
    each addition rounded toward zero ("toward_zero")."""
    if mode == "fma":
        acc = torch.zeros(a.shape[:-1] + (w.shape[-1],))
        for k in range(a.shape[-1]):
            acc = (acc.double() + a[..., k:k + 1].float().double()
                   * w[..., k, :].float().double()).float()
        return acc.double()
    ah, al = tf32_split(a, truncate_a)
    wh, wl = tf32_split(w, truncate_w)
    acc = torch.zeros(a.shape[:-1] + (w.shape[-1],), dtype=torch.float64)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            acc = acc + x[..., ks] @ y[..., ks, :]
            if mode == "toward_zero":
                acc = toward_zero(acc)
    return acc


def group_norm(x, scale, bias):
    B, N, C = x.shape
    g = x.reshape(B, N, 32, C // 32)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((g - mu) / torch.sqrt(var + 1e-6)).reshape(B, N, C) * scale + bias


def walk(W, x, temb, dim_in, n_blocks, n_heads, mode, fma=()):
    """The stack as the kernel computes it: products by `product` (`fma`: the
    products taken as fused multiply-adds), tiles stored in float32."""
    f32 = lambda t: t.float().double()  # noqa: E731
    pm = lambda tag: "fma" if tag in fma else mode  # noqa: E731
    h = f32(product(x, W["w_in"][:dim_in], pm("proj_in"), truncate_a=True) + W["b_in"])
    B, N, C = h.shape
    hd = C // n_heads
    for i in range(n_blocks):
        r = product(swish(group_norm(h, W[f"gn1_s_{i}"], W[f"gn1_b_{i}"])), W[f"w_c1_{i}"],
                    pm("conv1"))
        r = f32(r + W[f"b_c1_{i}"] + temb[i][:, None, :])
        r = product(swish(group_norm(r, W[f"gn2_s_{i}"], W[f"gn2_b_{i}"])), W[f"w_c2_{i}"],
                    pm("conv2"))
        h = f32(h + r + W[f"b_c2_{i}"])
        hn = group_norm(h, W[f"gna_s_{i}"], W[f"gna_b_{i}"])
        q, k, v = (f32(product(hn, W[f"w{n}_{i}"], pm(n)) + W[f"b{n}_{i}"])
                   .reshape(B, N, n_heads, hd).transpose(1, 2) for n in "qkv")
        s = product(q * hd ** -0.5, k.transpose(-1, -2), mode, True, True)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        last = v[:, :, -1:, :]  # v centred on the last key's value, as past 128 slots
        o = product(p, v - last, mode, truncate_w=True) / p.sum(-1, keepdim=True) + last
        o = f32(o.transpose(1, 2).reshape(B, N, C))
        h = f32(h + product(o, W[f"wp_{i}"], pm("proj_out")) + W[f"bp_{i}"])
    return h


def share(got, ref):
    bound = 2e-4 * (1 + ref.abs().amax(dim=(1, 2), keepdim=True))
    return ((got - ref).abs() / bound).amax(dim=(1, 2))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("file", type=Path, help="the worst jets saved by k7_long_jets.py --save")
    parser.add_argument("--jets", type=int, default=2, help="how many of the saved jets")
    parser.add_argument("--fma", nargs="*", default=["proj_in", "conv1"],
                        choices=["proj_in", "conv1", "conv2", "q", "k", "v", "proj_out"])
    args = parser.parse_args()
    d = torch.load(args.file)
    flat, W, off = d["flat"].double(), {}, 0
    for name, shape in stack_layout(d["dim_in"], d["n_blocks"], d["channels"]):
        W[name] = flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
    j = slice(0, args.jets)
    x, temb = d["x_in"][j], [t[j].double() for t in d["temb"]]
    h = x.double() @ W["w_in"][:d["dim_in"]] + W["b_in"]
    exact = blocks_reference(W, h, temb, d["n_blocks"], d["n_heads"])
    form = lambda t: [round(v, 4) for v in t.tolist()]  # noqa: E731
    print("saved kernel", form(share(d["kernel"][j].double(), exact)),
          "plain", form(share(d["plain"][j].double(), exact)))
    run = lambda mode, fma=(): walk(W, x, temb, d["dim_in"], d["n_blocks"],  # noqa: E731
                                    d["n_heads"], mode, fma)
    print("model, exact accumulation", form(share(run("exact"), exact)))
    print("model, accumulation toward zero", form(share(run("toward_zero"), exact)))
    print("model, toward zero, as fp32 fma:", " ".join(args.fma),
          form(share(run("toward_zero", tuple(args.fma)), exact)))


if __name__ == "__main__":
    main()
