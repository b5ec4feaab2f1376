"""Seeds and seeded weights.

Every random input of a run comes from `--seed` through `derive`, one
stream a purpose, so the same seed gives the same inputs and weights on any
machine, and the program and the reference are handed the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

_NORMS = ("GroupNorm", "ChannelLayerNorm", "LayerNorm")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose: `seed` and the tags (strings or ints)
    mixed by NumPy's SeedSequence."""
    words = [int(seed) % 2 ** 64]
    for t in tags:
        words.extend(t.encode() if isinstance(t, str) else [int(t) % 2 ** 64])
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def _scales(module: nn.Module, overrides: Dict[str, float], leaf_bounds: Dict[str, float]):
    """Per tensor (name, shape, scale, offset): weights uniform in
    +-1/sqrt(fan_in) (PyTorch's default bound), a bias in its weight's bound,
    a norm's gain 1 +- 0.1 and its shift +- 0.1, a tensor whose last name is
    in `leaf_bounds` within that bound, and the constants `overrides`
    names."""
    norms = {n for n, m in module.named_modules() if type(m).__name__ in _NORMS}
    params = dict(module.named_parameters())
    out = []
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        shape = tuple(p.shape)
        if name in overrides:
            out.append((name, shape, 0.0, float(overrides[name])))
        elif leaf in leaf_bounds:
            out.append((name, shape, float(leaf_bounds[leaf]), 0.0))
        elif owner in norms:
            out.append((name, shape, 0.1, 1.0 if leaf in ("weight", "gamma") else 0.0))
        elif p.dim() >= 2:
            fan = p.shape[-1] if p.shape[0] == 1 else p.numel() // p.shape[0]
            out.append((name, shape, fan ** -0.5, 0.0))
        else:
            w = params.get(owner + ".weight")
            fan = (w.numel() // w.shape[0]) if w is not None and w.dim() >= 2 else 1
            out.append((name, shape, fan ** -0.5, 0.0))
    return out


def seeded_state(module: nn.Module, seed: int, device, tag: str,
                 overrides: Dict[str, float] | None = None,
                 leaf_bounds: Dict[str, float] | None = None) -> Dict[str, torch.Tensor]:
    """Float32 tensors for every parameter of `module`, drawn on `device` from the seed in one uniform draw,
    then scaled and shifted in two more calls. Returns {name: tensor}, views
    of one buffer."""
    specs = _scales(module, overrides or {}, leaf_bounds or {})
    sizes = [math.prod(s) for _, s, _, _ in specs]
    total = sum(sizes)
    u = torch.rand(total, generator=generator(device, seed, "weights", tag), device=device)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([2.0 * s for _, _, s, _ in specs], device=device), counts)
    shift = torch.repeat_interleave(
        torch.tensor([o - s for _, _, s, o in specs], device=device), counts)
    flat = torch.addcmul(shift, u, scale)
    return {name: t.view(shape) for (name, shape, _, _), t in zip(specs, flat.split(sizes))}


def clone_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in state.items()}


def load(module: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """`module` given `state` as its parameters (the tensors themselves); its
    buffers are none. Raises on a missing or unexpected name."""
    module.load_state_dict(state, strict=True, assign=True)
    return module


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n values at the quantiles (i + 0.5) / n of a length distribution
    named in a traffic file: "uniform" (min, max) or "truncnorm" (a normal
    of spread `sd` cut to [min, max], its location solved so that the n
    values' mean is `mean`: a corpus publishes the mean of its clips as
    they are, after the cut)."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "uniform":
        return lo + q * (hi - lo)
    if dist["dist"] != "truncnorm":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    mean, sd = float(dist["mean"]), float(dist["sd"])
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} outside [{lo}, {hi}]")
    qt = torch.as_tensor(q, dtype=torch.float64)
    ndtr, ndtri = torch.special.ndtr, torch.special.ndtri

    def values(loc: float) -> torch.Tensor:
        a = ndtr(torch.tensor((lo - loc) / sd, dtype=torch.float64))
        b = ndtr(torch.tensor((hi - loc) / sd, dtype=torch.float64))
        return (loc + sd * ndtri(a + qt * (b - a))).clamp(lo, hi)

    x0, x1 = lo - 4.0 * sd, hi + 4.0 * sd  # the values' mean rises with the location
    for _ in range(100):
        xm = 0.5 * (x0 + x1)
        x0, x1 = (xm, x1) if float(values(xm).mean()) < mean else (x0, xm)
    return values(0.5 * (x0 + x1)).numpy()


def shuffled(values: Iterable, seed: int, *tags) -> list:
    values = list(values)
    order = rng(seed, "order", *tags).permutation(len(values))
    return [values[i] for i in order]


def in_rounds(values: Iterable, strata: int, seed: int, *tags) -> list:
    """`values` ordered in rounds that each take one value of every stratum
    (the sorted values cut into `strata` equal runs), the seed drawing
    which value and in what order, so that any stretch of whole rounds has
    the same mix of sizes."""
    values = sorted(values)
    per = len(values) // strata
    if per * strata != len(values):
        raise ValueError(f"{len(values)} values do not cut into {strata} strata")
    g = rng(seed, "rounds", *tags)
    cols = [[values[s * per + i] for i in g.permutation(per)] for s in range(strata)]
    out = []
    for r in range(per):
        out += [cols[s][r] for s in g.permutation(strata)]
    return out
