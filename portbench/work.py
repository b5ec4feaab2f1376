"""Useful work, counted once, whatever computes it.

Operations are counted by `torch.utils.flop_counter.FlopCounterMode` over
the benchmark's plain reference (`portbench/reference/`) on the meta
device, at each utterance's own lengths, B=1, unpadded (a frame count is
rounded up to the U-Net's multiple of 4). So padding, and work a program
does twice, is not counted as work. Counts are exact integers and cached
by shape: the U-Net and the vocoders are linear in the frame count and the
encoder quadratic in the token count, so each is counted at a few lengths
and interpolated exactly (`_poly`); the tests hold the interpolation to a
direct count.

Kernel K1 (`csrc/resblock2d.cu` in the port) computes each ResnetBlock of
the U-Net with the attention site behind it, and the final Block; its
share of the work is the operations of those modules, and its bytes are
each call's input, output and weights, once.
"""

from __future__ import annotations

import functools
import json
import re
from fractions import Fraction
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.tts import AcousticModel, fix_len
from portbench.reference.vocoders import build_vocoder

HERE = Path(__file__).resolve().parent
K1_MODULES = re.compile(
    r"^GradLogPEstimator2d\.(downs\.\d+\.[012]|ups\.\d+\.[012]|mid_block1|mid_attn|mid_block2"
    r"|final_block)$")
K1_ATTN = re.compile(r"\.(downs\.\d+\.2|ups\.\d+\.2|mid_attn)$")


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dense peak of the precision and the bytes over HBM's rate."""
    p = peaks()
    return max(flops / p["dense_flops_per_s"][precision], nbytes / p["hbm_bytes_per_s"])


def _poly(fn, points):
    """An exact polynomial through fn's integer values at `points`
    (Lagrange with fractions); returns n -> int."""
    ys = [fn(x) for x in points]

    def at(n):
        total = Fraction(0)
        for i, (xi, yi) in enumerate(zip(points, ys)):
            term = Fraction(yi)
            for j, xj in enumerate(points):
                if j != i:
                    term *= Fraction(n - xj, xi - xj)
            total += term
        if total.denominator != 1:
            raise ValueError("work is not a polynomial of this degree in the length")
        return int(total)

    return at


class WorkCounter:
    """Counts for one configuration file (its "model" and "vocoder")."""

    def __init__(self, config: dict):
        self.config = config
        with torch.device("meta"):
            self.model = AcousticModel(config["model"])
            self.vocoder = build_vocoder(config["vocoder"])
        self.n_feats = config["model"]["n_feats"]
        self.multi = self.model.multi
        self._unet = {}
        self._train_unet = None

    # ---- direct counts on the meta device
    def _unet_direct(self, T: int, backward: bool = False):
        est = self.model.decoder.estimator
        x = torch.zeros(1, T, self.n_feats, device="meta", requires_grad=backward)
        m = torch.ones(1, T, 1, device="meta")
        t = torch.zeros(1, device="meta")
        spk = torch.zeros(1, self.config["model"]["spk_emb_dim"], device="meta") \
            if self.multi else None
        events = []
        hooks = []
        for name, mod in est.named_modules():
            if K1_MODULES.match("GradLogPEstimator2d." + name):
                hooks.append(mod.register_forward_hook(
                    functools.partial(self._bytes_hook, events, name)))
        try:
            with FlopCounterMode(display=False) as fc:
                out = est(x, m, x, t, spk, (True, 1e-6))
                if backward:
                    out.sum().backward()
        finally:
            for h in hooks:
                h.remove()
        counts = fc.get_flop_counts()
        k1 = sum(sum(v.values()) for k, v in counts.items() if K1_MODULES.match(k))
        return fc.get_total_flops(), k1, self._k1_bytes(events)

    @staticmethod
    def _bytes_hook(events, name, mod, inputs, output):
        nin = sum(t.numel() for t in inputs if isinstance(t, torch.Tensor))
        params = sum(p.numel() for p in mod.parameters())
        events.append((name, nin, output.numel(), params))

    @staticmethod
    def _k1_bytes(events) -> int:
        """Bytes of the K1 calls: a block and the attention fused behind it
        are one call (the block's input, the attention's output); every
        tensor is float32 and counted once."""
        total, i = 0, 0
        while i < len(events):
            name, nin, nout, params = events[i]
            if i + 1 < len(events) and K1_ATTN.search("." + events[i + 1][0]):
                _, _, nout, p2 = events[i + 1]
                params += p2
                i += 1
            total += 4 * (nin + nout + params)
            i += 1
        return total

    def unet(self, frames: int):
        """(all operations, K1's operations, K1's bytes) of one evaluation
        at `frames` valid frames."""
        T = fix_len(frames)
        if T not in self._unet:
            if "fit" not in self._unet:
                pts = (256, 512)
                vals = {p: self._unet_direct(p) for p in pts}
                self._unet["fit"] = [_poly(lambda p, k=k: vals[p][k], pts) for k in range(3)]
            self._unet[T] = tuple(f(T) for f in self._unet["fit"])
        return self._unet[T]

    @functools.lru_cache(maxsize=None)
    def _encoder_fit(self, backward: bool):
        def direct(n):
            enc = self.model.encoder
            kind = self.config["model"]["encoder"]["kind"]
            if kind == "text":
                x = torch.zeros(1, n, dtype=torch.long, device="meta")
            else:
                x = torch.zeros(1, n, self.config["model"]["encoder"]["n_input_feats"],
                                device="meta", requires_grad=backward)
            spk = (torch.zeros(1, self.config["model"]["spk_emb_dim"], device="meta")
                   if self.multi else None)
            lengths = torch.full((1,), n, dtype=torch.int32, device="meta")
            with FlopCounterMode(display=False) as fc:
                mu, logw, _ = enc(x, lengths, None, spk)
                if backward:
                    (mu.sum() + logw.sum()).backward()
            return fc.get_total_flops()

        return _poly(direct, (16, 32, 48))

    def encoder(self, tokens: int, backward: bool = False) -> int:
        return self._encoder_fit(backward)(tokens)

    @functools.cached_property
    def _vocoder_fit(self):
        def direct(n):
            c_in = self.config["vocoder"].get("n_mels") or self.config["vocoder"]["in_channels"]
            c = torch.zeros(1, n, c_in, device="meta")
            with FlopCounterMode(display=False) as fc:
                if self.config["vocoder"]["kind"] == "hifigan":
                    self.vocoder(c)
                else:
                    self.vocoder(c, torch.zeros(1, self.config["vocoder"]["spk_ft_size"],
                                                device="meta"))
            return fc.get_total_flops()

        return _poly(direct, (32, 64))

    def vocoder_ops(self, frames: int) -> int:
        return self._vocoder_fit(frames)

    @functools.cached_property
    def speaker_ops(self) -> int:
        """The speaker MLPs of a multi-speaker model, once an utterance."""
        if not self.multi:
            return 0
        with FlopCounterMode(display=False) as fc:
            self.model.speaker(torch.zeros(1, self.config["model"]["spk_preemb_dim"],
                                           device="meta"))
        return fc.get_total_flops()

    # ---- per unit of work
    def utterance(self, tokens: int, frames: int, steps: int):
        """(operations, K1 operations, K1 bytes) of one synthesized and
        vocoded utterance: the encoder, `steps` evaluations of the U-Net
        and the vocoder, at its own lengths."""
        ops, k1, k1_bytes = self.unet(frames)
        total = (self.encoder(tokens) + steps * ops + self.vocoder_ops(frames)
                 + self.speaker_ops)
        return total, steps * k1, steps * k1_bytes

    def train_utterance(self, tokens: int, frames: int, out_size: int) -> int:
        """Forward and backward operations of one utterance's training
        loss: the encoder at its tokens, the U-Net at its segment
        (min(frames, out_size)). MAS does no arithmetic of this kind."""
        seg = fix_len(min(frames, out_size))
        if self._train_unet is None:
            pts = (256, 512)
            vals = {p: self._unet_direct(p, backward=True)[0] for p in pts}
            self._train_unet = _poly(lambda p: vals[p], pts)
        return self.encoder(tokens, backward=True) + self._train_unet(seg)
