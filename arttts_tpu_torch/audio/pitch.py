"""Batched F0 (YIN) and frame loudness, the source channels of the SPARC
encoder (port of `arttts_tpu/audio/pitch.py`).

YIN (de Cheveigné & Kawahara 2002) as the JAX package computes it: the
difference function from an FFT cross-correlation (n_fft the next power of
two >= 2L) and the running energy, the cumulative-mean-normalised
difference, the first local minimum under the threshold (else the global
argmin), parabolic interpolation on the raw difference clipped to +-1, and
a median of width 3 over the voiced entries only. Tensors in, tensors out,
on the input's device: (B, T_samples) -> (B, n_frames).

A voicing decision is a threshold on a float32 quantity, so it can flip
where two FFTs (pocketfft, cuFFT) differ by an ulp on a frame whose CMND
minimum sits at the threshold; clean voiced or silent frames are far from it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    sample_rate: int = 16000
    hop: int = 320            # 50 Hz frames at 16 kHz (SPARC's frame rate)
    frame_length: int = 1024  # integration window + max lag
    f0_min: float = 50.0
    f0_max: float = 550.0
    threshold: float = 0.15   # YIN absolute threshold on the CMND
    median_width: int = 3     # 0/1 disables smoothing

    @property
    def tau_max(self) -> int:
        return int(self.sample_rate / self.f0_min)

    @property
    def tau_min(self) -> int:
        return max(2, int(self.sample_rate / self.f0_max))

    @property
    def window(self) -> int:
        """Integration window W: frame = W + tau_max."""
        return self.frame_length - self.tau_max

    def num_frames(self, num_samples: int) -> int:
        return max(0, (num_samples - self.frame_length) // self.hop + 1)


def _frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, N, frame_length) sliding frames."""
    if x.shape[-1] < frame_length:
        return x.new_zeros(x.shape[0], 0, frame_length)
    return x.unfold(-1, frame_length, hop)


def _difference_function(frames: torch.Tensor, window: int, tau_max: int) -> torch.Tensor:
    """d(tau) = sum_{j<W} (x[j] - x[j+tau])^2 = p0 + p[tau] - 2 r[tau] for
    tau in [0, tau_max): p[tau] the energy of x[tau:tau+W], r the linear
    correlation of x[:W] against the whole frame."""
    L = frames.shape[-1]
    n_fft = 1 << (2 * L - 1).bit_length()
    csum = torch.cumsum(frames * frames, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)  # (B, N, L+1)
    taus = torch.arange(tau_max, device=frames.device)
    p = csum[..., taus + window] - csum[..., taus]
    f_head = torch.fft.rfft(frames[..., :window], n_fft)
    f_full = torch.fft.rfft(frames, n_fft)
    r = torch.fft.irfft(torch.conj(f_head) * f_full, n_fft)[..., :tau_max]
    return p[..., :1] + p - 2.0 * r


def _cmnd(d: torch.Tensor) -> torch.Tensor:
    """d'(0) = 1, d'(tau) = d(tau) * tau / sum_{1..tau} d."""
    tau = torch.arange(d.shape[-1], dtype=d.dtype, device=d.device)
    csum = torch.cumsum(d[..., 1:], dim=-1)
    out = d[..., 1:] * tau[1:] / torch.clamp(csum, min=1e-12)
    return torch.cat([torch.ones_like(d[..., :1]), out], dim=-1)


def _edge_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N) padded by n copies of its first and last columns."""
    return torch.cat([x[:, :1].expand(-1, n), x, x[:, -1:].expand(-1, n)], dim=1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def track_pitch(wav: torch.Tensor, config: PitchConfig = PitchConfig()):
    """(B, T_samples) float32 -> (f0, voiced), each (B, n_frames); unvoiced
    frames get f0 = 0."""
    c = config
    frames = _frame(wav, c.frame_length, c.hop)
    d = _difference_function(frames, c.window, c.tau_max)
    nd = _cmnd(d)

    taus = torch.arange(c.tau_max, device=wav.device)
    nd_v = torch.where(taus >= c.tau_min, nd, torch.full_like(nd, float("inf")))

    # local minimum below threshold, earliest tau wins; argmin fallback
    # (`roll` wraps around at both ends, as jnp.roll)
    left = torch.roll(nd_v, 1, dims=-1)
    right = torch.roll(nd_v, -1, dims=-1)
    below = (nd_v <= left) & (nd_v < right) & (nd_v < c.threshold)
    first_below = torch.argmax(below.to(torch.int32), dim=-1)  # the first maximum
    tau_star = torch.where(below.any(dim=-1), first_below, torch.argmin(nd_v, dim=-1))

    # parabolic interpolation around tau_star on the raw difference function
    t0 = torch.clamp(tau_star, 1, c.tau_max - 2)
    dm, dc, dp = _gather(d, t0 - 1), _gather(d, t0), _gather(d, t0 + 1)
    denom = dm - 2.0 * dc + dp
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (dm - dp) / safe, torch.zeros_like(denom))
    tau_ref = t0.to(wav.dtype) + torch.clamp(shift, -1.0, 1.0)

    energy = (frames * frames).mean(dim=-1)
    voiced = (_gather(nd_v, tau_star) < c.threshold) & (energy > 1e-8)
    f0 = torch.where(voiced, c.sample_rate / torch.clamp(tau_ref, min=1.0),
                     torch.zeros_like(tau_ref))
    f0 = torch.clamp(f0, 0.0, c.f0_max)

    if c.median_width and c.median_width > 1 and f0.shape[1] > 0:
        w, n = c.median_width, f0.shape[1]
        fp, vp = _edge_pad(f0, w // 2), _edge_pad(voiced, w // 2)
        stack = torch.stack([fp[:, i:i + n] for i in range(w)], dim=-1)
        vstack = torch.stack([vp[:, i:i + n] for i in range(w)], dim=-1)
        # median over the VOICED window entries only: an unvoiced neighbour
        # (f0 = 0) is replaced by the centre value, so it drags nothing to 0
        stack = torch.where(vstack, stack, f0[..., None])
        f0 = torch.where(voiced, torch.sort(stack, dim=-1).values[..., w // 2],
                         torch.zeros_like(f0))
    return f0, voiced


def frame_loudness(wav: torch.Tensor, frame_length: int = 1024, hop: int = 320) -> torch.Tensor:
    """Per-frame log-RMS loudness in dB, (B, T) -> (B, n_frames), on
    `track_pitch`'s frame grid."""
    frames = _frame(wav, frame_length, hop)
    rms = torch.sqrt((frames * frames).mean(dim=-1) + 1e-10)
    return 20.0 * torch.log10(rms + 1e-5)
