"""HiFi-GAN vocoders: the stock mel -> wav generator and the SPARC FiLM
articulatory -> wav generator (port of `arttts_tpu/models/hifigan.py`).

Two paths per generator, as in the JAX package:
- the module path (`HiFiGANGenerator.forward`, `SpkSparcHiFiGANGenerator.
  forward`): plain PyTorch convolutions, the oracle of the fast path;
- the fast path (`hifigan_forward_fast`, `sparc_forward_fast`,
  `spk_sparc_forward_fast`), which the serving entry points use. Its MRF
  stages with C <= 128 run on the hand-written kernel K4
  (`ops/mrf.py:mrf_stage`, with FiLM for SPARC) and its stride-2, k=4
  upsamples on K5 (`ops/upsample.py:upsample1d`). The C=256 stage keeps the
  plain blocks and the x8 upsamples stay `ConvTranspose1dTorch`, as XLA
  computes them in the JAX package.

State-dict names are the reference checkpoints' with weight norm folded:
jik876's `Generator` (`conv_pre`, `ups.{i}`, `resblocks.{n}.convs1.{c}`,
`convs2.{c}`, `conv_post`) and SPARC's generator (`input_conv`,
`upsamples.{i}.1`, `blocks.{n}.convs1.{c}.1`, `convs2.{c}.1`,
`films.{c}.0`/`.3`, `output_conv.1`) beside its speaker MLP (`spk_ft` with
`spk_fc.0`/`.3`), the names `arttts_tpu/utils/torch_convert.py` reads. The
public forwards keep the JAX layout: features (B, T, C) -> wav
(B, T*256, 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.convs import ConvTranspose1dTorch
from arttts_tpu_torch.ops.mrf import mrf_stage, mrf_supported, stage_weights
from arttts_tpu_torch.ops.upsample import upsample1d, upsample_supported

LRELU_SLOPE = 0.1


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


class SoftClamp(nn.Module):
    """tanh(x * temp) / temp."""

    def __init__(self, temp: float = 0.2):
        super().__init__()
        self.temp = temp

    def forward(self, x):
        return torch.tanh(x * self.temp) / self.temp


class ResBlock(nn.Module):
    """MRF residual block: per dilation, lrelu -> dilated conv -> lrelu ->
    conv -> + residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=d * (kernel_size - 1) // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations
        )

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


class FiLMResBlock(nn.Module):
    """ResBlock whose every round is FiLM-modulated by the speaker
    embedding: xt = xt * a + b, with (a, b) from a SoftClamp'd MLP. The
    MLP's dropout acts only in training mode."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5), spk_emb_size: int = 64,
                 film_dropout: float = 0.2):
        super().__init__()
        self.kernel_size = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU_SLOPE),
                          nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                    padding=d * (kernel_size - 1) // 2))
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU_SLOPE),
                          nn.Conv1d(channels, channels, kernel_size,
                                    padding=(kernel_size - 1) // 2))
            for _ in dilations
        )
        self.films = nn.ModuleList(
            nn.Sequential(nn.Linear(spk_emb_size, channels), nn.ReLU(),
                          nn.Dropout(film_dropout), nn.Linear(channels, 2 * channels),
                          SoftClamp())
            for _ in dilations
        )

    @staticmethod
    def _split(f):
        C = f.shape[-1] // 2
        return f[..., :C], f[..., C:]

    def film_vectors(self, spk_emb):
        """(a, b), each (n_rounds, B, C): every round's FiLM without dropout
        (the inference form the fast path hands to K4)."""
        f = torch.stack([clamp(lin2(relu(lin1(spk_emb))))
                         for lin1, relu, _, lin2, clamp in self.films])
        return self._split(f)

    def forward(self, x, spk_emb):
        for c1, c2, film in zip(self.convs1, self.convs2, self.films):
            a, b = self._split(film(spk_emb))
            x = c2(c1(x)) * a[:, :, None] + b[:, :, None] + x
        return x


class HiFiGANGenerator(nn.Module):
    """Stock mel->wav generator; defaults follow the reference's
    `hifigan-config.json` (512 initial channels, rates (8, 8, 2, 2), kernels
    (16, 16, 4, 4), MRF kernels (3, 7, 11) x dilations (1, 3, 5))."""

    def __init__(self, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)), n_mels: int = 80):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        c0 = upsample_initial_channel
        self.conv_pre = nn.Conv1d(n_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList(
            ConvTranspose1dTorch(c0 // 2**i, c0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes))
        )
        self.resblocks = nn.ModuleList(
            ResBlock(c0 // 2 ** (i + 1), rk, tuple(rd))
            for i in range(len(upsample_rates))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes)
        )
        self.conv_post = nn.Conv1d(c0 // 2 ** len(upsample_rates), 1, 7, padding=3)

    def forward(self, mel):
        """mel (B, T, 80) -> wav (B, T * prod(rates), 1) in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            x = sum(self.resblocks[i * n + j](x) for j in range(n)) / n
        x = self.conv_post(F.leaky_relu(x, 0.01))  # torch LeakyReLU() default slope
        return torch.tanh(x).transpose(1, 2)


class SparcHiFiGANGenerator(nn.Module):
    """SPARC articulatory vocoder: 14 input channels (12 EMA + pitch +
    loudness), the pitch channel rescaled `(f0 - 50) * 0.01`, FiLM residual
    blocks averaged per upsample level, tanh output."""

    def __init__(self, in_channels: int = 14, channels: int = 512, kernel_size: int = 7,
                 upsample_scales=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 spk_emb_size: int = 64, pitch_offset: float = 50.0,
                 pitch_rescale: float = 0.01, pitch_axis: int = 12):
        super().__init__()
        self.num_blocks = len(resblock_kernel_sizes)
        self.pitch_offset, self.pitch_rescale = pitch_offset, pitch_rescale
        self.pitch_axis = pitch_axis
        pad = (kernel_size - 1) // 2
        self.input_conv = nn.Conv1d(in_channels, channels, kernel_size, padding=pad)
        self.upsamples = nn.ModuleList(
            nn.Sequential(nn.LeakyReLU(LRELU_SLOPE),
                          ConvTranspose1dTorch(channels // 2**i, channels // 2 ** (i + 1), k, u,
                                               padding=u // 2 + u % 2, output_padding=u % 2))
            for i, (u, k) in enumerate(zip(upsample_scales, upsample_kernel_sizes))
        )
        self.blocks = nn.ModuleList(
            FiLMResBlock(channels // 2 ** (i + 1), rk, tuple(rd), spk_emb_size)
            for i in range(len(upsample_scales))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations)
        )
        self.output_conv = nn.Sequential(
            nn.LeakyReLU(0.01),
            nn.Conv1d(channels // 2 ** len(upsample_scales), 1, kernel_size, padding=pad),
            nn.Tanh(),
        )

    def rescale_pitch(self, c):
        """(B, T, C) features -> (B, C, T), the pitch channel rescaled (a
        copy: the caller's tensor is left as it is)."""
        c = c.transpose(1, 2).clone()
        p = self.pitch_axis
        c[:, p] = (c[:, p] - self.pitch_offset) * self.pitch_rescale
        return c

    def forward(self, c, spk_emb):
        """c (B, T, in_channels), spk_emb (B, spk_emb_size) ->
        wav (B, T * prod(scales), 1)."""
        x = self.input_conv(self.rescale_pitch(c))
        n = self.num_blocks
        for i, up in enumerate(self.upsamples):
            x = up(x)
            x = sum(self.blocks[i * n + j](x, spk_emb) for j in range(n)) / n
        return self.output_conv(x).transpose(1, 2)


class SpeakerFT(nn.Module):
    """The checkpoint's speaker MLP: Linear -> exact-erf GELU -> Linear; the
    second Linear sits at index 3 (`spk_fc.3`), and the slot between holds
    no parameters and does nothing at inference."""

    def __init__(self, spk_ft_size: int = 1024, spk_emb_size: int = 64):
        super().__init__()
        self.spk_fc = nn.Sequential(nn.Linear(spk_ft_size, spk_ft_size), nn.GELU(),
                                    nn.Identity(), nn.Linear(spk_ft_size, spk_emb_size))

    def forward(self, spk_ft):
        return self.spk_fc(spk_ft)


class SpkSparcHiFiGANGenerator(nn.Module):
    """Speaker MLP + SPARC generator in one checkpoint (`spk_ft`,
    `generator`)."""

    def __init__(self, spk_ft_size: int = 1024, spk_emb_size: int = 64, **generator_kwargs):
        super().__init__()
        self.spk_ft = SpeakerFT(spk_ft_size, spk_emb_size)
        self.generator = SparcHiFiGANGenerator(spk_emb_size=spk_emb_size, **generator_kwargs)

    def forward(self, c, spk_ft):
        """c (B, T, 14), spk_ft (B, spk_ft_size) -> wav (B, T*256, 1)."""
        return self.generator(c, self.spk_ft(spk_ft))


def _upsample(x, conv: nn.ConvTranspose1d):
    """lrelu + one upsample: K5 where it takes the shape, else the module."""
    u, k = conv.stride[0], conv.kernel_size[0]
    if upsample_supported(u, k, conv.in_channels, conv.out_channels):
        return upsample1d(x, conv.weight, conv.bias, u, conv.padding[0], conv.output_padding[0])
    return conv(leaky_relu(x))


def _mrf(x, blocks, spk_emb=None, bf16=False):
    """One stage's branch average: K4 (in its bf16 mode with `bf16`) where it
    takes the width, else the blocks themselves. With `spk_emb` the blocks
    are `FiLMResBlock`s."""
    if not mrf_supported(x.shape[1], [b.kernel_size for b in blocks]):
        args = () if spk_emb is None else (spk_emb,)
        return sum(b(x, *args) for b in blocks) / len(blocks)
    film = None
    if spk_emb is not None:
        ab = [b.film_vectors(spk_emb) for b in blocks]
        film = (torch.stack([a for a, _ in ab]), torch.stack([b for _, b in ab]))
    return mrf_stage(x, stage_weights(blocks), film, bf16)


@torch.inference_mode()
def hifigan_forward_fast(vocoder: HiFiGANGenerator, mel, bf16: bool = False):
    """`HiFiGANGenerator.forward` with its MRF stages on K4 (C <= 128; its
    bf16 mode with `bf16`) and its stride-2 upsamples on K5: mel (B, T, 80)
    -> wav (B, T*256, 1)."""
    x = vocoder.conv_pre(mel.transpose(1, 2))
    n = vocoder.num_kernels
    for i, up in enumerate(vocoder.ups):
        x = _upsample(x, up)
        x = _mrf(x, vocoder.resblocks[i * n:(i + 1) * n], bf16=bf16)
    x = vocoder.conv_post(F.leaky_relu(x, 0.01))
    return torch.tanh(x).transpose(1, 2)


@torch.inference_mode()
def sparc_forward_fast(generator: SparcHiFiGANGenerator, c, spk_emb, bf16: bool = False):
    """`SparcHiFiGANGenerator.forward` (FiLM dropout off) with its FiLM-MRF
    stages on K4's FiLM mode (C <= 128; its bf16 mode with `bf16`) and its
    stride-2 upsamples on K5. The FiLM MLPs run here in plain PyTorch and
    hand (a, b) to the kernel."""
    x = generator.input_conv(generator.rescale_pitch(c))
    n = generator.num_blocks
    for i, up in enumerate(generator.upsamples):
        x = _upsample(x, up[1])
        x = _mrf(x, generator.blocks[i * n:(i + 1) * n], spk_emb, bf16)
    return generator.output_conv(x).transpose(1, 2)


@torch.inference_mode()
def spk_sparc_forward_fast(module: SpkSparcHiFiGANGenerator, c, spk_ft, bf16: bool = False):
    """`SpkSparcHiFiGANGenerator.forward` on the fast path: speaker MLP,
    then `sparc_forward_fast`. c (B, T, 14), spk_ft (B, spk_ft_size)."""
    return sparc_forward_fast(module.generator, c, module.spk_ft(spk_ft), bf16)


def build_vocoder(device="cuda", seed: int = 1, **kwargs) -> HiFiGANGenerator:
    """A HiFiGANGenerator with random weights drawn from `seed` (on the
    CPU), moved to `device`, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        voc = HiFiGANGenerator(**kwargs)
    return voc.to(resolve(device)).eval()


def build_sparc_vocoder(device="cuda", seed: int = 2, **kwargs) -> SpkSparcHiFiGANGenerator:
    """A SpkSparcHiFiGANGenerator with random weights drawn from `seed` (on
    the CPU), moved to `device`, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        voc = SpkSparcHiFiGANGenerator(**kwargs)
    return voc.to(resolve(device)).eval()


# --------------------------------------------------------------------------
# GAN training parts: the discriminators and losses of the JAX package's
# `models/hifigan.py:267-376`. They follow the JAX modules, not jik876's
# torch ones: flax `padding="SAME"` (asymmetric under a stride, written as
# `F.pad` and an unpadded conv), average pooling with flax's SAME padding
# and `count_include_pad=True`, and no weight norm or spectral norm.
# --------------------------------------------------------------------------
def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA SAME padding of a length-n axis for kernel k and stride s:
    ceil(n / s) outputs, the pad split with the odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad T to a multiple of the period, fold
    the wav into (T / p, p) and run (5, 1) 2D convs, stride 3 but the last,
    along the first axis."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [nn.Conv2d(a, b, (5, 1), (3, 1)) for a, b in zip(chans, chans[1:])]
            + [nn.Conv2d(1024, 1024, (5, 1))])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1))

    @staticmethod
    def _conv(conv: nn.Conv2d, x):
        return conv(F.pad(x, (0, 0, *same_pad(x.shape[2], conv.kernel_size[0], conv.stride[0]))))

    def forward(self, x):
        """x (B, 1, T) -> (logits (B, n), feature maps, each (B, C, H, p))."""
        B, _, T = x.shape
        p = self.period
        pad = (p - T % p) % p
        x = F.pad(x, (0, pad), mode="reflect").view(B, 1, (T + pad) // p, p)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(self._conv(conv, x))
            fmap.append(x)
        x = self._conv(self.conv_post, x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided conv1d stack."""

    SPECS = ((1, 128, 15, 1, 1), (128, 128, 41, 2, 4), (128, 256, 41, 2, 16),
             (256, 512, 41, 4, 16), (512, 1024, 41, 4, 16), (1024, 1024, 41, 1, 16),
             (1024, 1024, 5, 1, 1))  # (in, out, kernel, stride, groups)

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(a, b, k, s, groups=g)
                                   for a, b, k, s, g in self.SPECS)
        self.conv_post = nn.Conv1d(1024, 1, 3)

    @staticmethod
    def _conv(conv: nn.Conv1d, x):
        return conv(F.pad(x, same_pad(x.shape[2], conv.kernel_size[0], conv.stride[0])))

    def forward(self, x):
        """x (B, 1, T) -> (logits (B, n), feature maps, each (B, C, T'))."""
        fmap = []
        for conv in self.convs:
            x = leaky_relu(self._conv(conv, x))
            fmap.append(x)
        x = self._conv(self.conv_post, x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def avg_pool_same(x):
    """flax `nn.avg_pool(x, (4,), (2,), "SAME")`: zero padding counted in
    the mean, ceil(T / 2) frames. x (B, C, T)."""
    return F.avg_pool1d(F.pad(x, same_pad(x.shape[2], 4, 2)), 4, 2)


def _pairs(discs, y, y_hat, pool: bool = False):
    """Each discriminator on y and on y_hat; with `pool`, each after the
    first sees both average-pooled once more."""
    outs = []
    for i, d in enumerate(discs):
        if pool and i:
            y, y_hat = avg_pool_same(y), avg_pool_same(y_hat)
        outs.append((d(y), d(y_hat)))
    return ([o[0][0] for o in outs], [o[1][0] for o in outs],
            [o[0][1] for o in outs], [o[1][1] for o in outs])


class MultiPeriodDiscriminator(nn.Module):
    PERIODS = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in self.PERIODS)

    def forward(self, y, y_hat):
        """y, y_hat (B, 1, T) -> (real logits, generated logits, real feature
        maps, generated feature maps), one entry a period."""
        return _pairs(self.discriminators, y, y_hat)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS() for _ in range(3))

    def forward(self, y, y_hat):
        """As `MultiPeriodDiscriminator.forward`, one entry a scale; each
        scale after the first sees the wavs average-pooled by 2 once more."""
        return _pairs(self.discriminators, y, y_hat, pool=True)


def feature_loss(fmap_r, fmap_g):
    """2 * sum over discriminators and layers of mean |real - generated|."""
    return 2 * sum(torch.mean(torch.abs(r - g))
                   for dr, dg in zip(fmap_r, fmap_g) for r, g in zip(dr, dg))


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN: sum of mean (1 - real)^2 + mean generated^2."""
    return sum(torch.mean((1 - dr) ** 2) + torch.mean(dg ** 2)
               for dr, dg in zip(disc_real_outputs, disc_generated_outputs))


def generator_loss(disc_outputs):
    """LSGAN: sum of mean (1 - generated)^2."""
    return sum(torch.mean((1 - dg) ** 2) for dg in disc_outputs)
