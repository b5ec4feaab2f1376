"""HiFi-GAN vocoder training step: generator + MPD/MSD adversarial (port of
`arttts_tpu/train/vocoder_trainer.py`).

Generator loss = adv + feature matching + 45 * mel L1, discriminator loss =
LSGAN real/fake, each with its own Adam (lr 2e-4, betas (0.8, 0.99), eps
1e-8, no clipping), in the JAX step's order:

(a) the discriminator update, on the generator's output without a gradient.
    That pass is `hifigan_forward_fast`: on the card its MRF stages run on
    the hand-written kernel K4 and its stride-2 upsamples on K5, the
    function the JAX step computes with its module path;
(b) the generator update: the module path under autograd (no kernel of the
    JAX package has a backward), scored by the discriminators as (a) left
    them.

The three parameter trees are drawn with torch's own initialisers from an
explicit `torch.Generator`; parity with the JAX package goes through the
weight bridge (`utils/from_jax.py`), not through matching draws. The
metrics stay on the device: nothing in a step waits for the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from arttts_tpu_torch.audio.mel import MelConfig, MelSpectrogram
from arttts_tpu_torch.core.device import resolve
from arttts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
    hifigan_forward_fast,
)

MEL_WEIGHT = 45.0
ADAM_BETAS = (0.8, 0.99)  # both Adams' (b1, b2), as the JAX trainer's


@torch.no_grad()
def init_weights(module: nn.Module, rng: torch.Generator) -> nn.Module:
    """Redraw every conv and linear layer of `module` as its
    `reset_parameters` does (kaiming-uniform weight with a = sqrt(5), bias
    uniform in +-1/sqrt(fan_in)), from `rng`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=rng)
            if m.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                nn.init.uniform_(m.bias, -bound, bound, generator=rng)
    return module


class VocoderGAN:
    """A generator, both discriminators (`disc`: {"mpd", "msd"}), the mel
    of the L1 loss and the two Adams, on `device` (default "cuda", no
    fallback). `generator` gives the architecture: its weights are drawn
    anew from `rng` (a CPU `torch.Generator`; seed 0 when None), as the JAX
    `init_state` draws them."""

    def __init__(self, generator: Optional[HiFiGANGenerator] = None,
                 mel_config: MelConfig = MelConfig(), device="cuda",
                 rng: Optional[torch.Generator] = None, lr: float = 2e-4):
        self.device = resolve(device)
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        self.generator = init_weights(generator or HiFiGANGenerator(), rng).to(self.device)
        with torch.device("meta"):  # no draws of the default initialisers
            disc = nn.ModuleDict({"mpd": MultiPeriodDiscriminator(),
                                  "msd": MultiScaleDiscriminator()})
        self.disc = init_weights(disc.to_empty(device="cpu"), rng).to(self.device)
        self.mel = MelSpectrogram(mel_config, self.device)
        self.gen_opt = torch.optim.Adam(self.generator.parameters(), lr=lr, betas=ADAM_BETAS,
                                        eps=1e-8)
        self.disc_opt = torch.optim.Adam(self.disc.parameters(), lr=lr, betas=ADAM_BETAS,
                                         eps=1e-8)
        self.step = 0

    def _tensor(self, a) -> torch.Tensor:
        """`a` as float32 on the device; an inference-mode tensor (the
        dataset's mel) is copied, since autograd saves the generator's input."""
        t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return t.clone() if t.is_inference() else t

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One GAN step on {"mel": (B, T, n_mels), "wav": (B, T * hop, 1)}
        (arrays or tensors): `disc_step`, then `gen_step`. Returns
        `gen_loss`, `disc_loss`, `mel_l1`, `adv` and `fm` as device scalars."""
        mel, wav = self._tensor(batch["mel"]), self._tensor(batch["wav"])
        d_loss = self.disc_step(mel, wav)
        metrics = self.gen_step(mel, wav)
        metrics["disc_loss"] = d_loss
        self.step += 1
        return metrics

    def disc_step(self, mel: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        """(a): the discriminators' update on the generator's output, taken
        without a gradient on the fast path (K4/K5 on the card); the
        inference-mode output is copied into a tensor autograd can save.
        Returns the LSGAN loss."""
        y = wav.transpose(1, 2)  # (B, 1, S)
        wav_hat = hifigan_forward_fast(self.generator, mel).clone().transpose(1, 2)
        self.disc_opt.zero_grad(set_to_none=True)
        y_df_r, y_df_g, _, _ = self.disc["mpd"](y, wav_hat)
        y_ds_r, y_ds_g, _, _ = self.disc["msd"](y, wav_hat)
        d_loss = discriminator_loss(y_df_r, y_df_g) + discriminator_loss(y_ds_r, y_ds_g)
        d_loss.backward()
        self.disc_opt.step()
        return d_loss.detach()

    def gen_step(self, mel: torch.Tensor, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(b): the generator's update on its module path against the
        discriminators as they are now; their weights take no gradient (the
        JAX step differentiates the generator's parameters only)."""
        y = wav.transpose(1, 2)
        self.gen_opt.zero_grad(set_to_none=True)
        self.disc.requires_grad_(False)
        try:
            w_hat = self.generator(mel)
            mel_hat = self.mel.differentiable(w_hat[:, :, 0])
            with torch.no_grad():
                mel_ref = self.mel.differentiable(wav[:, :, 0])
            mel_l1 = torch.mean(torch.abs(mel_hat - mel_ref))
            w_hat = w_hat.transpose(1, 2)
            _, y_df_g, f_df_r, f_df_g = self.disc["mpd"](y, w_hat)
            _, y_ds_g, f_ds_r, f_ds_g = self.disc["msd"](y, w_hat)
            fm = feature_loss(f_df_r, f_df_g) + feature_loss(f_ds_r, f_ds_g)
            adv = generator_loss(y_df_g) + generator_loss(y_ds_g)
            g_loss = adv + fm + mel_l1 * MEL_WEIGHT
            g_loss.backward()
        finally:
            self.disc.requires_grad_(True)
        self.gen_opt.step()
        return {"gen_loss": g_loss.detach(), "mel_l1": mel_l1.detach(), "adv": adv.detach(),
                "fm": fm.detach()}

    def weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"gen", "disc"}: the generator's and the discriminators' state dicts."""
        return {"gen": self.generator.state_dict(), "disc": self.disc.state_dict()}

    def load_weights(self, weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Restore `weights()`'s dict (weights only, as the JAX CLI's
        `--init-ckpt`: the optimizers keep their state)."""
        self.generator.load_state_dict(weights["gen"])
        self.disc.load_state_dict(weights["disc"])
