"""Loading the reference's torch checkpoints into the port's modules, whose
parameters carry the checkpoints' names (the counterpart of the JAX
package's `arttts_tpu/utils/torch_convert*.py`, which map the same files to
flax trees):

- `fold_weight_norm`: `weight_g`/`weight_v` pairs and torch's newer
  `parametrizations.weight.original0/1` form -> plain weights;
- `load_reference_weights`: the module's own keys out of a checkpoint's
  state dict; keys the module does not have are ignored (as the JAX
  converters ignore them: fairseq's quantizer and mask embedding, HF's
  `masked_spec_embed`, ...), a key it has that the file lacks raises;
- `load_utmos_lightning`: a UTMOS lightning file (its `state_dict`);
- `load_hf_wavlm`: a `transformers.WavLMModel` state dict, bare or under
  `wavlm.`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

_PARAM_G = "parametrizations.weight.original0"
_PARAM_V = "parametrizations.weight.original1"


def fold_weight_norm(state_dict: Dict) -> Dict:
    """w = g * v / ||v|| in float64, the norm over every dim but the one
    where g is not a singleton (dim 0 for HiFi-GAN's convs, dim 2 for the
    wav2vec2 / WavLM positional conv, whose norm then runs over (0, 1))."""
    out = {}
    for k, v in state_dict.items():
        for g_suffix, v_suffix in (("weight_g", "weight_v"), (_PARAM_G, _PARAM_V)):
            if k.endswith(g_suffix):
                break
            if k.endswith(v_suffix):
                base = k[: -len(v_suffix)]
                g = torch.as_tensor(state_dict[base + g_suffix]).double()
                kept = next((a for a, s in enumerate(g.shape) if s > 1), 0)
                dims = [a for a in range(g.dim()) if a != kept]
                vv = torch.as_tensor(v).double()
                norm = vv.pow(2).sum(dim=dims, keepdim=True).sqrt()
                out[base + "weight"] = (g * vv / norm).to(torch.float32)
                break
        else:
            out[k] = v
    return out


def load_reference_weights(module: nn.Module, state_dict: Dict, prefix: str = "") -> nn.Module:
    """Load `module`'s parameters and buffers from `state_dict` (keys under
    `prefix`, weight norm folded); extra keys are ignored, a missing one
    raises. The checkpoint's tensors become the module's (`assign=True`), so
    a module built on the meta device takes them as they are."""
    sd = fold_weight_norm({k[len(prefix):]: v for k, v in state_dict.items()
                           if k.startswith(prefix)})
    want = module.state_dict(keep_vars=True)
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{type(module).__name__}: the checkpoint lacks {len(missing)} keys, "
                       f"e.g. {missing[:3]}")
    module.load_state_dict({k: torch.as_tensor(sd[k]) for k in want}, assign=True)
    return module


def load_utmos_lightning(module: nn.Module, ckpt) -> nn.Module:
    """A UTMOS lightning checkpoint (the loaded object, or its bare state
    dict) into a `UTMOSPredictor`."""
    sd = ckpt.get("state_dict", ckpt)
    return load_reference_weights(module, sd)


def load_hf_wavlm(module: nn.Module, state_dict: Dict) -> nn.Module:
    """A `transformers.WavLMModel` state dict (keys bare or under `wavlm.`)
    into a `WavLMEncoder`."""
    sd = {k.removeprefix("wavlm."): v for k, v in state_dict.items()}
    return load_reference_weights(module, sd)
