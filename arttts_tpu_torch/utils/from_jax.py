"""Weight bridge: the JAX package's parameter trees (nested dicts of
arrays) -> the port's state dicts.

The port's modules carry the reference's torch state-dict names, so this is
the exact inverse of the JAX package's converters
(`arttts_tpu/utils/torch_convert_acoustic.py:convert_grad_tts`,
`convert_estimator1d`, `convert_grad_ttartic`,
`arttts_tpu/utils/torch_convert.py:convert_hifigan_generator`,
`convert_sparc_generator`, `convert_spk_sparc`,
`arttts_tpu/utils/torch_convert_utmos.py:convert_wav2vec2`, `convert_utmos`,
`arttts_tpu/utils/torch_convert_wavlm.py:convert_wavlm`). Layouts:

  flax Conv kernel (k, in/g, out)      -> Conv1d weight (out, in/g, k)
  flax Conv kernel (kh, kw, in, out)   -> Conv2d weight (out, in, kh, kw)
  flax Dense kernel (in, out)          -> Linear weight (out, in)
                                          / 1x1 conv weight (out, in, 1[, 1])
  ConvTranspose{1,2}dTorch weight      -> kept (torch layout already)
  flax MHA query/key/value (D, H, dh)  -> Linear weight (H*dh, D)
  flax MHA out (H, dh, D)              -> Linear weight (D, H*dh)

A gradient tree has the parameter tree's structure, so the same functions
map it. `adam_state_from_jax` carries the optimizer state of a run the JAX
package started, so the port can continue it; `plain_adam_state_from_jax`
does the same for the vocoder trainer's two plain Adams.

Nothing here imports JAX: the trees arrive as numpy arrays (or anything
`numpy.asarray` takes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv1d(sd, key, p) -> None:
    """A flax Conv (k, in/groups, out) -> Conv1d weight (out, in/groups, k),
    and its bias if it has one."""
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv2d(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd, key, p, conv_dims: int = 0) -> None:
    """Dense -> Linear (conv_dims 0) or a 1x1 conv with `conv_dims` spatial dims."""
    w = np.asarray(p["kernel"]).T
    sd[f"{key}.weight"] = _t(w.reshape(w.shape + (1,) * conv_dims))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _layer_norm(sd, key, p) -> None:
    sd[f"{key}.gamma"] = _t(p["LayerNorm_0"]["scale"])
    sd[f"{key}.beta"] = _t(p["LayerNorm_0"]["bias"])


def encoder_state_dict(enc: Dict, prefix: str = "encoder.") -> Dict[str, torch.Tensor]:
    """Flax `Encoder` subtree -> the port's `Encoder` state dict (the
    embedding only for the text kind, `proj_w` only with a duration
    predictor)."""
    sd: Dict[str, torch.Tensor] = {}
    p = prefix
    if "Embed_0" in enc:
        sd[f"{p}emb.weight"] = _t(enc["Embed_0"]["embedding"])
    pre = enc["ConvReluNorm_0"]
    n = sum(1 for k in pre if k.startswith("ChannelLayerNorm_"))
    for i in range(n):
        _conv1d(sd, f"{p}prenet.conv_layers.{i}", pre[f"Conv_{i}"])
        _layer_norm(sd, f"{p}prenet.norm_layers.{i}", pre[f"ChannelLayerNorm_{i}"])
    _conv1d(sd, f"{p}prenet.proj", pre[f"Conv_{n}"])
    tr = enc["TransformerEncoder_0"]
    n_layers = sum(1 for k in tr if k.startswith("RelPositionMultiHeadAttention_"))
    for i in range(n_layers):
        a = tr[f"RelPositionMultiHeadAttention_{i}"]
        q = f"{p}encoder.attn_layers.{i}"
        for j, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
            _dense(sd, f"{q}.{name}", a[f"Dense_{j}"], conv_dims=1)
        sd[f"{q}.emb_rel_k"] = _t(a["emb_rel_k"])
        sd[f"{q}.emb_rel_v"] = _t(a["emb_rel_v"])
        _layer_norm(sd, f"{p}encoder.norm_layers_1.{i}", tr[f"ChannelLayerNorm_{2 * i}"])
        _layer_norm(sd, f"{p}encoder.norm_layers_2.{i}", tr[f"ChannelLayerNorm_{2 * i + 1}"])
        _conv1d(sd, f"{p}encoder.ffn_layers.{i}.conv_1", tr[f"FFN_{i}"]["Conv_0"])
        _conv1d(sd, f"{p}encoder.ffn_layers.{i}.conv_2", tr[f"FFN_{i}"]["Conv_1"])
    _conv1d(sd, f"{p}proj_m", enc["proj_m"])
    if "proj_w" not in enc:
        return sd
    w = enc["proj_w"]
    _conv1d(sd, f"{p}proj_w.conv_1", w["Conv_0"])
    _layer_norm(sd, f"{p}proj_w.norm_1", w["ChannelLayerNorm_0"])
    _conv1d(sd, f"{p}proj_w.conv_2", w["Conv_1"])
    _layer_norm(sd, f"{p}proj_w.norm_2", w["ChannelLayerNorm_1"])
    _conv1d(sd, f"{p}proj_w.proj", w["Conv_2"])
    return sd


def _block2d(sd, key, p) -> None:
    _conv2d(sd, f"{key}.block.0", p["Conv_0"])
    sd[f"{key}.block.1.weight"] = _t(p["GroupNorm_0"]["scale"])
    sd[f"{key}.block.1.bias"] = _t(p["GroupNorm_0"]["bias"])


def _art_attention(sd, key, p) -> None:
    """ArtChannelsAttention: (1, 3) qkv conv without bias, 1x1 output conv."""
    sd[f"{key}.to_qkv.weight"] = _t(np.transpose(np.asarray(p["Conv_0"]["kernel"]),
                                                 (3, 2, 0, 1)))
    _dense(sd, f"{key}.to_out", p["Conv_1"], conv_dims=2)


def _block1d(sd, key, p) -> None:
    _conv2d(sd, f"{key}.block.0", p["Conv_0"])
    _art_attention(sd, f"{key}.block.1", p["ArtChannelsAttention_0"])
    sd[f"{key}.block.2.weight"] = _t(p["GroupNorm_0"]["scale"])
    sd[f"{key}.block.2.bias"] = _t(p["GroupNorm_0"]["bias"])


def _estimator(est: Dict, prefix: str, num_resolutions: int, kind: str,
               block) -> Dict[str, torch.Tensor]:
    """The U-Net skeleton shared by both estimators; `kind` "2d" or "1d"
    names the resnet and final blocks (`ResnetBlock{kind}_k`,
    `Block{kind}_0`), `block` maps one block."""
    sd: Dict[str, torch.Tensor] = {}
    p = prefix
    _dense(sd, f"{p}mlp.0", est["Dense_0"])
    _dense(sd, f"{p}mlp.2", est["Dense_1"])
    if "Dense_2" in est:  # the speaker plane's MLP (n_spks > 1)
        _dense(sd, f"{p}spk_mlp.0", est["Dense_2"])
        _dense(sd, f"{p}spk_mlp.2", est["Dense_3"])
    if "PreBlock_0" in est:  # the preblock decoder's wide channel-attention block
        _conv2d(sd, f"{p}preblock.block.0", est["PreBlock_0"]["Conv_0"])
        _art_attention(sd, f"{p}preblock.block.1", est["PreBlock_0"]["ArtChannelsAttention_0"])
    # JAX call order: downs' resnets, mid, ups' resnets; attentions likewise
    res_keys = [f"{p}downs.{lv}.{j}" for lv in range(num_resolutions) for j in (0, 1)]
    res_keys += [f"{p}mid_block1", f"{p}mid_block2"]
    res_keys += [f"{p}ups.{u}.{j}" for u in range(num_resolutions - 1) for j in (0, 1)]
    attn_keys = [f"{p}downs.{lv}.2" for lv in range(num_resolutions)] + [f"{p}mid_attn"]
    attn_keys += [f"{p}ups.{u}.2" for u in range(num_resolutions - 1)]
    for k, key in enumerate(res_keys):
        r = est[f"ResnetBlock{kind}_{k}"]
        block(sd, f"{key}.block1", r[f"Block{kind}_0"])
        block(sd, f"{key}.block2", r[f"Block{kind}_1"])
        _dense(sd, f"{key}.mlp.1", r["Dense_0"])
        if "Conv_0" in r:
            _dense(sd, f"{key}.res_conv", r["Conv_0"], conv_dims=2)
    for k, key in enumerate(attn_keys):
        a = est[f"LinearAttention2d_{k}"]
        _dense(sd, f"{key}.fn.fn.to_qkv", a["Conv_0"], conv_dims=2)
        _dense(sd, f"{key}.fn.fn.to_out", a["Conv_1"], conv_dims=2)
        sd[f"{key}.fn.g"] = _t(est[f"Rezero_{k}"]["g"])
    for lv in range(num_resolutions - 1):
        _conv2d(sd, f"{p}downs.{lv}.3.conv", est[f"Downsample2d_{lv}"]["Conv_0"])
        up = est[f"ConvTranspose2dTorch_{lv}"]
        sd[f"{p}ups.{lv}.3.conv.weight"] = _t(up["weight"])
        sd[f"{p}ups.{lv}.3.conv.bias"] = _t(up["bias"])
    block(sd, f"{p}final_block", est[f"Block{kind}_0"])
    _dense(sd, f"{p}final_conv", est["Conv_0"], conv_dims=2)
    return sd


def estimator_state_dict(est: Dict, prefix: str = "decoder.estimator.",
                         num_resolutions: int = 3) -> Dict[str, torch.Tensor]:
    """Flax `GradLogPEstimator2d` subtree (with its `PreBlock_0`, if any) ->
    `GradLogPEstimator2d` state dict."""
    return _estimator(est, prefix, num_resolutions, "2d", _block2d)


def estimator1d_state_dict(est: Dict, prefix: str = "decoder.estimator.",
                           num_resolutions: int = 3) -> Dict[str, torch.Tensor]:
    """Flax `GradLogPEstimator1d` subtree -> `GradLogPEstimator1d` state
    dict (the inverse of `convert_estimator1d`)."""
    return _estimator(est, prefix, num_resolutions, "1d", _block1d)


def grad_tts_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`GradTTSModel` params (`variables["params"]`) -> the port's
    `GradTTSModel` state dict: encoder, estimator (2D, with or without the
    preblock, or 1D) and, for a multi-speaker model, its speaker embedding
    (`spk_table` -> `spk_emb`)."""
    sd = encoder_state_dict(params["encoder"])
    est = params["estimator"]
    sd.update(estimator1d_state_dict(est) if "ResnetBlock1d_0" in est
              else estimator_state_dict(est))
    if "spk_table" in params:
        sd["spk_emb.weight"] = _t(params["spk_table"]["embedding"])
    return sd


def grad_ttartic_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """GradTTArtic params (`GradTTSModel(name="grad_ttartic")`) -> the
    port's state dict (the inverse of `convert_grad_ttartic`): the ipa_trait
    encoder without `proj_w`, the estimator with its speaker MLP
    (`Dense_2`, `Dense_3` -> `spk_mlp.0`, `.2`) and the speaker encoding
    layer (`spk_encoder` -> `spk_enc.spk_fc.0`, `.3`)."""
    sd = grad_tts_state_dict(params)
    _dense(sd, "spk_enc.spk_fc.0", params["spk_encoder"]["Dense_0"])
    _dense(sd, "spk_enc.spk_fc.3", params["spk_encoder"]["Dense_1"])
    return sd


def hifigan_state_dict(params: Dict, num_ups: int = 4,
                       num_kernels: int = 3) -> Dict[str, torch.Tensor]:
    """`HiFiGANGenerator` params -> the port's `HiFiGANGenerator` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv1d(sd, "conv_pre", params["conv_pre"])
    _conv1d(sd, "conv_post", params["conv_post"])
    for i in range(num_ups):
        sd[f"ups.{i}.weight"] = _t(params[f"ups_{i}"]["weight"])
        sd[f"ups.{i}.bias"] = _t(params[f"ups_{i}"]["bias"])
        for j in range(num_kernels):
            block = params[f"resblock_{i}_{j}"]
            n = i * num_kernels + j
            c = 0
            while f"conv1_{c}" in block:
                _conv1d(sd, f"resblocks.{n}.convs1.{c}", block[f"conv1_{c}"])
                _conv1d(sd, f"resblocks.{n}.convs2.{c}", block[f"conv2_{c}"])
                c += 1
    return sd


def mpd_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`MultiPeriodDiscriminator` params (`disc_{period}` subtrees, convs
    `Conv_0`..`Conv_5`, kernels (5, 1, in, out)) -> the port's
    `MultiPeriodDiscriminator` state dict (`discriminators.{i}.convs.{j}`,
    `.conv_post`; Conv2d weights (out, in, 5, 1))."""
    sd: Dict[str, torch.Tensor] = {}
    periods = sorted(int(k.split("_")[1]) for k in params)
    for i, p in enumerate(periods):
        d = params[f"disc_{p}"]
        n = len(d) - 1
        for j in range(n):
            _conv2d(sd, f"discriminators.{i}.convs.{j}", d[f"Conv_{j}"])
        _conv2d(sd, f"discriminators.{i}.conv_post", d[f"Conv_{n}"])
    return sd


def msd_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`MultiScaleDiscriminator` params (`disc_{i}`, convs `Conv_0`..`Conv_7`,
    grouped kernels (k, in / groups, out)) -> the port's
    `MultiScaleDiscriminator` state dict (Conv1d weights (out, in / groups,
    k))."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        d = params[f"disc_{i}"]
        n = len(d) - 1
        for j in range(n):
            _conv1d(sd, f"discriminators.{i}.convs.{j}", d[f"Conv_{j}"])
        _conv1d(sd, f"discriminators.{i}.conv_post", d[f"Conv_{n}"])
    return sd


def disc_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`VocoderTrainState.disc_params` ({"mpd", "msd"}) -> the state dict of
    the port's `VocoderGAN.disc` (keys under `mpd.` and `msd.`)."""
    sd = {f"mpd.{k}": v for k, v in mpd_state_dict(params["mpd"]).items()}
    sd.update({f"msd.{k}": v for k, v in msd_state_dict(params["msd"]).items()})
    return sd


def sparc_state_dict(params: Dict, num_ups: int = 4, num_blocks: int = 3,
                     num_dil: int = 3) -> Dict[str, torch.Tensor]:
    """`SparcHiFiGANGenerator` params -> the port's `SparcHiFiGANGenerator`
    state dict (the inverse of `convert_sparc_generator`)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv1d(sd, "input_conv", params["input_conv"])
    _conv1d(sd, "output_conv.1", params["output_conv"])
    for i in range(num_ups):
        sd[f"upsamples.{i}.1.weight"] = _t(params[f"upsample_{i}"]["weight"])
        sd[f"upsamples.{i}.1.bias"] = _t(params[f"upsample_{i}"]["bias"])
        for j in range(num_blocks):
            block = params[f"block_{i}_{j}"]
            n = i * num_blocks + j
            for c in range(num_dil):
                _conv1d(sd, f"blocks.{n}.convs1.{c}.1", block[f"conv1_{c}"])
                _conv1d(sd, f"blocks.{n}.convs2.{c}.1", block[f"conv2_{c}"])
                _dense(sd, f"blocks.{n}.films.{c}.0", block[f"film_{c}_0"])
                _dense(sd, f"blocks.{n}.films.{c}.3", block[f"film_{c}_1"])
    return sd


def spk_sparc_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`SpkSparcHiFiGANGenerator` params -> the port's
    `SpkSparcHiFiGANGenerator` state dict (the inverse of
    `convert_spk_sparc`: its checkpoint's `spk_ft` and `generator` parts are
    this dict's keys under `spk_ft.` and `generator.`)."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "spk_ft.spk_fc.0", params["spk_enc_0"])
    _dense(sd, "spk_ft.spk_fc.3", params["spk_enc_1"])
    for k, v in sparc_state_dict(params["generator"]).items():
        sd[f"generator.{k}"] = v
    return sd


def _ln(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _mha(sd, key, p) -> None:
    """flax MultiHeadDotProductAttention -> {q,k,v,out}_proj Linears."""
    for name, part in (("q", "query"), ("k", "key"), ("v", "value")):
        kern = np.asarray(p[part]["kernel"])  # (D, H, dh)
        sd[f"{key}.{name}_proj.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
        sd[f"{key}.{name}_proj.bias"] = _t(np.asarray(p[part]["bias"]).reshape(-1))
    kern = np.asarray(p["out"]["kernel"])  # (H, dh, D)
    sd[f"{key}.out_proj.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
    sd[f"{key}.out_proj.bias"] = _t(p["out"]["bias"])


def wav2vec2_state_dict(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """`Wav2Vec2Encoder` params -> the port's `Wav2Vec2Encoder` state dict
    (fairseq names; the inverse of `convert_wav2vec2(naming="fairseq")`)."""
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        _conv1d(sd, f"{prefix}feature_extractor.conv_layers.{i}.0", fe[f"conv_{i}"])
        i += 1
    _ln(sd, f"{prefix}feature_extractor.conv_layers.0.2", fe["group_norm"])
    _ln(sd, f"{prefix}layer_norm", params["feature_norm"])
    _dense(sd, f"{prefix}post_extract_proj", params["feature_projection"])
    _conv1d(sd, f"{prefix}encoder.pos_conv.0", params["pos_conv"]["conv"])
    _ln(sd, f"{prefix}encoder.layer_norm", params["encoder_norm"])
    i = 0
    while f"layer_{i}" in params:
        lp, q = params[f"layer_{i}"], f"{prefix}encoder.layers.{i}"
        _mha(sd, f"{q}.self_attn", lp["attention"])
        _ln(sd, f"{q}.self_attn_layer_norm", lp["layer_norm"])
        _dense(sd, f"{q}.fc1", lp["fc1"])
        _dense(sd, f"{q}.fc2", lp["fc2"])
        _ln(sd, f"{q}.final_layer_norm", lp["final_layer_norm"])
        i += 1
    return sd


def utmos_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """`UTMOSPredictor` params -> the port's `UTMOSPredictor` state dict
    (the lightning checkpoint's names with weight norm folded; the inverse
    of `convert_utmos`)."""
    sd = wav2vec2_state_dict(params["ssl"], prefix="feature_extractors.0.ssl_model.")
    sd["feature_extractors.1.embedding.weight"] = _t(params["domain_embedding"]["embedding"])
    sd["output_layers.0.judge_embedding.weight"] = _t(params["judge_embedding"]["embedding"])
    for k, v in params["decoder_rnn"].items():
        sd[f"output_layers.0.decoder_rnn.{k}"] = _t(v)
    _dense(sd, "output_layers.1.net.0", params["proj_0"])
    _dense(sd, "output_layers.1.net.3", params["proj_1"])
    return sd


def wavlm_state_dict(params: Dict, config, prefix: str = "") -> Dict[str, torch.Tensor]:
    """`WavLMEncoder` params -> the port's `WavLMEncoder` state dict (HF
    names; the inverse of `convert_wavlm`). Layers and the final LayerNorm
    that the tree lacks (a tapped init builds layers 0..tap-1 only) are left
    out."""
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    for i in range(len(config.conv_layers)):
        q = f"{prefix}feature_extractor.conv_layers.{i}"
        _conv1d(sd, f"{q}.conv", fe[f"conv_{i}"])
        if config.conv_norm == "layer":
            _ln(sd, f"{q}.layer_norm", fe[f"conv_ln_{i}"])
        elif i == 0:
            _ln(sd, f"{q}.layer_norm", fe["group_norm"])
    _ln(sd, f"{prefix}feature_projection.layer_norm", params["feature_norm"])
    _dense(sd, f"{prefix}feature_projection.projection", params["feature_projection"])
    _conv1d(sd, f"{prefix}encoder.pos_conv_embed.conv", params["pos_conv"]["conv"])
    if "encoder_norm" in params:
        _ln(sd, f"{prefix}encoder.layer_norm", params["encoder_norm"])
    for i in range(config.num_layers):
        if f"layer_{i}" not in params:
            continue
        lp, q = params[f"layer_{i}"], f"{prefix}encoder.layers.{i}"
        a = lp["attention"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{q}.attention.{name}", a[name])
        _dense(sd, f"{q}.attention.gru_rel_pos_linear", a["gate_proj"])
        sd[f"{q}.attention.gru_rel_pos_const"] = _t(a["gate_const"]).view(1, -1, 1, 1)
        if "rel_attn_embed" in a:
            sd[f"{q}.attention.rel_attn_embed.weight"] = _t(a["rel_attn_embed"])
        _ln(sd, f"{q}.layer_norm", lp["layer_norm"])
        _ln(sd, f"{q}.final_layer_norm", lp["final_layer_norm"])
        _dense(sd, f"{q}.feed_forward.intermediate_dense", lp["fc1"])
        _dense(sd, f"{q}.feed_forward.output_dense", lp["fc2"])
    return sd


def sparc_encoder_state_dict(params: Dict, config) -> Dict[str, torch.Tensor]:
    """`SparcEncoder` params -> the port's `SparcEncoder` state dict:
    `wavlm.` (as `wavlm_state_dict`, `config.wavlm`) and `ema_probe`."""
    sd = wavlm_state_dict(params["wavlm"], config.wavlm, prefix="wavlm.")
    _dense(sd, "ema_probe", params["ema_probe"])
    return sd


def _torch_adam_state(adam, where: str, module: torch.nn.Module, to_state_dict,
                      learning_rate: float, betas) -> Dict:
    """optax's `ScaleByAdamState` -> a `torch.optim.Adam` state dict for
    `module`'s parameters: step = the optax count, exp_avg = mu, exp_avg_sq
    = nu, the moments' trees mapped to `module`'s names by
    `to_state_dict`. Both packages then take the same next step."""
    if not all(hasattr(adam, k) for k in ("count", "mu", "nu")):
        raise ValueError(f"want optax's Adam state at {where}, got {type(adam)}")
    mu, nu = to_state_dict(adam.mu), to_state_dict(adam.nu)
    step = float(np.asarray(adam.count))
    template = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=tuple(betas),
                                eps=1e-8).state_dict()
    template["state"] = {
        i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": mu[n],
            "exp_avg_sq": nu[n]}
        for i, (n, _) in enumerate(module.named_parameters())
    }
    return template


def adam_state_from_jax(opt_state, model: torch.nn.Module, learning_rate: float) -> Dict:
    """The JAX training state's optimizer state (`optax.chain(clip,
    adam(learning_rate))` of `arttts_tpu/train/step.py:make_optimizer`) ->
    a `torch.optim.Adam` state dict for `model`'s parameters (the port's
    `train/step.py:make_optimizer`). A GradTTArtic state (its moments hold
    `spk_encoder`) maps through `grad_ttartic_state_dict`, any other
    through `grad_tts_state_dict`."""
    adam = opt_state[1][0]  # chain(clip: EmptyState, adam: (ScaleByAdamState, EmptyState))
    to_sd = (grad_ttartic_state_dict if "spk_encoder" in getattr(adam, "mu", {})
             else grad_tts_state_dict)
    return _torch_adam_state(adam, "opt_state[1][0]", model, to_sd, learning_rate,
                             (0.9, 0.999))


def plain_adam_state_from_jax(opt_state, module: torch.nn.Module, to_state_dict,
                              learning_rate: float, betas) -> Dict:
    """A plain `optax.adam` state, `(ScaleByAdamState, EmptyState)` (the
    vocoder trainer's `gen_opt` and `disc_opt`, whose betas are
    `train/vocoder_trainer.py:ADAM_BETAS`), -> a `torch.optim.Adam` state
    dict for `module`'s parameters; `to_state_dict` maps the moments' trees
    to `module`'s names (`hifigan_state_dict`, `disc_state_dict`)."""
    return _torch_adam_state(opt_state[0], "opt_state[0]", module, to_state_dict,
                             learning_rate, betas)
