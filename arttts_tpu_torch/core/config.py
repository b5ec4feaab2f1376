"""Typed configuration tree with named presets (a copy of
`arttts_tpu/core/config.py`, which the port may not import: it pulls in JAX).

The port serves every preset: the single-speaker family v0-v5 (ArtTTS,
GradTTS and AttentionTTS, text or phnm3 -> SPARC tracks or mel) and the v6
family (`v6`, `v6_zhCN`, `msml1h`: GradTTArtic, VoxCommunis phone features
-> SPARC articulatory tracks).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from arttts_tpu_torch.ops.shape import fix_len_compatibility
from arttts_tpu_torch.text.symbols import n_symbols_with_blank

# SPARC articulatory channel bookkeeping (ref configs/params_v1.py:22-35):
# raw SPARC features are 14 channels (12 EMA + pitch + loudness); they are
# reordered/padded into n_feats=16 for U-Net divisibility.
SPARC_REORDER_FEATS: Tuple[int, ...] = (0, 3, 1, 4, 2, 5, 6, 9, 7, 10, 8, 11, 15, 13)
SPARC_PITCH_IDX: int = SPARC_REORDER_FEATS[12]  # 15
SPARC_LOUDNESS_IDX: int = SPARC_REORDER_FEATS[13]  # 13


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Text/phoneme encoder (ref model/text_encoder.py:357-513)."""

    kind: str = "ipa_trait"  # "ipa_trait" (25-dim ternary input) | "text" (symbol ids)
    n_vocab: int = 0  # only for kind == "text"
    n_input_feats: int = 25  # only for kind == "ipa_trait"
    n_channels: int = 192  # prenet hidden (and embedding dim for "text")
    filter_channels: int = 768
    filter_channels_dp: int = 256
    n_heads: int = 1
    n_layers: int = 6
    kernel_size: int = 3
    dropout: float = 0.1
    window_size: int = 4
    prenet_kernel: int = 5
    prenet_layers: int = 3
    prenet_dropout: float = 0.5
    use_duration_predictor: bool = True  # False for aligned-input models (v6)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Score-based diffusion decoder (ref model/diffusion.py:263-348)."""

    kind: str = "unet2d"  # "unet2d" | "unet1d" | "unet1d_preblock"
    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    groups: int = 8
    beta_min: float = 0.05
    beta_max: float = 20.0
    pe_scale: int = 1000
    attn_heads: int = 4
    attn_dim_head: int = 32
    preblock_kernel: int = 9  # for "unet1d_preblock" (diffusion_1D_preblock.py:69-84)
    masked_norm: bool = False  # padding-exact GroupNorm stats (batched inference)
    # U-Net activation dtype ("float32" | "bfloat16"). bf16 halves the HBM
    # traffic of the bandwidth-bound serving loop; params and all norm
    # statistics stay f32 (checkpoint-compatible, see unet2d.py).
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full acoustic model (ref model/tts.py families)."""

    name: str = "art_tts"  # art_tts | grad_tts | attention_tts | attention_tts_preblock | grad_ttartic
    n_feats: int = 16  # output feature channels (16 artic / 80 mel)
    n_spks: int = 1
    spk_emb_dim: int = 64
    spk_preemb_dim: int = 1024  # multi-speaker SSL pre-embedding (model_ms)
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset wiring (ref configs/params_v*.py data sections)."""

    dataset: str = "text_artic"  # text_artic | phnm_artic | text_mel | phnm_mel | text_art | ms_phnm_artic
    train_filelist: str = ""
    valid_filelist: str = ""
    test_filelist: str = ""
    cmudict_path: str = "resources/cmu_dictionary"
    add_blank: bool = True
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float = 8000.0
    frame_rate: int = 50  # articulatory frame rate (SPARC, Hz)
    log_normalize_loudness: bool = False
    merge_diphthongs: bool = False
    # text path: True = GradTTS symbol conversion; False = the "phnmtext"
    # ARPAbet-first path (ref configs/params_v2_phnmtext.py:24-25,
    # data_textmel.py:95-107)
    gradtts_text_conv: bool = True
    # VoxCommunis wiring for the v6 family (ref configs/params_v6.py:66-89,
    # params_msml1h.py:64-160)
    suffix: str = "-20h"  # "-1h" | "-20h" corpus slice
    separate_files: bool = False  # True: per-language manifest/alignment dirs
    lang: str = "it"  # monolingual language when separate_files=False
    exclude_langs: Tuple[str, ...] = ()
    language_upsample: float = 0.0  # temperature upsample factor (0 = off)
    # static-shape bucketing for jit (TPU addition; reference pads dynamically)
    max_text_len: int = 256
    max_frame_len: int = 1024


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer hyperparameters (ref configs/params_v*.py training sections)."""

    log_dir: str = "logs/run"
    n_epochs: int = 10000
    batch_size: int = 16
    learning_rate: float = 1e-4
    random_seed: int = 37
    save_every: int = 5
    val_every: int = 5
    patience: int = 10
    test_size: int = 4
    out_size: int = fix_len_compatibility(2 * 50)
    grad_clip_norm: float = 1.0  # per-submodule clip (ref train.py:176-181)
    # optimizer steps fused into one dispatch (train/step.py:
    # make_train_multistep). 1 = the reference's one-launch-per-step loop;
    # >1 scans K steps per launch, amortizing host dispatch overhead
    # (r4 trace: 13.2 ms wall vs 5.6 ms device busy at K=1, B=16).
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "v1"
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()


def _artic_model(name="art_tts", decoder_kind="unet2d", n_heads=1) -> ModelConfig:
    return ModelConfig(
        name=name,
        n_feats=16,
        encoder=EncoderConfig(kind="ipa_trait", n_input_feats=25, n_heads=n_heads),
        decoder=DecoderConfig(kind=decoder_kind),
    )


def _mel_model(n_vocab: int) -> ModelConfig:
    return ModelConfig(
        name="grad_tts",
        n_feats=80,
        encoder=EncoderConfig(kind="text", n_vocab=n_vocab, n_heads=2),
        decoder=DecoderConfig(kind="unet2d"),
    )


# msml1h's 63-language training list and exclusions
# (ref configs/params_msml1h.py:87-160)
MSML1H_LANG_CODES: Tuple[str, ...] = (
    "ka", "ja", "ba", "ro", "hi", "uz", "tt", "el", "sr", "mt", "yo", "be",
    "uk", "hy-AM", "sk", "ckb", "ur", "tr", "vi", "sq", "bg", "ta", "sv-SE",
    "eu", "id", "sw", "tk", "kmr", "dv", "ha", "zh-HK", "bn", "mn", "zh-CN",
    "yue", "lij", "fr", "hsb", "cv", "ko", "nl", "ug", "mr", "ab", "it",
    "lt", "sl", "kk", "pa-IN", "ru", "cs", "gn", "ml", "nan-tw", "th", "pt",
    "ky", "pl", "ca", "myv", "hu", "rw", "am",
)
MSML1H_INSUFFICIENT_LANGS: Tuple[str, ...] = ("kk", "am", "ur", "sq")
MSML1H_ZEROSHOT_LANGS: Tuple[str, ...] = ("eu", "ka", "ab", "gn", "sw", "ha", "ko", "myv")
MSML1H_EXCLUDE_LANGS: Tuple[str, ...] = MSML1H_INSUFFICIENT_LANGS + MSML1H_ZEROSHOT_LANGS


def _presets() -> dict:
    artic_data = lambda ds: DataConfig(dataset=ds, frame_rate=50)  # noqa: E731
    mel_data = DataConfig(dataset="text_mel", sample_rate=22050)

    def artic_train(log_dir, **kw):
        return TrainConfig(
            log_dir=log_dir, out_size=fix_len_compatibility(2 * 50), **kw
        )

    def mel_train(log_dir, **kw):
        return TrainConfig(
            log_dir=log_dir, out_size=fix_len_compatibility(2 * 22050 // 256), **kw
        )

    # v6 family model: GradTTArtic aligned-input multi-speaker
    # (configs/params_v6.py:37-53 — note n_heads=2, n_ipa_feats=26)
    v6_model = ModelConfig(
        name="grad_ttartic",
        n_feats=16,
        n_spks=2,  # >1 enables the speaker-conditioned path
        encoder=EncoderConfig(
            kind="ipa_trait",
            n_input_feats=26,
            n_heads=2,
            use_duration_predictor=False,  # aligned inputs (model_ms)
        ),
        decoder=DecoderConfig(kind="unet2d"),
    )
    v6_train = artic_train(
        "logs/v6", test_size=8, n_epochs=5000, save_every=50, val_every=50
    )

    presets = {
        # v0: ArtTTS text→artic (configs/params_v0.py)
        "v0": ExperimentConfig(
            "v0",
            _artic_model(),
            artic_data("text_artic"),
            artic_train("logs/new_exp", patience=3),
        ),
        # v1/v1_1: ArtTTS phnm3→artic (configs/params_v1.py, params_v1_1.py)
        "v1": ExperimentConfig(
            "v1", _artic_model(), artic_data("phnm_artic"), artic_train("logs/v1")
        ),
        "v1_1": ExperimentConfig(
            "v1_1", _artic_model(), artic_data("phnm_artic"), artic_train("logs/v1_1")
        ),
        # v2: GradTTS text→mel (configs/params_v2.py)
        "v2": ExperimentConfig(
            "v2",
            _mel_model(n_symbols_with_blank()),
            mel_data,
            mel_train("logs/v2_full", save_every=200, val_every=200),
        ),
        # v2_phnmtext: v2 with the ARPAbet-first text path
        # (configs/params_v2_phnmtext.py)
        "v2_phnmtext": ExperimentConfig(
            "v2_phnmtext",
            _mel_model(n_symbols_with_blank()),
            dataclasses.replace(mel_data, gradtts_text_conv=False),
            mel_train("logs/v2_phnmtext"),
        ),
        # v3: ArtTTS phnm→mel (configs/params_v3.py)
        "v3": ExperimentConfig(
            "v3",
            dataclasses.replace(_artic_model(), n_feats=80),
            DataConfig(dataset="phnm_mel"),
            mel_train("logs/v3"),
        ),
        # v4: GradTTS text→artic (configs/params_v4.py)
        "v4": ExperimentConfig(
            "v4",
            dataclasses.replace(_mel_model(n_symbols_with_blank()), n_feats=16),
            artic_data("text_art"),
            artic_train("logs/v4"),
        ),
        # v4_phnmtext (configs/params_v4_phnmtext.py)
        "v4_phnmtext": ExperimentConfig(
            "v4_phnmtext",
            dataclasses.replace(_mel_model(n_symbols_with_blank()), n_feats=16),
            dataclasses.replace(
                artic_data("text_art"), gradtts_text_conv=False
            ),
            artic_train("logs/v4_phnmtext"),
        ),
        # v5: AttentionTTS phnm3→artic with 1D decoder (configs/params_v5.py)
        "v5": ExperimentConfig(
            "v5",
            _artic_model("attention_tts", "unet1d"),
            artic_data("phnm_artic"),
            artic_train("logs/v5", save_every=50, val_every=50),
        ),
        "v5_preblock": ExperimentConfig(
            "v5_preblock",
            _artic_model("attention_tts_preblock", "unet1d_preblock"),
            artic_data("phnm_artic"),
            artic_train("logs/v5_preblock", save_every=50, val_every=50),
        ),
        # v6 family: GradTTArtic multi-speaker aligned-input (configs/params_v6.py)
        "v6": ExperimentConfig(
            "v6",
            v6_model,
            DataConfig(
                dataset="ms_phnm_artic",
                frame_rate=50,
                suffix="-20h",
                separate_files=False,
                lang="it",
            ),
            v6_train,
        ),
        # v6_zhCN: the same recipe on Mandarin (configs/params_v6_zhCN.py:79-91)
        "v6_zhCN": ExperimentConfig(
            "v6_zhCN",
            v6_model,
            DataConfig(
                dataset="ms_phnm_artic",
                frame_rate=50,
                suffix="-20h",
                separate_files=False,
                lang="zh-CN",
            ),
            dataclasses.replace(v6_train, log_dir="logs/v6_zhCN"),
        ),
        # msml1h: 62-language multilingual 1h-per-language run with language
        # upsampling and exclusions (configs/params_msml1h.py:64-166)
        "msml1h": ExperimentConfig(
            "msml1h",
            v6_model,
            DataConfig(
                dataset="ms_phnm_artic",
                frame_rate=50,
                suffix="-1h",
                separate_files=True,
                exclude_langs=MSML1H_EXCLUDE_LANGS,
                language_upsample=0.9,
            ),
            dataclasses.replace(
                v6_train, log_dir="logs/msml1h", patience=0
            ),  # the msml1h trainer runs without early stopping
        ),
    }
    return presets


PRESETS = _presets()


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


def register_preset(config: ExperimentConfig) -> None:
    """Register a custom experiment preset (addressable by name in CLIs)."""
    PRESETS[config.name] = config
