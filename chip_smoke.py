#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`arttts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases, each
fatal on failure (exit code 1, no result line):

1. environment: the card (`nvidia-smi` name and power limit), torch/CUDA
   versions, whether nvcc and triton are present;
2. build the six hand-written kernels from `arttts_tpu_torch/csrc/` (nvcc,
   sm_90a, one process per source) and print ptxas' register/spill report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the v2 serving path gives it (B=1, 80x768 mel, float32, TF32 off
   in both): K1 `resblock2d` at all 13 of its call sites of one score
   evaluation plus padded, unmasked-statistics and two-utterance cases, K2
   `downsample2d` and K3 `conv_transpose2d` at both U-Net boundaries, K4
   `mrf_stage` at the vocoder's three stages with C <= 128 plus FiLM
   (SPARC window batches), B=2, ragged and multi-tile cases, K5
   `upsample1d` at both stride-2 upsamples in both paddings; and K6
   `maximum_path` (MAS) at the training bucket (B=16, 192 x 1024, ragged),
   (1, 1), T_y = T_x, t_x > t_y, T_x 33, 1,024 and 1,025 (the edges of its one-warp
   and several-warp routes), T_y not a multiple of 32, decision words in
   device memory, and a case of ties, bit for bit against its plain
   version and the NumPy oracle (at the bucket also its device time by
   kernel and the wrapper's masking alone); and at the articulatory model's
   shapes (v6, 16 feature rows): K1 at c_in 3 (the speaker plane) at 16x256
   with a padded length, K1 at 16x512, 8x256 (C=128) and 4x128 (C=256) with
   attention, K2 16 -> 8 and 8 -> 4 rows, K3 4 -> 8 and 8 -> 16, their block
   counts recorded (an `artic_kernel_shapes` line); time each (CUDA events)
   beside its bound, plain version and library call. K1-K5 (3xTF32 on the tensor
   cores) run each case twice and must give the same bits, and
   record their grids' block counts (every main-path launch must give each
   SM a block) and both bounds (tensor-core route and float32 CUDA cores);
   at the main path's shapes they also get their device time per call from
   `torch.profiler`. A line says whether each K2/K3 call beat its library
   call, and one whether K5's two calls of a request did (a failure if
   not); K1 and K4, which no single library call computes, get cuDNN's
   time for their convolutions (K1's 3x3 ones, K4's 18 per stage) as a
   yardstick of one part, and a line sums K1's calls into the kernel
   table's rows 1 and 2 per request; K1's cases record each 3x3 product's
   route (`ops/resblock2d.py:conv3x3_route`) and blocks and the 3x3
   products' device time beside their bound, with cases at bucket 1024 and
   at v6.batch's B=16, and a `k1_wgmma_route` line gives the `wgmma`
   kernels' registers, blocks an SM and shared memory;
3b. bf16: the bf16 modes of K1-K4 (`bf16=True`, the JAX kernels' bf16
   dots: operands rounded to bf16, float32 sums) against their plain bf16
   versions at the shapes of phase 3 (K1's 13 call sites and its padded,
   unmasked, two-utterance and v6 cases; K2/K3 at both boundaries and v6's;
   K4's three stages and FiLM), each within its TOL_KERNEL_BF16 and within
   half of the plain version's own bf16-vs-float32 distance (0.75 for a
   block with the attention, whose core is held alone at its rounding
   points: its context bf16 and equal to the plain one in 99% of its
   entries, q ctx to float32 accuracy; at P = 1024 also within half the
   core's distance, with controls of unrounded v and exp(k - max) that
   must differ), the same bits twice; each timed (events, device ms)
   beside its bf16 bound (dense bf16 peak) and the float32 kernel's time,
   summed per request by the kernel table's rows; K2/K3 beside one
   `F.conv2d` / `F.conv_transpose2d` call on bf16 operands at the main
   path's shapes (the library time of their bf16 mode);
4. hold the whole score network, kernel path against the module path, at
   80x768 (and at bucket 128 with padding), and the v6 estimator with the
   speaker plane at 16x256 (masked statistics, 181 valid frames; the module
   path given the same statistics) and 16x128;
4b. hold the full-width vocoder's fast path (K4, K5) against its module
   path at 768 frames, and time both alone at buckets 128, 384 and 768;
5. hold a short text -> wav request on the card (kernels) against the same
   request on the CPU (plain versions) with the same weights;
6. the main path: the full-width v2 GradTTS and HiFi-GAN from a seed serve
   three requests through `serve_text_to_wav` (buckets 128, 384 and 768:
   both GroupNorm statistics modes) and one bench-shape request through
   `synthesize_to_wav` (T_x 96, durations pinned to 768 frames, 50 steps),
   with every launch counter set to 0 just before and read just after:
   all five kernels must have run as often as the path calls them, K1 on
   the `wgmma` route as often as the route rule gives the buckets (none in
   6b's bf16 mode), and no plain version on the card;
6b. the same four requests with `kernel_bf16=True`: the same launch
   counts, every K1-K4 launch in the bf16 mode, no plain version on the
   card; the bench request's distance from the float32 one with the same
   draws; phase 5's request in bf16 on the card against the CPU's plain
   bf16 versions within TOL_WAV_BF16, which must lie below the CPU's own
   bf16-vs-float32 distance there and below the card's float32 request's;
7. one more bench-shape request under `torch.profiler`: kernel time by
   name and by the port's kernel it belongs to, K1's time by part (3x3
   conv, by route too, beside its bound; 1x1 products, GroupNorm statistics
   and application, attention core) with launches per evaluation, and the
   card's idle share (the port's span annotations are not kernels); the
   profile is taken through `utils/profiling.trace`, and its Chrome trace
   read back by `utils/trace_analysis` must agree with those sums within
   1%: `device_busy_seconds` with the device kernel ms and
   `grouped_report` (the same family substrings) with the ms by family;
7b. the bench-shape request and a B=4 decode at bucket 384 (10 Euler
   steps) under the profiler, float32 then bf16: kernel time by family,
   device ms an evaluation, idle share;
8. the SPARC articulatory vocoder at full width from a seed, through
   `vocode_sparc` (windowed and two-placement tracks), against
   `vocode_chunked` over its module path, with K4's FiLM mode and K5
   counted;
8b. artic_ms: the full-width v6 preset (GradTTArtic) from a seed, on a
   synthetic VoxCommunis layout (manifest, 100 Hz alignment, 1024-d speaker
   pre-embeddings) of three utterances aligned to 120, 231 and 480 frames
   (buckets 128, 256, 512), each through `infer/pipeline.py`'s
   `run_acoustic_inference(use_align=True)` (50 steps) and
   `run_sparc_vocoder`, with the launch counters set to 0 before and read
   after: (29, L) artifacts, finite wavs of L*256 samples, K1-K5 launched as
   often as the path calls them; walls and RTF per utterance;
8c. card_vs_cpu_artic: the 120-frame utterance with 4 steps on the card
   against the same on the CPU (plain versions), temperature 1e6;
8d. bf16_decoder: v2 with `compute_dtype="bfloat16"` (the module path in
   bf16, as the JAX package serves it) decodes phase 5's request on the
   card and on the CPU, within TOL_DEC_BF16 (below the same two
   distances as in 6b); K1-K3 launch no time;
9. training: the full-width v2 preset from seed 0 trains one epoch through
   `train/trainer.py:Trainer` on a seeded LJSpeech-shaped synthetic set
   (48 utterances, three batches of 16, and 16 for validation), with a
   checkpoint; K6 must run once per step and validation batch and plain MAS
   never on the card; a second `Trainer` resumes from `grad_1`; one more
   step runs under `torch.profiler` (kernel time by kind, idle share);
   then one `train_step` on the card is held against the same step on the
   CPU (B=2, short utterances, pinned draws, dropout off);
10. cli: every single-speaker preset at full width from seeded checkpoints,
   on a seeded corpus of four utterances it writes under
   `build/chip_smoke_cli/` (removed after), through `cli.synthesize.main`
   and `cli.vocode.main` in process: v0, v1 (Euler@50, Heun@15, DPM@10,
   `--use-align`), v2 (the three solvers at B=1 and at `--batch-size 4`),
   v3 (also `--use-align`), v4, v5 and v5_preblock, then both vocode
   modes. Each run's walls and K1-K5 launches are printed and held to the
   counts its evaluations give (K1-K3 on every 2D preset, none on v5's 1D
   and preblock decoders, K4/K5 in every vocode run); the B=4 artifacts
   are held against per-sentence ones with masked statistics, v1 (three
   solvers) and v5 on the card against the same CLI runs on the CPU, and
   v3, v2 at B=4 and v5 are profiled for device time an evaluation;
11. train_presets: one epoch each of v1 (2D, 16 rows), v3 (2D, 80 rows),
   v5 (1D), v6 and msml1h (GradTTArtic; msml1h over two languages with its
   preset's language upsampling) at full width from seed 0, through
   `cli.train.main` in process at --batch-size 16, on seeded corpora it
   writes under `build/chip_smoke_train_presets/` (removed after): 48
   training and 16 validation phnm3 utterances of 1.5-4 s, and 48
   VoxCommunis ones, validated on the same layout as the JAX CLI does.
   Each run is resumed from its `grad_1` (the weights equal the saved
   ones, Adam's steps restored); v1 and v6 log through a recording writer,
   so the epoch's `synthesize_samples` runs: K1-K3 held to 13 / 2 / 2 an
   evaluation x 50 x test_size, its DTW scalars finite. K6 must launch
   once per training and validation batch of v1, v3, v5 and never for the
   v6 family; no plain version on the card; finite losses, every
   parameter tensor moved, the checkpoints written; median step wall and
   peak memory per preset, and one more step of each under the profiler
   (device time, launches, idle share). Then one `train_step` of v1 and of
   v6 (B=2, pinned draws, dropout off) on the card against the CPU, as 9b;
12. eval: at full width from seeds (UTMOS: wav2vec2-base 12 x 768 with the
   BiLSTM head and 3,000 judges; the SPARC encoder: WavLM-Large, 24 x 1024
   built, 9 run, and the EMA probe; v1, v2 and both vocoders), on a corpus
   it writes under `build/chip_smoke_eval/` (removed after):
   `cli.encode_audio.main(["--native", ...])` over the corpus wavs (every
   file written, encode RTF), `cli.pipeline.main` for v2 (mel: quanti_mel
   against mels of the port's `audio/mel.py`, HiFi-GAN, UTMOS from a seeded
   lightning-named file) and v1 (sparc: quanti_art against the encoder's
   features, the SPARC vocoder, UTMOS), every CSV read and finite, K1-K5
   launched as often as the runs' evaluations and vocoder windows call
   them; the demo server (`cli.demo`) on 127.0.0.1, port 0, in a thread:
   GET /, /api/tts Euler@50 and DPM@10, /api/mos on the returned wav, any
   status but 200 a failure, K1-K5 counted per request; UTMOS scores of
   the v2 wavs and one wav's SPARC features card against CPU (TOL_MOS,
   TOL_ENC_REL, ENC_VOICED_AGREE, TOL_ENC_F0_HZ); walls: UTMOS audio
   seconds scored a second at B=32 x 10 s, the encoder's RTF, the
   pipelines by stage, the demo's requests;
13. train_vocoder: `cli.train_vocoder.main` in process at its defaults
   (V1 generator, 512 channels, rates (8, 8, 2, 2), MRF (3, 7, 11) x (1, 3,
   5), MPD + MSD, segment 8192, B=16) for VOC_STEPS steps on a corpus of
   24 seeded wavs of 1-4 s it writes under `build/chip_smoke_vocoder/`
   (removed after), then a VOC_FT_STEPS-step fine-tune from `--init-ckpt`
   on `--base-mels-dir` mels of the port's `audio/mel.py`: finite losses,
   `voc_*` checkpoints, K4 / K5 launched exactly 3 / 2 times a step (the
   discriminator update's generator pass) and no plain version on the
   card; the trained generator's K4/K5 `wav_hat` against its module path
   within TOL_WAV (phase 3 holds K4/K5 at the training shapes too); step
   walls, peak memory, the step by part (the discriminators' share by
   subtraction) and one step under the profiler (device time by kind,
   launches, idle share); one full-width step at B=2 on the card against
   the CPU (TOL_GAN_METRIC, TOL_GAN_UPDATE);
14. train_bf16: v2 (2D) and v5_preblock at full width with
   `compute_dtype="bfloat16"`: one B=16 loss and gradient against float32
   on the same weights, batch and draws within the JAX gate's bounds
   (`tests/test_train_bf16.py`: loss 2%, cosine 0.99, norm ratio
   0.8-1.25), then an epoch of three steps through `Trainer` in bf16 and in
   float32 (finite losses, K6 once a step and no other kernel, parameters
   and Adam float32, step walls and peak memory).
15. train_dp: data parallelism over two gloo ranks (spawned processes)
   sharing cuda:0 with CUDA tensors, the kernels built by the parent
   before: v2 at full width, two steps of a global batch of 16 (8 rows a
   rank, the preset's fixed buckets, pinned draws, dropout 0) through
   `train_step(ddp=...)` against the one-process step on the same batches
   on the card (losses within TOL_DP_LOSS, the first step's gradients
   within 9b's rule, the parameters within the CPU tests' band, the ranks'
   bit for bit equal), K6 once a step on each rank and no plain MAS on the
   card; the step walls and the gloo all-reduce of the gradient's bytes.
   Then `python -m torch.distributed.run --standalone --nproc_per_node=1
   -m arttts_tpu_torch.cli.train --mesh` (NCCL, world size 1) trains an
   epoch on a seeded corpus under `build/chip_smoke_dp/` (removed after)
   with its checkpoint (`grad_final`), and a second run resumes from it;
16. sample_sp: v2's flagship geometry (B=1, 80 x 768) sequence-parallel
   over the same two ranks: the SP score function against the unsharded
   module path on the card within the CPU test's band, a 4-step Euler
   `synthesize(mesh=...)` against the unsharded run within 2% (relative
   L2), the collectives and the wall of an evaluation beside the module
   path's. Two ranks on one card measure the collectives' cost and
   correctness, not scaling;
17. ema_corpus: seeded sentences of 1.5-4 s of the four EMA corpora in
   their own formats under `build/chip_smoke_ema/` (removed after): MNGU0
   labels, MOCHA labels and EST EMA at 500 Hz, MSPKA octal-escaped labels
   and ASCII EMA at 400 Hz, PB2007 labels in 100 Hz frames and float32 EMA
   (one sentence 10% NaN frames). `cli.generate_phnm3.main` over each
   corpus (every file equal to its reader's phnm3); `SpeakerMetadata` at
   each layout's EMA rate, `validate_ema` (the NaN sentence invalid, the
   rest valid), `set_splits`, `agg_Xy_split`; v1 at full width from a
   seeded checkpoint through `cli.synthesize.main` (Euler@50) over every
   sentence, K1-K3 launched 13 / 2 / 2 an evaluation x 50 x sentences and
   no plain version on the card; `quanti_art_corpus` of the artifacts
   against the corpus EMA at 50 Hz (one finite CSV row a valid sentence);
   a control of the corpus channels plus 1% noise (PCC above 0.95 for each
   corpus with EMA); one sentence card against CPU (phase 10's v1 check);
   walls by stage;
18. train_tp: tensor parallelism on phase 15's two ranks, run after phase
   16 and before 17: v2 at full width sharded by `parallel/tp.py:shard_tp`
   over a 1 x 2 mesh (each rank stores half of every sharded tensor and of
   its Adam moments), two `train_step`s of phase 15's global batches of 16
   with cuDNN's deterministic algorithms, against the one-process steps
   each rank runs just before in the same mode (losses within TOL_DP_LOSS
   of those and of phase 15's; the parameters within TOL_TP_DET of the
   same rank's and within the CPU tests' band of phase 15's; the ranks'
   gathered parameters bit for bit equal), K6 once a step on each
   rank and no plain MAS on the card, two all-reduces a step (one gather of
   the shards, one of the gradients' squares with the replicated
   gradients), each rank's stored parameter and Adam bytes against the
   one-process figure (0.45-0.55x), the step walls and one gather alone;
   then `Trainer` on a 1 x 2 mesh (the
   state replicated over the model axis, 8 rows a rank, the row on rank 0's
   gradients: one all-reduce a step) for an epoch and a resume under
   `build/chip_smoke_tp/` (removed after): rank 0 alone writes the
   checkpoints, the ranks end bit for bit equal, both resume to the saved
   state.

Prints JSON lines; the `{"kernels": [...]}` line (K1-K4 with a `bf16`
entry each) and the card line come before the last, which is
`{"ok": true, "device": {...}}`.
"""

import copy
import ctypes
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, TF32 on the
# tensor cores (dense), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 1e-4  # max |kernel - plain| <= TOL * max(1, max |plain|)
# The bf16 modes (phase 3b), the same measure, one tolerance a kernel: the
# kernel and its plain bf16 version sum in other orders, and a float32
# intermediate within an ulp of a bf16 rounding boundary is rounded apart.
# Each is set from the largest error phase 3b read in two runs on an
# NVIDIA H100 80GB HBM3 at 700 W: K1 5.1e-4 without the attention and
# 2.35e-3 with it (one flipped entry of the attention's context moves a
# column at every position), K2/K3 2.3e-6, K4 8.7e-4.
TOL_KERNEL_BF16 = {"resblock2d": 1e-3, "resblock2d+attn": 3e-3, "downsample2d": 1e-5,
                   "conv_transpose2d": 1e-5, "mrf_stage": 1.5e-3}
# ... and the mode: max |kernel - plain bf16| at most this share of max
# |plain bf16 - plain float32| on the same inputs, the CPU tests' rule
# against the JAX kernels (a float32 or one-pass TF32 kernel reads about
# 1, one that truncates or rounds only some operands more than half). A
# whole block with the attention reads up to 0.61 on the card from the
# context's flips, so it is held to 0.75, and its attention core, fed the
# same qkv on both sides, to its rounding points (`attn_core_check`).
BF16_GAP_SHARE = 0.5
BF16_GAP_SHARE_ATTN_BLOCK = 0.75
TOL_SCORE = 1e-3
TOL_VOC = 1e-3  # fast vocoder against its module path, on the wav in [-1, 1]
TOL_WAV = 2e-3
# phase 6b: phase 5's 4-step request with `kernel_bf16` on the card against
# the CPU's plain bf16 versions (wav in [-1, 1]); phase 8d: the bf16 decoder
# (module path), card against CPU. The bf16 function is chaotic at the ulp
# level (tests/test_torch_bf16.py): on an NVIDIA H100 80GB HBM3 at 700 W they
# read 5.41e-4 and 8.60e-4, against 7.54e-4 and 1.22e-3 between the bf16
# and the float32 request. Each tolerance must stay below that distance in
# the run, and the float32 request must fail it.
TOL_WAV_BF16 = 6.5e-4
TOL_DEC_BF16 = 1.05e-3
N_STEPS = 50
# K1's 13 calls of one score evaluation of the flagship U-Net, in call order:
# (input channels, None for the first block's input planes; output channels;
# level, the call running at rows F / 2^l and frames T / 2^l; block_only)
K1_CALLS = [(None, 64, 0, False), (64, 64, 0, False), (64, 128, 1, False),
            (128, 128, 1, False), (128, 256, 2, False), (256, 256, 2, False),
            (256, 256, 2, False), (256, 256, 2, False), (512, 128, 2, False),
            (128, 128, 2, False), (256, 64, 1, False), (64, 64, 1, False),
            (64, 64, 0, True)]


def k1_products(F, planes, bucket):
    """(c_in, c_out, H, T, call) of every 3x3 product of one evaluation."""
    out = []
    for i, (c_in, c_out, lv, block_only) in enumerate(K1_CALLS):
        H, T = F >> lv, bucket >> lv
        out.append((c_in or planes, c_out, H, T, i))
        if not block_only:
            out.append((c_out, c_out, H, T, i))
    return out


def k1_wgmma_calls(K1, B, F, planes, bucket, sms):
    """K1 calls of one evaluation with a 3x3 product on the `wgmma` route
    (`ops/resblock2d.py:conv3x3_route`)."""
    return len({i for c_in, c_out, H, T, i in k1_products(F, planes, bucket)
                if K1.conv3x3_route(B, c_in, c_out, H, T, False, sms)})


# K6's floor of dependent steps: per frame a max and an add (forward) and a
# bit test and a decrement (backtrace), each at least 4 cycles, at the
# H100 SXM's 1.98 GHz maximum clock (NVIDIA data sheet)
CLOCK_HZ = 1.98e9
MAS_CHAIN_CYCLES = 4 * 4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


CLI_TEXTS = [
    "the quick brown fox jumps over the lazy dog.",
    "printing was done in a different way.",
    "speech synthesis from a list of files, on one card.",
    "four sentences make one batch of the serving mode.",
]
CLI_PHONES = ["h", "ə", "l", "oʊ", "w", "ɜ˞", "d", "aɪ", "t", "s", "n", "i", "eɪ", "k", "m",
              "p", "b", "f", "v", "z", "ʃ", "æ", "ɑ", "ɪ", "u"]
CLI_PRESETS = ("v0", "v1", "v2", "v3", "v4", "v5", "v5_preblock")
# the JAX package's gated fast points (tests/test_heun_sampler.py:47,
# tests/test_dpm_sampler.py:96)
HEUN_STEPS, DPM_STEPS = 15, 10


def write_cli_corpus(root, presets=CLI_PRESETS):
    """A seeded single-speaker corpus in the JAX package's layouts under
    `root`: 22.05 kHz wavs, SPARC tracks (`encoded/emasrc`), phnm3
    alignments with their tracks (`phnm/phnm3`, `phnm/encoded_audio_en/emasrc`),
    a text and a phnm3 filelist of four utterances, a one-utterance phnm3
    list of about 4 s for the card-vs-CPU legs, full-width port
    checkpoints of every single-speaker preset (`ckpt/{preset}`), a
    HiFi-GAN `hifigan.pt` and a SPARC checkpoint in the reference's
    layouts, and a 1024-d speaker pre-embedding."""
    import numpy as np
    import torch

    from arttts_tpu_torch.audio.io import save_wav
    from arttts_tpu_torch.core.checkpoint import save_checkpoint
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.models.hifigan import build_sparc_vocoder, build_vocoder
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.text.phnms import build_phnm3

    r = np.random.default_rng(11)
    for d in ("wavs", "encoded/emasrc", "phnm/phnm3", "phnm/encoded_audio_en/emasrc"):
        (root / d).mkdir(parents=True)
    text_lines, phnm_lines = [], []
    for i, text in enumerate(CLI_TEXTS + ["(a longer alignment)"]):
        dur = 4.0 if i == len(CLI_TEXTS) else float(r.uniform(1.2, 2.2))
        t = np.arange(int(22050 * dur)) / 22050.0
        wav = 0.2 * np.sin(2 * np.pi * (110 + 30 * i) * t) + 0.02 * r.standard_normal(t.size)
        save_wav(root / "wavs" / f"utt{i:03d}.wav", wav.astype(np.float32), 22050)
        art = r.standard_normal((int(dur * 50), 14)).astype(np.float32)
        art[:, 12] = 120 + 25 * art[:, 12]  # pitch in Hz
        np.save(root / "encoded" / "emasrc" / f"utt{i:03d}.npy", art)
        np.save(root / "phnm" / "encoded_audio_en" / "emasrc" / f"utt{i:03d}.npy", art)
        n = max(4, int(dur / 0.08))
        cuts = np.sort(r.uniform(0.0, dur, n - 1))
        np.save(root / "phnm" / "phnm3" / f"utt{i:03d}_phnm3.npy",
                build_phnm3(list(r.choice(CLI_PHONES, n)), [0.0, *cuts, dur]))
        phnm_lines.append(f"DUMMY/wavs/utt{i:03d}.wav|DUMMY/phnm/phnm3/utt{i:03d}_phnm3.npy")
        text_lines.append(f"DUMMY/wavs/utt{i:03d}.wav|{text}")
    (root / "text.txt").write_text("\n".join(text_lines[:-1]))
    (root / "phnm.txt").write_text("\n".join(phnm_lines[:-1]))
    (root / "short.txt").write_text(phnm_lines[-1])
    for preset in presets:
        model = build_model(get_preset(preset).model, device="cpu",
                            seed=20 + CLI_PRESETS.index(preset))
        save_checkpoint(str(root / "ckpt"), preset, model.state_dict())
    torch.save({"generator": build_vocoder(device="cpu", seed=1).state_dict()},
               root / "hifigan.pt")
    parts = {"spk_ft": {}, "generator": {}}
    for key, v in build_sparc_vocoder(device="cpu", seed=2).state_dict().items():
        head, rest = key.split(".", 1)
        parts[head][rest] = v
    torch.save({"config": {"sr": 16000}, "state_dict": parts}, root / "sparc.ckpt")
    np.save(root / "spk.npy", r.standard_normal(1024).astype(np.float32))


def vocode_calls(frames):
    """Generator forwards `vocode_chunked` makes for tracks of these frame
    counts: one for a track within a window (512 + 2 x 32 frames), else one
    per batch of 8 windows; each runs 3 K4 stages and 2 K5 upsamples."""
    W = 512 + 2 * 32
    return sum(1 if n <= W else math.ceil(math.ceil(n / 512) / 8) for n in frames)


def cli_phase(card, dev, counters, plains, kernel_time, families):
    """Phase 10 (`cli`): every single-speaker preset from a filelist through
    `cli.synthesize.main` and `cli.vocode.main`, in process, at full width
    with seeded weights; returns the K1-K5 launches summed over its runs."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.cli import synthesize as cli_synthesize
    from arttts_tpu_torch.cli import vocode as cli_vocode
    from arttts_tpu_torch.core.config import get_preset, register_preset
    from arttts_tpu_torch.infer import pipeline
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d

    root = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_cli_corpus(root)
    corpus_s = time.perf_counter() - t0
    # v2 with padding-exact statistics: the per-sentence side of the batched check
    v2 = get_preset("v2")
    register_preset(dataclasses.replace(v2, name="v2_masked", model=dataclasses.replace(
        v2.model, decoder=dataclasses.replace(v2.model.decoder, masked_norm=True))))
    (root / "ckpt" / "v2_masked").symlink_to(root / "ckpt" / "v2")

    decodes = []  # (wall s, batch, bucket) of each decode call: the pipeline's sampler calls
    originals = {n: getattr(pipeline, n) for n in ("synthesize", "synthesize_from_encoding")}

    def timed(fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            decodes.append((time.perf_counter() - t, out[1].shape[0], out[1].shape[1]))
            return out
        return wrap

    for n, fn in originals.items():
        setattr(pipeline, n, timed(fn))

    def reset():
        for f in counters + plains:
            setattr(f, "launches" if f in counters else "cuda_calls", 0)
        GradLogPEstimator2d.cuda_calls = 0
        decodes.clear()

    runs, failures = [], []

    def synth(tag, preset, filelist, solver="euler", steps=N_STEPS, extra=(), device="cuda"):
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths = cli_synthesize.main([
            "--preset", preset, "--ckpt", str(root / "ckpt" / preset), "--filelist",
            str(root / filelist), "--data-root", str(root), "--artic-dir", str(root / "encoded"),
            "--save-dir", str(root / "art" / tag), "--n-timesteps", str(steps), "--solver",
            solver, "--device", device, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        arrs = {Path(p).name: np.load(p) for p in paths}
        launches = {f.__name__: f.launches for f in counters}
        plain = {f.__name__: f.cuda_calls for f in plains}
        is_mel = get_preset(preset).model.n_feats == 80
        evals = steps * (2 if solver == "heun" else 1) * len(decodes)
        kernels_2d = get_preset(preset).model.decoder.kind == "unet2d"
        want = {"resblock2d": 13 * evals * kernels_2d, "downsample2d": 2 * evals * kernels_2d,
                "conv_transpose2d": 2 * evals * kernels_2d, "mrf_stage": 0, "upsample1d": 0}
        frames = [int(a.shape[1]) for a in arrs.values()]
        audio_s = sum(f * 256 / 22050 if is_mel else f / 50 for f in frames)
        decode_s = sum(w for w, _, _ in decodes)
        rec = dict(run=tag, preset=preset, solver=solver, steps=steps, device=device,
                   args=list(extra), files=sorted(arrs), frames=frames,
                   decode_calls=[dict(wall_s=w, batch=b, bucket=T) for w, b, T in decodes],
                   evaluations=evals, cli_wall_s=wall, decode_wall_s=decode_s,
                   decode_wall_per_utterance_s=decode_s / max(1, len(frames)),
                   decode_rtf=decode_s / audio_s if audio_s else None, launches=launches,
                   plain_calls_on_card=plain,
                   module_path_calls_on_card=GradLogPEstimator2d.cuda_calls,
                   ok=len(arrs) > 0 and all(a.shape[0] == (161 if is_mel else 29)
                                            and np.isfinite(a).all() for a in arrs.values()))
        if device == "cuda":
            if launches != want or any(plain.values()):
                failures.append(f"{tag}: launches {launches}, expected {want}; plain {plain}")
            rec["expected_launches"] = want
        if not rec["ok"]:
            failures.append(f"{tag}: a wrong or non-finite artifact")
        runs.append(rec)
        return arrs

    def vocode(tag, mode, pred):
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        extra = (["--spk-ft", str(root / "spk.npy"), "--pitch-stats", "140", "30"]
                 if mode == "sparc" else [])
        paths = cli_vocode.main([
            "--mode", mode, "--torch-ckpt",
            str(root / ("sparc.ckpt" if mode == "sparc" else "hifigan.pt")), "--pred-dir",
            str(root / "art" / pred), "--save-dir", str(root / "wav" / tag), "--device",
            "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {f.__name__: f.launches for f in counters}
        frames = [np.load(root / "art" / pred / (Path(p).stem + ".npy")).shape[1] for p in paths]
        calls = vocode_calls(frames)
        want = {"resblock2d": 0, "downsample2d": 0, "conv_transpose2d": 0,
                "mrf_stage": 3 * calls, "upsample1d": 2 * calls}
        sr_want = 16000 if mode == "sparc" else 22050
        ok = len(paths) == len(frames) > 0
        for p, n in zip(paths, frames):
            wav, sr = load_wav(p)
            ok = ok and sr == sr_want and wav.shape == (n * 256,) and bool(np.isfinite(wav).all())
        runs.append(dict(run=tag, mode=mode, artifacts=pred, wavs=len(paths), frames=frames,
                         cli_wall_s=wall, rtf=wall / (sum(frames) * 256 / sr_want),
                         launches=launches, expected_launches=want, ok=ok))
        if launches != want or not launches["mrf_stage"] or not launches["upsample1d"]:
            failures.append(f"{tag}: launches {launches}, expected {want}")
        if not ok:
            failures.append(f"{tag}: a wrong or non-finite waveform")

    # warm-up (allocator, cuDNN plans of the encoders, the mel extractor), not counted
    synth("warm_text", "v2", "text.txt", steps=2)
    synth("warm_phnm", "v1", "phnm.txt", steps=2)
    runs.clear()
    failures.clear()
    total = dict.fromkeys((f.__name__ for f in counters), 0)

    def count():
        for f in counters:
            total[f.__name__] += f.launches

    plan = [("v0", "v0", "text.txt", "euler", N_STEPS, ()),
            ("v1", "v1", "phnm.txt", "euler", N_STEPS, ()),
            ("v1_heun15", "v1", "phnm.txt", "heun", HEUN_STEPS, ()),
            ("v1_dpm10", "v1", "phnm.txt", "dpm", DPM_STEPS, ()),
            ("v1_use_align", "v1", "phnm.txt", "euler", N_STEPS, ("--use-align",)),
            ("v2", "v2", "text.txt", "euler", N_STEPS, ()),
            ("v2_heun15", "v2", "text.txt", "heun", HEUN_STEPS, ()),
            ("v2_dpm10", "v2", "text.txt", "dpm", DPM_STEPS, ())]
    b4 = ("--batch-size", "4", "--temperature", "1e6")
    for solver, steps in (("euler", N_STEPS), ("heun", HEUN_STEPS), ("dpm", DPM_STEPS)):
        plan.append((f"v2_b4_{solver}", "v2", "text.txt", solver, steps, b4))
        plan.append((f"v2_masked_b1_{solver}", "v2_masked", "text.txt", solver, steps,
                     ("--temperature", "1e6")))
    plan += [("v3", "v3", "phnm.txt", "euler", N_STEPS, ()),
             ("v3_use_align", "v3", "phnm.txt", "euler", N_STEPS, ("--use-align",)),
             ("v4", "v4", "text.txt", "euler", N_STEPS, ()),
             ("v5", "v5", "phnm.txt", "euler", N_STEPS, ()),
             ("v5_preblock", "v5_preblock", "phnm.txt", "euler", N_STEPS, ())]
    arts = {}
    for tag, preset, fl, solver, steps, extra in plan:
        arts[tag] = synth(tag, preset, fl, solver, steps, extra)
        count()
    for tag, mode in (("v0", "sparc"), ("v1", "sparc"), ("v4", "sparc"), ("v5", "sparc"),
                      ("v5_preblock", "sparc"), ("v2", "mel"), ("v3", "mel"), ("v2_b4_dpm", "mel")):
        vocode(f"{tag}_wav", mode, tag)
        count()
    k123 = ("resblock2d", "downsample2d", "conv_transpose2d")
    for rec in runs:
        if "preset" not in rec:
            continue
        on_2d = get_preset(rec["preset"]).model.decoder.kind == "unet2d"
        if any((rec["launches"][k] > 0) != on_2d for k in k123):
            failures.append(f"{rec['run']}: K1-K3 launches {rec['launches']} on "
                            f"{get_preset(rec['preset']).model.decoder.kind}")

    # v1's dataset (as the JAX package's) carries no durations: --use-align
    # changes nothing there; v3's takes the phnm3 durations
    same = {n: float(np.abs(a - arts["v1"][n]).max()) for n, a in arts["v1_use_align"].items()}

    # batched (B=4, masked statistics) against per-sentence with masked statistics,
    # temperature 1e6; DPM's data prediction divides by alpha(1) = 0.0066, so
    # its tolerance is TOL_WAV of max(1, max|per-sentence|)
    batched = {}
    for solver in ("euler", "heun", "dpm"):
        b, s_ = arts[f"v2_b4_{solver}"], arts[f"v2_masked_b1_{solver}"]
        err = max(float(np.abs(b[n] - s_[n]).max()) if b[n].shape == s_[n].shape else math.inf
                  for n in s_)
        scale = (max(1.0, max(float(np.abs(a).max()) for a in s_.values()))
                 if solver == "dpm" else 1.0)
        batched[solver] = dict(files=sorted(b), max_abs_err=err, tol=TOL_WAV * scale,
                               input_map_equal=all(np.array_equal(b[n][160], s_[n][160])
                                                   for n in s_),
                               ok=sorted(b) == sorted(s_) and err <= TOL_WAV * scale)
        if not batched[solver]["ok"]:
            failures.append(f"batched vs per-sentence ({solver}): {batched[solver]}")

    # where the time goes: v3 (80 rows, the ipa_trait encoder), v2 at B=4 and
    # v5's module path, 10 steps each, profiled (device time by family)
    traces = {}
    for tag, preset, fl, extra in (("v3", "v3", "phnm.txt", ()),
                                   ("v2_b4", "v2", "text.txt", b4),
                                   ("v5", "v5", "phnm.txt", ())):
        reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            cli_synthesize.main(["--preset", preset, "--ckpt", str(root / "ckpt" / preset),
                                 "--filelist", str(root / fl), "--data-root", str(root),
                                 "--save-dir", str(root / "art" / f"prof_{tag}"),
                                 "--n-timesteps", "10", "--device", "cuda", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        _, busy, fam, calls = kernel_time(prof)
        evals = 10 * len(decodes)
        traces[tag] = dict(decode_calls=[dict(wall_s=w, batch=b, bucket=T) for w, b, T in decodes],
                           evaluations=evals, cli_wall_s_under_profiler=wall,
                           device_kernel_ms=busy, kernel_ms_by_family=fam,
                           launches_by_family=calls,
                           k1_k2_k3_device_ms_per_evaluation=sum(
                               fam[f] for f in list(families)[:3]) / evals,
                           device_ms_per_evaluation=busy / evals,
                           decode_wall_ms_per_evaluation=1e3 * sum(w for w, _, _ in decodes)
                           / evals)

    # card against CPU: the 4 s alignment on v1 (each solver) and v5, 4 steps,
    # temperature 1e6; the input map exactly, the rest within TOL_WAV (DPM: of
    # max(1, max|cpu|), as above)
    vs_cpu = {}
    for tag, preset, solver in (("v1_euler", "v1", "euler"), ("v1_heun", "v1", "heun"),
                                ("v1_dpm", "v1", "dpm"), ("v5_euler", "v5", "euler")):
        sides = {}
        for device in ("cuda", "cpu"):
            sides[device] = synth(f"vs_cpu_{tag}_{device}", preset, "short.txt", solver, 4,
                                  ("--temperature", "1e6"), device=device)
        (name, g), (_, c) = next(iter(sides["cuda"].items())), next(iter(sides["cpu"].items()))
        err = float(np.abs(g - c).max()) if g.shape == c.shape else math.inf
        scale = max(1.0, float(np.abs(c).max())) if solver == "dpm" else 1.0
        vs_cpu[tag] = dict(file=name, frames=int(g.shape[1]), steps=4, max_abs_err=err,
                           max_abs_cpu=float(np.abs(c).max()), tol=TOL_WAV * scale,
                           input_map_equal=bool(np.array_equal(g[28], c[28])),
                           ok=g.shape == c.shape and err <= TOL_WAV * scale
                           and bool(np.array_equal(g[28], c[28])))
        if not vs_cpu[tag]["ok"]:
            failures.append(f"card vs CPU ({tag}): {vs_cpu[tag]}")
    cpu_runs = [r for r in runs if r.get("device") == "cpu"]
    runs[:] = [r for r in runs if r.get("device") != "cpu"]

    for n, fn in originals.items():
        setattr(pipeline, n, fn)
    emit({"cli": {"card": card, "corpus_s": corpus_s,
                  "entry": "cli.synthesize.main / cli.vocode.main, in process",
                  "runs": runs, "use_align_v1_max_diff_to_v1": same,
                  "batched_vs_per_sentence": batched, "traces": traces,
                  "card_vs_cpu": vs_cpu,
                  "cpu_legs_cli_wall_s": {r["run"]: r["cli_wall_s"] for r in cpu_runs},
                  "launches": total}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("cli: " + "; ".join(failures))
    return total


TRAIN_PRESETS = ("v1", "v3", "v5", "v6", "msml1h")
VOX_PHONES = ["a", "t", "t͡ʃ", "aɪ", "kʰ", "ɛ", "ŋ", "ʃ", "i", "o", "u", "m", "n", "s", "SIL"]


def write_train_corpora(root, n_train=48, n_valid=16):
    """Seeded training corpora under `root` in the JAX package's layouts,
    utterances of 1.5-4 s: a phnm3 set (`phnm/`: alignments of 60-160 ms
    phones, SPARC tracks under `encoded_audio_en/emasrc`, 22.05 kHz wavs for
    the mel targets) with a training and a validation filelist; and two
    VoxCommunis layouts (a manifest, a 100 Hz alignment, SPARC tracks and
    1024-d speaker pre-embeddings a language): `vox/` of `n_train`
    Italian utterances (v6's language) and `vox_ml/` of `n_train // 2`
    each in Italian and French (msml1h's one file a language)."""
    import numpy as np

    from arttts_tpu_torch.audio.io import save_wav
    from arttts_tpu_torch.text.phnms import build_phnm3

    r = np.random.default_rng(21)
    phnm = root / "phnm"
    for d in ("wavs", "phnm3", "encoded_audio_en/emasrc"):
        (phnm / d).mkdir(parents=True)
    lines = []
    for i in range(n_train + n_valid):
        dur = float(r.uniform(1.5, 4.0))
        cuts = np.cumsum(r.uniform(0.06, 0.16, 80))
        bounds = np.concatenate([[0.0], cuts[cuts < dur - 0.06], [dur]])
        stem = f"utt{i:03d}"
        np.save(phnm / "phnm3" / f"{stem}_phnm3.npy",
                build_phnm3(list(r.choice(CLI_PHONES, len(bounds) - 1)), bounds))
        art = r.standard_normal((int(dur * 50) + 1, 14)).astype(np.float32)
        art[:, 12] = 120 + 25 * art[:, 12]  # pitch in Hz
        np.save(phnm / "encoded_audio_en" / "emasrc" / f"{stem}.npy", art)
        t = np.arange(int(22050 * dur)) / 22050.0
        wav = 0.2 * np.sin(2 * np.pi * (110 + i) * t) + 0.02 * r.standard_normal(t.size)
        save_wav(phnm / "wavs" / f"{stem}.wav", wav.astype(np.float32), 22050)
        lines.append(f"DUMMY/wavs/{stem}.wav|DUMMY/phnm3/{stem}_phnm3.npy")
    (phnm / "train.txt").write_text("\n".join(lines[:n_train]))
    (phnm / "valid.txt").write_text("\n".join(lines[n_train:]))

    def vox(base, langs, n):
        (base / "manifests").mkdir(parents=True)
        (base / "alignments").mkdir(parents=True)
        for lang in langs:
            enc = base / "encoded_audio_multi" / lang
            (enc / "emasrc").mkdir(parents=True)
            (enc / "spk_preemb").mkdir(parents=True)
            rows, aligns = [str(base / "wavs")], []
            for i in range(n):
                fid = f"cv_{lang}_{lang}_{i:04d}"
                seq, left = [], 2 * int(r.integers(75, 201))  # 100 Hz frames of 1.5-4 s
                while left:
                    k = min(left, 2 * int(r.integers(2, 9)))
                    seq += [str(r.choice(VOX_PHONES))] * k
                    left -= k
                art = r.standard_normal((len(seq) // 2, 14)).astype(np.float32)
                art[:, 12] = 120 + 25 * art[:, 12]
                art[:, 13] = np.abs(art[:, 13]) + 0.1  # loudness > 0
                np.save(enc / "emasrc" / f"{fid}.npy", art)
                np.save(enc / "spk_preemb" / f"{fid}.npy",
                        r.standard_normal(1024).astype(np.float32))
                rows.append(f"{lang}/{fid}.wav\t{len(seq) * 160}")  # 16 kHz samples
                aligns.append(f"{fid}\t{' '.join(seq)}")
            (base / "manifests" / f"{lang}.tsv").write_text("\n".join(rows) + "\n")
            (base / "alignments" / f"{lang}.align").write_text("\n".join(aligns) + "\n")

    vox(root / "vox", ["it"], n_train)
    vox(root / "vox_ml", ["it", "fr"], n_train // 2)


class Recorder:
    """A TensorBoard-style writer that keeps the trainer's scalars and the
    shapes of its images (the port's trainer logs through any such object)."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = float(value)

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images[tag] = list(img.shape)

    def close(self):
        pass


def _epoch_losses(log_file):
    """The loss dict of the last line of a trainer's `train.log` or
    `val.log` (`{epoch}\\t{dict}`)."""
    import ast

    return ast.literal_eval(log_file.read_text().strip().splitlines()[-1].split("\t", 1)[1])


def train_presets_phase(card, dev, counters, plains, K6):
    """Phase 11 (`train_presets`): one epoch each of v1 (2D, 16 rows), v3
    (2D, 80 rows), v5 (1D), v6 and msml1h (GradTTArtic; msml1h over two
    languages with its preset's language upsampling) at full width from
    seed 0, through `cli.train.main` in process at --batch-size 16, each
    resumed from its `grad_1`; v1 and v6 log through a recording writer,
    so the epoch's `synthesize_samples` runs on the kernels. Then one
    `train_step` of v1 and of v6 on the card against the same step on the
    CPU. Returns the launches of each kernel over the phase's runs."""
    import dataclasses

    import numpy as np
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arttts_tpu_torch.cli import train as cli_train
    from arttts_tpu_torch.core.config import get_preset, register_preset
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d
    from arttts_tpu_torch.train import trainer as trainer_mod
    from arttts_tpu_torch.train.losses import grad_ttartic_loss, grad_tts_loss, mas_log_prior
    from arttts_tpu_torch.train.step import make_optimizer, train_step

    phase_t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_train_presets"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_train_corpora(root)
    corpus_s = time.perf_counter() - t0
    all_counters = counters + [K6.maximum_path]
    all_plains = plains + [K6.maximum_path_plain]
    total = dict.fromkeys((f.__name__ for f in all_counters), 0)
    step_walls = []

    def timed_step(*a, **k):  # host clock around a step that ends in a sync
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(*a, **k)
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t)
        return m

    runs, failures = [], []
    real_writer = cli_train.tensorboard_writer
    trainer_mod.train_step = timed_step
    try:
        for preset in TRAIN_PRESETS:
            base = get_preset(preset)
            smoke_train = dataclasses.replace(base.train, save_every=1, val_every=1,
                                              random_seed=0)
            register_preset(dataclasses.replace(base, name=f"{preset}_smoke", train=smoke_train))
            log_dir = root / "logs" / preset
            if base.data.dataset == "ms_phnm_artic":
                vox = root / ("vox_ml" if base.data.separate_files else "vox")
                # the JAX CLI builds validation from the same layout
                data = ["--data-root", str(vox), "--manifest", str(vox / "manifests"),
                        "--alignment", str(vox / "alignments"), "--valid-filelist", "layout"]
            else:
                data = ["--data-root", str(root / "phnm"), "--train-filelist",
                        str(root / "phnm" / "train.txt"), "--valid-filelist",
                        str(root / "phnm" / "valid.txt")]
            args = ["--preset", f"{preset}_smoke", *data, "--log-dir", str(log_dir),
                    "--batch-size", "16"]
            rec = Recorder() if preset in ("v1", "v6") else None
            cli_train.tensorboard_writer = lambda _dir, rec=rec: rec
            for f in all_counters + all_plains:
                setattr(f, "launches" if f in all_counters else "cuda_calls", 0)
            GradLogPEstimator2d.cuda_calls = 0
            step_walls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            trainer = cli_train.main(args + ["--epochs", "1"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated()
            launches = {f.__name__: f.launches for f in all_counters}
            plain = {f.__name__: f.cuda_calls for f in all_plains}
            module_forwards = GradLogPEstimator2d.cuda_calls
            for k, v in launches.items():
                total[k] += v
            walls = list(step_walls)
            cfg = trainer.config
            n_steps, n_val = len(trainer.train_loader), len(trainer.valid_loader)
            mas = cfg.model.name != "grad_ttartic"
            n_synth = min(cfg.train.test_size, len(trainer.valid_dataset)) if rec else 0
            evals = N_STEPS * n_synth
            want = {"resblock2d": 13 * evals, "downsample2d": 2 * evals,
                    "conv_transpose2d": 2 * evals, "mrf_stage": 0, "upsample1d": 0,
                    "maximum_path": (n_steps + n_val) * mas}
            state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            seeded = build_model(cfg.model, device=dev, seed=0).state_dict()
            still = [k for k, v in state.items() if torch.equal(seeded[k], v)]
            n_tensors = len(state)
            del seeded
            files = sorted(p.name for p in log_dir.iterdir() if p.is_dir())
            train_losses = _epoch_losses(log_dir / "train.log")
            val_losses = _epoch_losses(log_dir / "val.log")
            lang_sampler = trainer.train_loader.lang_sampler
            # where a step's time goes: one more step (the epoch's first, longest
            # batch) under the profiler, after the counts were read
            batch = trainer._on_device(next(iter(trainer.train_loader)))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                train_step(trainer.model, trainer.optimizer, batch, trainer.generator,
                           cfg.train.out_size, cfg.train.grad_clip_norm, trainer.loss_fn)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t) * 1e3
            kern = [(a.self_device_time_total / 1e3, a.count) for a in prof.key_averages()
                    if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
                    and not getattr(a, "is_user_annotation", False)]
            busy_ms = sum(ms for ms, _ in kern)
            del trainer, batch, prof
            resumed = cli_train.main(args + ["--epochs", "1", "--resume",
                                             str(log_dir / "grad_1")])
            restored = resumed.model.state_dict()
            same = all(torch.equal(v, restored[k]) for k, v in state.items())
            adam_steps = sorted({float(s["step"]) for s in resumed.optimizer.state.values()})
            resume_epoch = resumed.start_epoch
            del resumed, restored, state
            dtw = {k: v for k, v in (rec.scalars.items() if rec else ()) if "dtw" in k}
            walls_ms = sorted(1e3 * w for w in walls[1:])
            runs.append(dict(
                preset=preset, model=cfg.model.name, decoder=cfg.model.decoder.kind,
                rows=cfg.model.n_feats, batch_size=cfg.train.batch_size,
                out_size=cfg.train.out_size,
                language_upsample=(cfg.data.language_upsample if lang_sampler else None),
                language_probas=(lang_sampler.probas.tolist() if lang_sampler else None),
                steps=n_steps, validation_batches=n_val, cli_wall_s=cli_s,
                step_wall_ms=[1e3 * w for w in walls],
                median_step_ms_after_first=walls_ms[len(walls_ms) // 2] if walls_ms else None,
                max_memory_allocated_bytes=peak, train_losses=train_losses,
                val_losses=val_losses, launches=launches, expected_launches=want,
                plain_calls_on_card=plain, module_path_forwards_on_card=module_forwards,
                tensors_not_moved=still, n_tensors=n_tensors, checkpoints=files,
                resume_epoch=resume_epoch,
                resume_adam_steps=adam_steps, resume_weights_equal=same,
                synthesized=n_synth, dtw=dtw, images=len(rec.images) if rec else 0,
                step_profile=dict(wall_ms_under_profiler=prof_wall_ms, device_kernel_ms=busy_ms,
                                  kernel_launches=sum(c for _, c in kern),
                                  idle_share_under_profiler=1 - busy_ms / prof_wall_ms,
                                  idle_share_of_median_step=(
                                      1 - busy_ms / walls_ms[len(walls_ms) // 2]
                                      if walls_ms else None))))
            finite = all(math.isfinite(v)
                         for v in [*train_losses.values(), *val_losses.values()])
            if launches != want or any(plain.values()):
                failures.append(f"{preset}: launches {launches}, expected {want}; plain {plain}")
            if n_steps != 3 or n_val != (3 if cfg.data.dataset == "ms_phnm_artic" else 1):
                failures.append(f"{preset}: {n_steps} steps, {n_val} validation batches")
            if not finite or still:
                failures.append(f"{preset}: losses {train_losses} {val_losses}, "
                                f"tensors not moved {still}")
            if not {"grad_1", "grad_best", "grad_final"} <= set(files):
                failures.append(f"{preset}: checkpoints {files}")
            if resume_epoch != 2 or adam_steps != [float(n_steps)] or not same:
                failures.append(f"{preset}: resumed at epoch {resume_epoch}, Adam steps "
                                f"{adam_steps}, weights equal {same}")
            if rec and (len(dtw) != n_synth or not all(math.isfinite(v) for v in dtw.values())):
                failures.append(f"{preset}: DTW scalars {dtw}")
            if (preset == "msml1h") != (lang_sampler is not None):
                failures.append(f"{preset}: language sampler {lang_sampler}")
            torch.cuda.empty_cache()
    finally:
        trainer_mod.train_step = train_step
        cli_train.tensorboard_writer = real_writer

    # one train_step of v1 and of v6 on the card against the same step on the
    # CPU: B=2, the encoder's dropout off, pinned draws (t, z, offsets)
    step_checks = {}
    r = np.random.default_rng(8)
    for preset in ("v1", "v6"):
        base = get_preset(preset)
        m_cfg = dataclasses.replace(base.model, encoder=dataclasses.replace(
            base.model.encoder, dropout=0.0, prenet_dropout=0.0))
        out_size, F_ = base.train.out_size, m_cfg.n_feats
        x_l, y_l = np.array([48, 37], np.int32), np.array([192, 150], np.int32)
        n_in = m_cfg.encoder.n_input_feats
        xb = r.integers(-1, 2, (2, 48, n_in)).astype(np.float32)
        yb = r.standard_normal((2, 192, F_)).astype(np.float32)
        if preset == "v6":  # the last channel: aligned durations of 2-4 frames
            xb[..., -1] = r.integers(2, 5, (2, 48))
        for i in range(2):
            xb[i, x_l[i]:] = 0
            yb[i, y_l[i]:] = 0
        batch_np = dict(x=xb, x_lengths=x_l, y=yb, y_lengths=y_l,
                        pinned_t=r.uniform(0.05, 0.95, 2).astype(np.float32),
                        pinned_z=r.standard_normal((2, out_size, F_)).astype(np.float32),
                        pinned_offsets=(r.random(2) * (y_l - out_size)).astype(np.int32))
        if preset == "v6":
            batch_np.update(spk=r.standard_normal((2, 1024)).astype(np.float32),
                            durations=xb[..., -1].copy())
        loss_fn = grad_ttartic_loss if preset == "v6" else grad_tts_loss
        side = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            m = build_model(m_cfg, device=d, seed=0)
            est_d = m.decoder.estimator
            with torch.no_grad():
                for k, site in enumerate([lv[2] for lv in est_d.downs] + [est_d.mid_attn]
                                         + [u[2] for u in est_d.ups]):
                    site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
            b = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
            path = None
            if preset == "v1":  # the MAS path the step aligns by
                with torch.no_grad():
                    mu_x, _, x_mask = m.encode(b["x"], b["x_lengths"])
                    y_mask = (torch.arange(192, device=d)[None]
                              < b["y_lengths"][:, None]).float()
                    lp, am = mas_log_prior(mu_x, b["y"], x_mask, y_mask[:, :, None])
                    path = K6.maximum_path(lp, am).cpu()
            metrics = train_step(m, make_optimizer(m, base.train.learning_rate), b, None,
                                 out_size, base.train.grad_clip_norm, loss_fn)
            side[name] = dict(path=path, metrics={k: float(v) for k, v in metrics.items()},
                              grads={n: p.grad.cpu() for n, p in m.named_parameters()})
            del m
        gpu, cpu = side["card"], side["cpu"]
        paths_equal = gpu["path"] is None or torch.equal(gpu["path"], cpu["path"])
        loss_rel = {k: abs(gpu["metrics"][k] - cpu["metrics"][k])
                    / max(abs(cpu["metrics"][k]), 1e-30) for k in cpu["metrics"]}
        grad_worst, grad_name = 0.0, ""
        for n, gc in cpu["grads"].items():
            share = ((gpu["grads"][n] - gc).abs().max().item()
                     / (1e-3 * gc.abs().max().item() + 1e-7))
            if share > grad_worst:
                grad_worst, grad_name = share, n
        step_checks[preset] = dict(
            B=2, T_x=48, T_y=192, out_size=out_size, mas_paths_equal=paths_equal,
            metrics_card=gpu["metrics"], metrics_cpu=cpu["metrics"], metrics_rel_diff=loss_rel,
            grad_tolerance_share_worst=grad_worst, grad_worst_tensor=grad_name,
            tol="losses rtol 1e-4; grads 1e-3 * max|g_cpu| + 1e-7 per tensor",
            ok=paths_equal and max(loss_rel.values()) <= 1e-4 and grad_worst <= 1.0)
        if not step_checks[preset]["ok"]:
            failures.append(f"card vs CPU step ({preset}): {step_checks[preset]}")

    emit({"train_presets": {"card": card, "corpus_s": corpus_s,
                            "corpora": "48 training and 16 validation utterances of 1.5-4 s "
                                       "(phnm3); 48 VoxCommunis utterances (v6: it; msml1h: "
                                       "24 it + 24 fr), validation from the same layout",
                            "entry": "cli.train.main, in process, then --resume grad_1",
                            "runs": runs, "card_vs_cpu_train_step": step_checks,
                            "launches": total, "phase_s": time.perf_counter() - phase_t0}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("train_presets: " + "; ".join(failures))
    return total


# phase 12 (`eval`): card against CPU on the same weights, each set at about
# 10x the distance its first run read (H100, 700 W): UTMOS scores 2.4e-7;
# EMA 3.27e-6 and loudness 2.1e-7 of max|CPU|; voicing agreed on all 199
# frames (the limit lets 1% flip), f0 1.5e-4 Hz where both are voiced.
TOL_MOS = 2.5e-6  # max |card - CPU| of a UTMOS score
TOL_ENC_REL = 3.3e-5  # EMA and loudness: max |card - CPU| / max |CPU|
ENC_VOICED_AGREE = 0.99  # share of frames whose voicing decision agrees
TOL_ENC_F0_HZ = 1.5e-3  # f0 on the frames voiced on both sides
UTMOS_B, UTMOS_BUCKET = 32, 160000  # the throughput batch: 32 clips of 10 s


def eval_phase(card, dev, counters, plains):
    """Phase 12 (`eval`): `cli.encode_audio --native` over a seeded corpus,
    `cli.pipeline` for v2 (mel, quanti_mel, UTMOS) and v1 (sparc,
    quanti_art on the encoder's features, UTMOS), the demo server's routes,
    card against CPU for UTMOS and the SPARC encoder, and the walls of each.
    Returns the K1-K5 launches of the pipelines and the demo."""
    import threading
    import http.client

    import numpy as np
    import torch

    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.audio.mel import MelSpectrogram
    from arttts_tpu_torch.cli import demo as cli_demo
    from arttts_tpu_torch.cli import encode_audio as cli_encode
    from arttts_tpu_torch.cli import pipeline as cli_pipeline
    from arttts_tpu_torch.cli import score as cli_score
    from arttts_tpu_torch.cli import synthesize as cli_synthesize
    from arttts_tpu_torch.cli import vocode as cli_vocode
    from arttts_tpu_torch.eval import quanti
    from arttts_tpu_torch.eval.utmos_scorer import UTMOSScorer
    from arttts_tpu_torch.models.sparc_encoder import SparcEncoderConfig, build_encoder
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d
    from arttts_tpu_torch.models.utmos import build_utmos

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    failures = []
    t0 = time.perf_counter()
    write_cli_corpus(root, presets=("v1", "v2"))
    # a seeded UTMOS in the lightning file's layout, pos_conv weight-normed (dim 2)
    sd = build_utmos(device="cpu", seed=3).state_dict()
    pc = "feature_extractors.0.ssl_model.encoder.pos_conv.0."
    w = sd.pop(pc + "weight")
    sd[pc + "weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pc + "weight_v"] = w
    torch.save({"state_dict": sd}, root / "utmos.ckpt")
    wav_paths = sorted((root / "wavs").glob("*.wav"))
    (root / "wavs.txt").write_text("\n".join(f"{p}|x" for p in wav_paths))
    mel = MelSpectrogram(device=dev)
    (root / "ref_mels").mkdir()
    for p in wav_paths:
        np.save(root / "ref_mels" / f"{p.stem}.npy", mel(load_wav(p)[0]).cpu().numpy())
    corpus_s = time.perf_counter() - t0

    def reset():
        for f in counters + plains:
            setattr(f, "launches" if f in counters else "cuda_calls", 0)
        GradLogPEstimator2d.cuda_calls = 0

    def read():
        plain = {f.__name__: f.cuda_calls for f in plains}
        plain["GradLogPEstimator2d"] = GradLogPEstimator2d.cuda_calls
        return {f.__name__: f.launches for f in counters}, plain

    stage_walls = {}

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_walls[name] = stage_walls.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrap

    # ---- encode_audio --native: the v1 pipeline's --ref-art-dir ----
    enc_walls = []
    orig_encode = quanti.encode_padded

    def encode_timed(encoder, wav, device):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_encode(encoder, wav, device)
        enc_walls.append((time.perf_counter() - t, len(wav) / 16000))
        return out

    quanti.encode_padded = encode_timed
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        cli_encode.main(["--manifest", str(root / "wavs.txt"), "--save-dir",
                         str(root / "encoded_native"), "--native", "--device", str(dev)])
    finally:
        quanti.encode_padded = orig_encode
    encode_wall = time.perf_counter() - t
    enc_files = sorted(p.name for p in (root / "encoded_native" / "emasrc").glob("*.npy"))
    spk_files = sorted(p.name for p in (root / "encoded_native" / "spk_preemb").glob("*.npy"))
    want_files = [f"{p.stem}.npy" for p in wav_paths]
    feats = {n: np.load(root / "encoded_native" / "emasrc" / n) for n in enc_files}
    encode = dict(files=len(enc_files), cli_wall_s=encode_wall,
                  encode_wall_s=[w for w, _ in enc_walls[1:]],
                  audio_s=[a for _, a in enc_walls[1:]],
                  rtf_excluding_first=(sum(w for w, _ in enc_walls[1:])
                                       / sum(a for _, a in enc_walls[1:])),
                  first_call_s=enc_walls[0][0] if enc_walls else None,
                  launches=read()[0])
    if enc_files != want_files or spk_files != want_files:
        failures.append(f"encode_audio wrote {enc_files} / {spk_files}, expected {want_files}")
    if not all(a.ndim == 2 and a.shape[1] == 14 and np.isfinite(a).all() for a in feats.values()):
        failures.append("encode_audio: a wrong or non-finite feature track")
    if any(encode["launches"].values()):
        failures.append(f"encode_audio launched a K1-K5 kernel: {encode['launches']}")

    # ---- the pipelines, each stage timed ----
    patches = [(cli_synthesize, "main", "synthesize"), (quanti, "quanti_mel", "quanti"),
               (quanti, "quanti_art", "quanti"), (cli_vocode, "main", "vocode"),
               (cli_score, "main", "score")]
    originals = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, name in patches:
        setattr(m, a, timed(name, getattr(m, a)))
    pipelines = {}
    try:
        for preset, fl, extra in (
                ("v2", "text.txt", ["--ref-mel-dir", str(root / "ref_mels"), "--vocoder-ckpt",
                                    str(root / "hifigan.pt")]),
                ("v1", "phnm.txt", ["--artic-dir", str(root / "encoded"), "--ref-art-dir",
                                    str(root / "encoded_native" / "emasrc"), "--vocoder-ckpt",
                                    str(root / "sparc.ckpt"), "--spk-ft", str(root / "spk.npy"),
                                    "--pitch-stats", "140", "30"])):
            work = root / "work" / preset
            stage_walls.clear()
            reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            cli_pipeline.main(["--preset", preset, "--ckpt", str(root / "ckpt" / preset),
                               "--filelist", str(root / fl), "--data-root", str(root),
                               "--workdir", str(work), "--utmos-ckpt", str(root / "utmos.ckpt"),
                               "--device", str(dev), *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches, plain = read()
            preds = sorted((work / "preds").glob("*.npy"))
            frames = [int(np.load(p).shape[1]) for p in preds]
            n_eval = N_STEPS * len(preds)
            n_voc = vocode_calls(frames)
            want = {"resblock2d": 13 * n_eval, "downsample2d": 2 * n_eval,
                    "conv_transpose2d": 2 * n_eval, "mrf_stage": 3 * n_voc,
                    "upsample1d": 2 * n_voc}
            csvs = {}
            for name in ("quanti_mel" if preset == "v2" else "quanti_art", "utmos"):
                with open(work / f"{name}.csv") as f:
                    rows = [r.split(",") for r in f.read().strip().splitlines()]
                rows = rows[1:] if rows[0][0] == "sample_id" else rows
                vals = [float(v) for r in rows for v in r[1:]]
                csvs[name] = dict(rows=len(rows), values_finite=bool(np.isfinite(vals).all()),
                                  mean_by_column=np.mean([[float(v) for v in r[1:]]
                                                          for r in rows], axis=0).tolist())
            wavs = sorted((work / "wavs").glob("*.wav"))
            wav_ok = len(wavs) == len(preds) > 0
            for p in wavs:
                a, _ = load_wav(p)
                wav_ok = wav_ok and bool(np.isfinite(a).all()) and a.size > 0
            sr = 22050 if preset == "v2" else 16000
            audio_s = sum(f * 256 / sr for f in frames)
            pipelines[preset] = dict(
                utterances=len(preds), frames=frames, steps=N_STEPS, wall_s=wall,
                stage_wall_s=dict(stage_walls), audio_s=audio_s, rtf=wall / audio_s,
                launches=launches, expected_launches=want, plain_calls_on_card=plain,
                csv=csvs, wavs_ok=wav_ok)
            if launches != want or any(plain.values()):
                failures.append(f"pipeline {preset}: launches {launches}, expected {want}; "
                                f"plain {plain}")
            if not wav_ok or any(c["rows"] != len(preds) or not c["values_finite"]
                                 for c in csvs.values()):
                failures.append(f"pipeline {preset}: wavs or CSVs wrong: {csvs}")
    finally:
        for m, a, fn in originals:
            setattr(m, a, fn)

    # ---- the demo server: GET /, /api/tts (Euler@50, DPM@10), /api/mos ----
    app = cli_demo.DemoApp("v2", ckpt=str(root / "ckpt" / "v2"),
                           vocoder_ckpt=str(root / "hifigan.pt"),
                           utmos_ckpt=str(root / "utmos.ckpt"), device=dev)
    srv = cli_demo.serve(app, "127.0.0.1", 0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()

    def request(method, path, body=None):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=300)
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        conn.request(method, path, body=body)
        r = conn.getresponse()
        data = r.read()
        wall = time.perf_counter() - t
        conn.close()
        return r.status, data, wall, read()

    demo = []
    try:
        np.random.seed(0)  # the requests' generator seeds
        warm = request("POST", "/api/tts", json.dumps({"text": CLI_TEXTS[1], "n_timesteps": 2}))
        if warm[0] != 200:
            failures.append(f"demo warm-up /api/tts: status {warm[0]}: {warm[1][:300]!r}")
        for method, path, body, steps in (
                ("GET", "/", None, 0),
                ("POST", "/api/tts", {"text": CLI_TEXTS[0], "n_timesteps": N_STEPS,
                                      "solver": "euler"}, N_STEPS),
                ("POST", "/api/tts", {"text": CLI_TEXTS[0], "n_timesteps": DPM_STEPS,
                                      "solver": "dpm"}, DPM_STEPS),
                ("POST", "/api/mos", "last wav", 0)):
            if body == "last wav":
                body = demo[-1]["_wav"]
            elif body is not None:
                body = json.dumps(body)
            status, data, wall, (launches, plain) = request(method, path, body)
            tts = path == "/api/tts"
            want = {"resblock2d": 13 * steps, "downsample2d": 2 * steps,
                    "conv_transpose2d": 2 * steps, "mrf_stage": 3 * tts, "upsample1d": 2 * tts}
            rec = dict(method=method, path=path, steps=steps, status=status, wall_s=wall,
                       bytes=len(data), launches=launches, expected_launches=want,
                       plain_calls_on_card=plain)
            if tts:
                rec["_wav"] = data
                rec["audio_s"] = (len(data) - 44) / 2 / 22050
            if path == "/api/mos" and status == 200:
                rec["mos"] = json.loads(data)["mos"]
            demo.append(rec)
            if status != 200:
                failures.append(f"demo {method} {path}: status {status}: {data[:300]!r}")
            if launches != want or any(plain.values()):
                failures.append(f"demo {method} {path}: launches {launches}, expected {want}; "
                                f"plain {plain}")
    finally:
        srv.shutdown()
        server.join(timeout=30)
        srv.server_close()
    for r in demo:
        r.pop("_wav", None)
    if "mos" not in demo[-1] or not math.isfinite(demo[-1]["mos"]):
        failures.append(f"demo /api/mos: {demo[-1]}")

    # ---- card against CPU, the same weights ----
    card_scores = {}
    with open(root / "work" / "v2" / "utmos.csv") as f:
        for line in f.read().strip().splitlines():
            name, v = line.split(",")
            card_scores[name] = float(v)
    cpu_scores = UTMOSScorer.from_lightning_checkpoint(str(root / "utmos.ckpt"), device="cpu") \
        .score_directory(str(root / "work" / "v2" / "wavs"))
    mos_err = max(abs(card_scores[n] - cpu_scores[n]) for n in cpu_scores)
    mos_check = dict(files=len(cpu_scores), max_abs_err=mos_err, tol=TOL_MOS,
                     ok=sorted(cpu_scores) == sorted(card_scores) and mos_err <= TOL_MOS)
    if not mos_check["ok"]:
        failures.append(f"UTMOS card vs CPU: {mos_check}")

    enc_cpu = build_encoder(None, SparcEncoderConfig(), device="cpu")  # the CLI's seed
    name = want_files[-1]  # the 4 s utterance
    wav, _ = load_wav(root / "wavs" / name.replace(".npy", ".wav"), target_sr=16000)
    cpu_feats, _ = quanti.encode_padded(enc_cpu, wav, torch.device("cpu"))
    gpu_feats = feats[name]
    rel = {col: float(np.abs(gpu_feats[:, sl] - cpu_feats[:, sl]).max()
                      / max(np.abs(cpu_feats[:, sl]).max(), 1e-30))
           for col, sl in (("ema", slice(0, 12)), ("loudness", slice(13, 14)))}
    v_g, v_c = gpu_feats[:, 12] > 0, cpu_feats[:, 12] > 0
    agree = float((v_g == v_c).mean())
    both = v_g & v_c
    f0_err = float(np.abs(gpu_feats[both, 12] - cpu_feats[both, 12]).max()) if both.any() else 0.0
    enc_check = dict(file=name, frames=int(gpu_feats.shape[0]), rel_err=rel,
                     voiced_agree_share=agree, voiced_frames=int(both.sum()),
                     f0_max_abs_err_hz=f0_err,
                     tol=dict(rel=TOL_ENC_REL, voiced_agree=ENC_VOICED_AGREE,
                              f0_hz=TOL_ENC_F0_HZ),
                     ok=(gpu_feats.shape == cpu_feats.shape and max(rel.values()) <= TOL_ENC_REL
                         and agree >= ENC_VOICED_AGREE and f0_err <= TOL_ENC_F0_HZ))
    if not enc_check["ok"]:
        failures.append(f"SparcEncoder card vs CPU: {enc_check}")
    del enc_cpu

    # ---- throughput: UTMOS at B=32 x 10 s, one 10 s clip through the encoder ----
    scorer = UTMOSScorer.from_lightning_checkpoint(str(root / "utmos.ckpt"), device=dev)
    clip = np.tile(load_wav(wav_paths[0], target_sr=16000)[0], 10)[:UTMOS_BUCKET]
    batch = [np.roll(clip, 997 * i) for i in range(UTMOS_B)]
    scorer.score_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_it = 3
    t = time.perf_counter()
    for _ in range(n_it):
        scores = scorer.score_batch(batch)
    utmos_s = (time.perf_counter() - t) / n_it
    enc_card = build_encoder(None, SparcEncoderConfig(), device=dev)
    quanti.encode_padded(enc_card, clip, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_it):
        quanti.encode_padded(enc_card, clip, dev)
    enc10_s = (time.perf_counter() - t) / n_it
    throughput = dict(
        utmos=dict(batch=UTMOS_B, bucket_s=UTMOS_BUCKET / 16000, wall_s_per_batch=utmos_s,
                   audio_s_per_s=UTMOS_B * UTMOS_BUCKET / 16000 / utmos_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   scores_finite=bool(np.isfinite(scores).all())),
        sparc_encoder_10s=dict(wall_s=enc10_s, rtf=enc10_s / 10.0))
    if not throughput["utmos"]["scores_finite"]:
        failures.append("UTMOS at B=32: non-finite scores")
    del scorer, enc_card, app
    torch.cuda.empty_cache()

    total = dict.fromkeys((f.__name__ for f in counters), 0)
    for rec in list(pipelines.values()) + demo:
        for k, v in rec["launches"].items():
            total[k] += v
    emit({"eval": {"card": card, "corpus_s": corpus_s, "encode_audio": encode,
                   "pipelines": pipelines, "demo": demo, "card_vs_cpu_utmos": mos_check,
                   "card_vs_cpu_sparc_encoder": enc_check, "throughput": throughput,
                   "launches": total, "phase_s": time.perf_counter() - t_phase}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("eval: " + "; ".join(failures))
    return total


# ---- phase 13 (`train_vocoder`) and phase 14 (`train_bf16`) -----------------
# card against CPU on one full-width GAN step at B=2 (TF32 off): the five
# metrics' relative distance and, for each parameter tree, the distance of
# the card's update (new - old) from the CPU's, relative L2 over the tree
# (about 10x what the first run read on an NVIDIA H100 80GB HBM3 at 700 W:
# metrics 1.08e-6; updates 7.6e-3 for the generator and 2.9e-3 for the
# discriminators, where Adam's first step, lr * g / (|g| + eps), flips the
# whole step of any element whose gradient's sign the two devices round apart)
TOL_GAN_METRIC = 1e-5
TOL_GAN_UPDATE = 7.5e-2
VOC_STEPS = 10
VOC_FT_STEPS = 2


def write_vocoder_corpus(root, n=24):
    """`n` seeded 22.05 kHz int16 wavs of 1-4 s under `root/wavs`: a few
    harmonics with a vibrato and noise, as a voice's spectrum is shaped."""
    import numpy as np
    from scipy.io import wavfile

    r = np.random.default_rng(31)
    (root / "wavs").mkdir(parents=True)
    for i in range(n):
        t = np.arange(int(22050 * r.uniform(1.0, 4.0))) / 22050.0
        f0 = r.uniform(90, 260) * (1 + 0.03 * np.sin(2 * np.pi * r.uniform(3, 7) * t))
        phase = 2 * np.pi * np.cumsum(f0) / 22050.0
        wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.3
        wav = wav + 0.02 * r.standard_normal(t.size)
        wavfile.write(root / "wavs" / f"voc{i:02d}.wav", 22050,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def train_vocoder_phase(card, dev, counters, plains):
    """Phase 13 (`train_vocoder`): `cli.train_vocoder.main` at its defaults
    (V1 generator, 512 channels, MPD + MSD, segment 8192, B=16) for
    VOC_STEPS steps on a seeded corpus, then a VOC_FT_STEPS-step fine-tune
    from `--init-ckpt` on base mels; K4/K5 launches held to steps x (3, 2);
    the fast `wav_hat` against the module path; one B=2 step card against
    CPU; step walls, peak memory, one profiled step. Returns the K1-K5
    launches of the two CLI runs."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arttts_tpu_torch.audio.mel import MelSpectrogram
    from arttts_tpu_torch.cli import train_vocoder as cli_voc
    from arttts_tpu_torch.core.checkpoint import load_vocoder_checkpoint
    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.data.vocoder_dataset import VocoderSegmentDataset
    from arttts_tpu_torch.models.hifigan import HiFiGANGenerator, hifigan_forward_fast
    from arttts_tpu_torch.train.vocoder_trainer import VocoderGAN

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_vocoder"
    shutil.rmtree(root, ignore_errors=True)
    failures = []
    t0 = time.perf_counter()
    write_vocoder_corpus(root)
    mel = MelSpectrogram(device=dev)
    (root / "base_mels").mkdir()
    wav_paths = sorted((root / "wavs").glob("*.wav"))
    for p in wav_paths:  # the "acoustic model's" mels: here the wavs' own
        w = load_wav(p)[0]
        np.save(root / "base_mels" / f"{p.stem}.npy", mel(w[: len(w) // 256 * 256]).cpu().numpy())
    corpus_s = time.perf_counter() - t0

    walls, metrics = [], []
    orig_step = VocoderGAN.train_step

    def timed_step(self, batch):  # host clock around a step that ends in a sync
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = orig_step(self, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    runs, total = [], dict.fromkeys((f.__name__ for f in counters), 0)
    VocoderGAN.train_step = timed_step
    try:
        for name, extra, steps in (
                ("train", ["--out-dir", str(root / "ckpt"), "--steps", str(VOC_STEPS),
                           "--save-every", str(VOC_STEPS)], VOC_STEPS),
                ("fine_tune", ["--out-dir", str(root / "ft"), "--steps", str(VOC_FT_STEPS),
                               "--save-every", "1", "--base-mels-dir", str(root / "base_mels"),
                               "--init-ckpt", str(root / "ckpt" / f"voc_{VOC_STEPS}")],
                 VOC_FT_STEPS)):
            walls.clear()
            metrics.clear()
            for f in counters + plains:
                setattr(f, "launches" if f in counters else "cuda_calls", 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rc = cli_voc.main(["--wav-dir", str(root / "wavs"), "--log-every", "5", *extra])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
            launches = {f.__name__: f.launches for f in counters}
            plain = {f.__name__: f.cuda_calls for f in plains}
            for k, v in launches.items():
                total[k] += v
            want = {"resblock2d": 0, "downsample2d": 0, "conv_transpose2d": 0,
                    "mrf_stage": 3 * steps, "upsample1d": 2 * steps}
            ms = sorted(1e3 * w for w in walls[1:])
            out = root / ("ckpt" if name == "train" else "ft")
            files = sorted(p.name for p in out.iterdir())
            runs.append(dict(run=name, rc=rc, steps=len(walls), cli_wall_s=cli_s,
                             step_wall_ms=[1e3 * w for w in walls],
                             median_step_ms_after_first=ms[len(ms) // 2] if ms else None,
                             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                             first_metrics=metrics[0], last_metrics=metrics[-1],
                             launches=launches, expected_launches=want,
                             plain_calls_on_card=plain, checkpoints=files))
            if rc != 0 or len(walls) != steps:
                failures.append(f"{name}: rc {rc}, {len(walls)} steps")
            if launches != want or any(plain.values()):
                failures.append(f"{name}: launches {launches}, expected {want}; plain {plain}")
            if not all(math.isfinite(v) for m in metrics for v in m.values()):
                failures.append(f"{name}: a loss is not finite: {metrics}")
            need = {f"voc_{VOC_STEPS}"} if name == "train" else {"voc_1", f"voc_{VOC_FT_STEPS}"}
            if not need <= set(files):
                failures.append(f"{name}: checkpoints {files}, expected {sorted(need)}")
    finally:
        VocoderGAN.train_step = orig_step

    # the discriminator pass's K4/K5 wav_hat against the module path, on the
    # trained weights and a B=16 batch
    ck = load_vocoder_checkpoint(str(root / "ckpt" / f"voc_{VOC_STEPS}"))
    gen = HiFiGANGenerator().to(dev)
    gen.load_state_dict(ck["gen"])
    ds = VocoderSegmentDataset([str(p) for p in wav_paths], device=dev)
    batch = ds.sample_batch(16, np.random.default_rng(3))
    with torch.no_grad():
        fast, module = hifigan_forward_fast(gen, batch["mel"]), gen(batch["mel"])
    wav_err = (fast - module).abs().max().item()
    if not torch.isfinite(fast).all() or wav_err > TOL_WAV:
        failures.append(f"wav_hat: K4/K5 against the module path {wav_err} > {TOL_WAV}")
    del gen, fast, module

    # where a step's time goes, on a fresh GAN at the CLI's defaults: the two
    # updates by host clock, the generator's own part of (b) alone, and one
    # step under the profiler
    gan = VocoderGAN(device=dev, rng=torch.Generator().manual_seed(4))
    mel_b, wav_b = batch["mel"], batch["wav"]

    def sync_ms(fn, n=3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    def generator_alone():  # (b)'s generator: module forward, mel L1, backward
        gan.gen_opt.zero_grad(set_to_none=True)
        w = gan.generator(mel_b)
        ref = gan.mel(wav_b[:, :, 0]).clone()
        (gan.mel.differentiable(w[:, :, 0]) - ref).abs().mean().backward()

    gan.train_step(batch)  # warm
    parts = dict(step_ms=sync_ms(lambda: gan.train_step(batch)),
                 fast_generator_ms=sync_ms(lambda: hifigan_forward_fast(gan.generator, mel_b)),
                 disc_update_ms=sync_ms(lambda: gan.disc_step(mel_b, wav_b)),
                 gen_update_ms=sync_ms(lambda: gan.gen_step(mel_b, wav_b)),
                 generator_fwd_bwd_ms=sync_ms(generator_alone))
    disc_ms = (parts["disc_update_ms"] - parts["fast_generator_ms"]
               + parts["gen_update_ms"] - parts["generator_fwd_bwd_ms"])
    parts["discriminators_ms_by_subtraction"] = disc_ms
    parts["discriminators_share_of_step"] = disc_ms / parts["step_ms"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        gan.train_step(batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    # the step's device events, each counted once (deduplicated by stream,
    # start, end and name); the card's busy time is the union of their
    # intervals. cuDNN runs some convolutions on streams of its own beside
    # the default stream, so the kernels' summed time exceeds the busy time
    # by their overlap, shown per stream and per pair of streams
    raw = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    evs = sorted({(getattr(e, "device_resource_id", 0), e.time_range.start, e.time_range.end,
                   e.name) for e in raw}, key=lambda e: e[1])
    kinds = {"K4 mrf_stage": ("mrf_round_kernel",), "K5 upsample1d": ("upsample_kernel",),
             "convolutions and matmuls (cuDNN, cuBLAS)": ("conv", "cudnn", "xmma", "cutlass",
                                                          "gemm", "sm90_", "wgrad", "dgrad"),
             "FFT (the mel's STFT)": ("fft",), "optimizer (Adam, foreach)": ("multi_tensor_apply",),
             "reductions": ("reduce",), "elementwise": ("elementwise", "vectorized")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    kern, streams = {}, {}
    for stream, a, b, name in evs:
        ms = (b - a) / 1e3
        kind = [f for f, keys in kinds.items() if any(key in name for key in keys)]
        by_kind[kind[0] if kind else "other"] += ms
        t, c = kern.get(name, (0.0, 0))
        kern[name] = (t + ms, c + 1)
        st = streams.setdefault(stream, {"ms": 0.0, "events": 0, "by_kernel": {}})
        st["ms"] += ms
        st["events"] += 1
        st["by_kernel"][name[:60]] = st["by_kernel"].get(name[:60], 0.0) + ms

    def union_ms(spans):  # spans sorted by start
        total, end = 0.0, -math.inf
        for a, b in spans:
            total += max(0.0, b - max(a, end))
            end = max(end, b)
        return total / 1e3

    overlap, open_ev = {}, []  # open_ev: events still running at the current start
    for stream, a, b, _ in evs:
        open_ev = [(s2, b2) for s2, b2 in open_ev if b2 > a]
        for s2, b2 in open_ev:
            pair = f"{min(s2, stream)}-{max(s2, stream)}"
            overlap[pair] = overlap.get(pair, 0.0) + (min(b, b2) - a) / 1e3
        open_ev.append((stream, b))
    busy = union_ms([(a, b) for _, a, b, _ in evs])
    main_stream = max(streams, key=lambda k: streams[k]["events"])
    main_busy = union_ms([(a, b) for st, a, b, _ in evs if st == main_stream])
    side_busy = union_ms([(a, b) for st, a, b, _ in evs if st != main_stream])
    for st in streams.values():
        st["by_kernel"] = dict(sorted(st["by_kernel"].items(), key=lambda kv: -kv[1])[:3])
    kernel_sum = sum(ms for ms, _ in kern.values())
    step_profile = dict(wall_ms_under_profiler=prof_wall_ms,
                        device_events_listed=len(raw), device_events_distinct=len(evs),
                        device_kernel_ms_sum=kernel_sum, device_busy_ms=busy,
                        kernel_launches=len(evs), kernel_ms_by_kind=by_kind,
                        main_stream=main_stream, main_stream_busy_ms=main_busy,
                        side_streams_busy_ms=side_busy,
                        side_streams_beside_main_ms=main_busy + side_busy - busy,
                        by_stream={str(k): v for k, v in streams.items()},
                        overlap_ms_by_stream_pair=overlap,
                        idle_share_under_profiler=1 - busy / prof_wall_ms,
                        idle_share_of_step=1 - busy / parts["step_ms"],
                        kernels_by_time=[{"name": k[:90], "ms": ms, "count": c} for k, (ms, c) in
                                         sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]])
    if kernel_sum > busy * (1 + 1e-6) and not overlap:
        failures.append(f"profile: kernels sum to {kernel_sum} ms over {busy} ms busy "
                        "with no overlap between events")
    del gan, prof

    # one full-width GAN step at B=2, card against CPU, from the same draws
    side = {}
    small = {k: v[:2] for k, v in batch.items()}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        g2 = VocoderGAN(device=d, rng=torch.Generator().manual_seed(5))
        before = {k: {n: v.clone() for n, v in sd.items()} for k, sd in g2.weights().items()}
        m = g2.train_step({k: v.to(d) for k, v in small.items()})
        after = g2.weights()
        side[name] = dict(metrics={k: float(v) for k, v in m.items()},
                          move={k: {n: (after[k][n] - before[k][n]).cpu() for n in before[k]}
                                for k in before})
        del g2, before, after
    metric_rel = {k: abs(side["card"]["metrics"][k] - v) / max(abs(v), 1e-30)
                  for k, v in side["cpu"]["metrics"].items()}
    update_rel = {}
    for tree, moves in side["cpu"]["move"].items():
        num = sum(((side["card"]["move"][tree][n] - v) ** 2).sum().item() for n, v in moves.items())
        den = sum((v ** 2).sum().item() for v in moves.values())
        update_rel[tree] = math.sqrt(num / den)
    card_vs_cpu = dict(B=2, segment=small["wav"].shape[1], metrics_card=side["card"]["metrics"],
                       metrics_cpu=side["cpu"]["metrics"], metrics_rel_diff=metric_rel,
                       update_rel_l2=update_rel,
                       tol=f"metrics rel {TOL_GAN_METRIC}; each tree's update rel L2 "
                           f"{TOL_GAN_UPDATE}")
    if (max(metric_rel.values()) > TOL_GAN_METRIC
            or max(update_rel.values()) > TOL_GAN_UPDATE):
        failures.append(f"card vs CPU GAN step: {metric_rel} {update_rel}")
    del side

    emit({"train_vocoder": {
        "card": card, "corpus": f"{len(wav_paths)} seeded wavs of 1-4 s at 22.05 kHz",
        "corpus_s": corpus_s, "entry": "cli.train_vocoder.main at its defaults, in process",
        "config": "V1 generator (512 ch, rates 8 8 2 2, MRF 3 7 11 x 1 3 5), MPD + MSD, "
                  "segment 8192, B=16",
        "runs": runs, "wav_hat_vs_module_max_abs": wav_err, "tol_wav": TOL_WAV,
        "step_parts_ms": parts, "step_profile": step_profile,
        "card_vs_cpu_gan_step": card_vs_cpu, "launches": total,
        "phase_s": time.perf_counter() - t_phase}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("train_vocoder: " + "; ".join(failures))
    return total


class SyntheticPairs:
    """Seeded (x, y) utterances for `Trainer`: T_x ~ U[lo, hi] symbol ids
    (`n_in` None) or ternary trait vectors of `n_in`, T_y = T_x * U(r0, r1)
    frames of `rows` features."""

    def __init__(self, n, seed, rows, n_vocab=None, n_in=None, t_x=(100, 190), ratio=(2.5, 4.5)):
        import numpy as np

        r = np.random.default_rng(seed)
        tx = r.integers(t_x[0], t_x[1] + 1, n)
        ty = (tx * r.uniform(*ratio, n)).astype(int)
        self.items = [{"x": (r.integers(1, n_vocab, a).astype(np.int64) if n_in is None
                             else r.integers(-1, 2, (a, n_in)).astype(np.float32)),
                       "y": r.standard_normal((b, rows)).astype(np.float32)}
                      for a, b in zip(tx, ty)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        import numpy as np

        return np.array([len(it["y"]) for it in self.items])


def train_bf16_phase(card, dev, counters, plains, K6):
    """Phase 14 (`train_bf16`): v2 (2D) and v5_preblock at full width with
    `compute_dtype="bfloat16"`: one B=16 loss and gradient against float32
    on the same weights, batch and draws, within the JAX gate's bounds
    (`tests/test_train_bf16.py`), the estimator in bf16 and the loss or
    gradient moved by it; then an epoch of three steps through
    `Trainer` in bf16 and in float32 (finite losses, K6 once a step, no
    other kernel, step walls and peak memory). Returns the K6 launches of
    the bf16 epochs."""
    import dataclasses

    import numpy as np
    import torch

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.data.batching import DataLoader
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.train import trainer as trainer_mod
    from arttts_tpu_torch.train.losses import loss_for_model
    from arttts_tpu_torch.train.step import train_step
    from arttts_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_train_bf16"
    shutil.rmtree(root, ignore_errors=True)
    all_counters = counters + [K6.maximum_path]
    all_plains = plains + [K6.maximum_path_plain]
    failures, results = [], {}
    k6_bf16 = 0
    walls = []

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(*a, **k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return m

    trainer_mod.train_step = timed_step
    try:
        for preset in ("v2", "v5_preblock"):
            base = get_preset(preset)
            m32 = base.model
            m16 = dataclasses.replace(m32, decoder=dataclasses.replace(
                m32.decoder, compute_dtype="bfloat16"))
            if m32.encoder.kind == "text":
                ds = SyntheticPairs(48, 40, m32.n_feats, n_vocab=m32.encoder.n_vocab)
            else:
                ds = SyntheticPairs(48, 41, m32.n_feats, n_in=m32.encoder.n_input_feats,
                                    t_x=(20, 60), ratio=(4.0, 7.0))
            out_size = base.train.out_size
            loader = DataLoader(ds, batch_size=16, shuffle=False, min_frames=out_size)
            b = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in next(iter(loader)).items()}
            loss_fn = loss_for_model(m32.name)
            one = {}
            for dtype, mcfg in (("float32", m32), ("bfloat16", m16)):
                model = build_model(mcfg, device=dev, seed=0).train()
                g = torch.Generator(device=dev).manual_seed(0)
                total, _ = loss_fn(model, g, b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                                   out_size=out_size)
                total.backward()
                one[dtype] = (total.item(), torch.cat(
                    [p.grad.double().flatten() for p in model.parameters()]),
                    model.decoder.estimator.dtype)
                del model
            (l32, g32, d32), (l16, g16, d16) = one["float32"], one["bfloat16"]
            gate = dict(loss_f32=l32, loss_bf16=l16,
                        loss_rel=abs(l16 - l32) / max(abs(l32), 1.0),
                        grad_cos=float(g16 @ g32 / (g16.norm() * g32.norm())),
                        grad_norm_ratio=float(g16.norm() / g32.norm()),
                        estimator_dtypes=[str(d32), str(d16)],
                        grad_max_abs_diff=(g16 - g32).abs().max().item())
            del one, g32, g16
            if not (gate["loss_rel"] <= 0.02 and gate["grad_cos"] > 0.99
                    and 0.8 < gate["grad_norm_ratio"] < 1.25):
                failures.append(f"{preset}: bf16 step outside the JAX gate's bounds: {gate}")
            # bf16 took effect: the estimator computes in bf16 and the step moved
            if (d32, d16) != (torch.float32, torch.bfloat16) or (
                    l16 == l32 and gate["grad_max_abs_diff"] == 0):
                failures.append(f"{preset}: compute_dtype bfloat16 had no effect: {gate}")
            epochs = {}
            for dtype, mcfg in (("float32", m32), ("bfloat16", m16)):
                exp = dataclasses.replace(base, model=mcfg, train=dataclasses.replace(
                    base.train, batch_size=16, random_seed=0))
                for f in all_counters + all_plains:
                    setattr(f, "launches" if f in all_counters else "cuda_calls", 0)
                walls.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                trainer = Trainer(exp, ds, device=dev, log_dir=str(root / f"{preset}_{dtype}"))
                losses = trainer.train_epoch(1)
                launches = {f.__name__: f.launches for f in all_counters}
                plain = {f.__name__: f.cuda_calls for f in all_plains}
                n_steps = len(trainer.train_loader)
                ms = sorted(1e3 * w for w in walls[1:])
                epochs[dtype] = dict(
                    steps=n_steps, step_wall_ms=[1e3 * w for w in walls],
                    median_step_ms_after_first=ms[len(ms) // 2] if ms else None,
                    max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                    losses=losses, launches=launches, plain_calls_on_card=plain,
                    params_float32=all(p.dtype == torch.float32
                                       for p in trainer.model.parameters()),
                    adam_float32=all(t.dtype == torch.float32
                                     for s in trainer.optimizer.state.values()
                                     for k, t in s.items() if k != "step"))
                want = dict.fromkeys(launches, 0)
                want["maximum_path"] = n_steps
                if dtype == "bfloat16":
                    k6_bf16 += launches["maximum_path"]
                if (n_steps != 3 or launches != want or any(plain.values())
                        or not all(math.isfinite(v) for v in losses.values())
                        or not epochs[dtype]["params_float32"]
                        or not epochs[dtype]["adam_float32"]):
                    failures.append(f"{preset} {dtype}: {epochs[dtype]}, expected {want}")
                del trainer
                torch.cuda.empty_cache()
            e32, e16 = epochs["float32"], epochs["bfloat16"]
            results[preset] = dict(
                rows=m32.n_feats, decoder=m32.decoder.kind, batch_size=16, out_size=out_size,
                one_step_vs_float32=gate, epochs=epochs,
                bf16_over_f32_step_wall=(e16["median_step_ms_after_first"]
                                         / e32["median_step_ms_after_first"]),
                bf16_over_f32_peak_memory=(e16["max_memory_allocated_bytes"]
                                           / e32["max_memory_allocated_bytes"]))
    finally:
        trainer_mod.train_step = train_step
    emit({"train_bf16": {"card": card, "gate": "loss rel <= 0.02, grad cosine > 0.99, "
                         "norm ratio in (0.8, 1.25) (tests/test_train_bf16.py)",
                         "presets": results, "k6_launches_bf16": k6_bf16,
                         "phase_s": time.perf_counter() - t_phase}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("train_bf16: " + "; ".join(failures))
    return k6_bf16


DP_RANKS = 2  # phases 15-16: two ranks share cuda:0 over gloo
DP_BATCH = 16  # the global batch, 8 rows a rank
DP_TRAINER_BATCH = 8  # phase 15's Trainer: 4 rows a rank
TOL_DP_LOSS = 1e-5  # every loss part, relative, against the one-process step
SP_T = 768  # phase 16: the flagship bucket, 384 frames a rank
SP_REPS = 3


def _v2_model(device):
    """v2 from seed 0 on `device`, the encoder's dropout off (its masks
    differ between a rank's rows and the whole batch) and small distinct
    Rezero gains (they start at 0, which silences every attention site)."""
    import torch

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.models.tts import build_model

    cfg = get_preset("v2").model
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout=0.0, prenet_dropout=0.0))
    model = build_model(cfg, device=device, seed=0)
    est = model.decoder.estimator
    with torch.no_grad():
        for k, site in enumerate([lv[2] for lv in est.downs] + [est.mid_attn]
                                 + [u[2] for u in est.ups]):
            site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
    return model


def _rank_serve(rank, port, jobs, results):
    """One rank of phases 15-16 (a spawned process): joins the two-rank gloo
    group on cuda:0 through the port's `init_distributed`, then runs the
    named jobs of this module until it gets None; a job's exception goes
    back to the parent as its traceback."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from arttts_tpu_torch.parallel.distributed import init_distributed

    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                     world_size=DP_RANKS, rank=rank, device="cuda:0")
    try:
        for name, args in iter(jobs.get, None):
            try:
                results.put((rank, True, globals()[name](*args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_rank_job(batches, out_size, lr, save_to):
    """Phase 15 on one rank: two steps of `train_step(ddp=...)` on this
    rank's rows of each global batch (numpy, pinned draws), K6 counted;
    the gloo all-reduce of a gradient-sized buffer timed. Rank 0 saves the
    first step's (clipped, all-reduced) gradients and the final parameters
    to `save_to`."""
    import torch
    import torch.distributed as dist

    from arttts_tpu_torch.ops import mas as K6
    from arttts_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from arttts_tpu_torch.train.losses import grad_tts_loss
    from arttts_tpu_torch.train.step import data_parallel, make_optimizer, train_step

    mesh = make_mesh(device_type="cuda")
    dev = mesh.device
    model = _v2_model(dev)
    ddp = data_parallel(model, grad_tts_loss, mesh.groups["data"])
    opt = make_optimizer(model, lr)
    K6.maximum_path.launches = K6.maximum_path_plain.cuda_calls = 0
    metrics, walls, grads = [], [], None
    for i, b in enumerate(batches):
        local = shard_batch(mesh, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, local, None, out_size, ddp=ddp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = [p.grad.detach().cpu() for p in model.parameters()]
    launches, plain = K6.maximum_path.launches, K6.maximum_path_plain.cuda_calls
    n_params = sum(p.numel() for p in model.parameters())
    buf = torch.ones(n_params, device=dev)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) / 3 * 1e3
    if dist.get_rank() == 0:
        torch.save({"grads": grads, "params": [p.detach().cpu() for p in model.parameters()]},
                   save_to)
    return dict(rows=int(local["x"].shape[0]), metrics=metrics,
                step_wall_ms=[1e3 * w for w in walls], k6_launches=launches,
                plain_mas_on_card=plain, n_params=n_params,
                allreduce_bytes=n_params * 4, allreduce_ms=allreduce_ms,
                params_digest=_digest(model.parameters()))


def _dp_trainer_job(corpus, logs, n_model=1):
    """Phases 15 and 18 on one rank: `Trainer(mesh=...)` on the seeded v2
    corpus under `corpus` (a global batch of 8, a save every epoch) over a
    mesh of the ranks with a "model" axis of `n_model` (phase 15: 2 x 1,
    the preset's fixed buckets, 4 rows a rank; phase 18: 1 x 2, the state
    replicated over the model axis, 8 rows a rank), one epoch with K6
    counted, then a second `Trainer` resumed from the first's `grad_final`:
    its weights and Adam's state against the first's, by digest; and the
    checkpoints this rank wrote."""
    import types

    import torch

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.data.datasets import build_dataset
    from arttts_tpu_torch.ops import mas as K6
    from arttts_tpu_torch.parallel.mesh import make_mesh
    from arttts_tpu_torch.parallel.tp import tensor_parallel
    from arttts_tpu_torch.train import trainer as trainer_mod
    from arttts_tpu_torch.train.trainer import Trainer

    exp = get_preset("v2")
    cfg = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, batch_size=DP_TRAINER_BATCH, save_every=1, val_every=1, log_dir=str(logs)))
    mesh = make_mesh(n_model=n_model, device_type="cuda")
    args = types.SimpleNamespace(data_root=str(corpus), cmudict=None, mel_cache=None,
                                 artic_dir=None)
    train_ds, valid_ds = (build_dataset(cfg, args, str(corpus / f), device=mesh.device)
                          for f in ("train.txt", "valid.txt"))

    def state_digest(trainer):
        opt = trainer.optimizer.state_dict()["state"]
        return _digest([*trainer.model.state_dict().values(),
                        *(v for k in sorted(opt) for v in opt[k].values())])

    saves, real_save = [], trainer_mod.save_checkpoint

    def save(log_dir, name, *a, **k):
        saves.append(name)
        return real_save(log_dir, name, *a, **k)

    trainer = Trainer(cfg, train_ds, valid_dataset=valid_ds, device=mesh.device, mesh=mesh)
    K6.maximum_path.launches = K6.maximum_path_plain.cuda_calls = 0
    trainer_mod.save_checkpoint = save
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(n_epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        trainer_mod.save_checkpoint = real_save
    launches, plain = K6.maximum_path.launches, K6.maximum_path_plain.cuda_calls
    tp = tensor_parallel(trainer.model)
    resumed = Trainer(cfg, train_ds, valid_dataset=valid_ds, device=mesh.device, mesh=mesh)
    start = resumed.resume(str(logs / "grad_final"))
    rows = trainer.train_loader.batcher.rows
    return dict(rows=[rows.start, rows.stop], steps=len(trainer.train_loader.batcher),
                valid_batches=len(trainer.valid_loader.batcher), fit_s=fit_s,
                k6_launches=launches, plain_mas_on_card=plain, ddp=trainer.ddp is not None,
                digest=state_digest(trainer), resumed_digest=state_digest(resumed),
                resume_start_epoch=start, checkpoints=sorted(q.name for q in logs.iterdir()),
                saves=saves, mesh=[mesh.shape["data"], mesh.shape["model"]],
                row_allreduces=None if tp is None else [tp.comm.calls, tp.comm.bytes])


def _local_stats_block(block, x, m, length, comm, eps):
    """`models/unet2d_sp.py:_block` with the fault phase 16 must catch: the
    GroupNorm statistics of this rank's chunk alone, not all-reduced."""
    from arttts_tpu_torch.models import unet2d_sp

    class NoReduce:
        @staticmethod
        def sum(t):
            return t

    conv, norm = block.block
    h = unet2d_sp._conv3x3(x, conv, comm) * m
    count = m.sum(dim=(1, 2, 3)) * (h.shape[1] // norm.groups) * h.shape[2]
    return unet2d_sp.mish(unet2d_sp._group_norm(h, norm, count, NoReduce, eps)) * m


def _sp_rank_job(inputs, synth):
    """Phase 16 on one rank: the SP score function over a 1 x 2 mesh on this
    rank's chunk of `inputs` (numpy xt, mask, mu, t), timed per evaluation
    with its collectives counted; then `synthesize(mesh=...)`, 4 Euler
    steps, the whole decode on every rank."""
    import numpy as np
    import torch

    from arttts_tpu_torch.infer.sampler import synthesize
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn
    from arttts_tpu_torch.parallel.mesh import local_slice, make_mesh

    mesh = make_mesh(n_data=1, n_model=DP_RANKS, device_type="cuda")
    dev = mesh.device
    model = _v2_model(dev).eval()
    xt, mask, mu, t = (torch.from_numpy(a).to(dev) for a in inputs)
    cut = local_slice(mesh, "model", SP_T)
    fn = make_score_fn(model, SP_T, mesh=mesh)
    walls = []
    with torch.inference_mode():
        for _ in range(SP_REPS + 1):
            calls0, bytes0 = fn.comm.calls, fn.comm.bytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(xt[:, cut], mask[:, cut], mu[:, cut], t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    per_eval = (fn.comm.calls - calls0, fn.comm.bytes - bytes0)
    # one collective alone: a GroupNorm statistics pair's size, 20 times
    stats = torch.ones(2, 1, 8, device=dev)
    fn.comm.sum(stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn.comm.sum(stats)
    torch.cuda.synchronize()
    small_ms = (time.perf_counter() - t0) / 20 * 1e3
    # the same evaluation with each rank's own GroupNorm statistics
    from arttts_tpu_torch.models import unet2d_sp

    real_block, unet2d_sp._block = unet2d_sp._block, _local_stats_block
    try:
        with torch.inference_mode():
            local = fn(xt[:, cut], mask[:, cut], mu[:, cut], t)
    finally:
        unet2d_sp._block = real_block
    x, xl, dur = synth
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = synthesize(model, torch.Generator(device=dev).manual_seed(7), x, xl, n_timesteps=4,
                     max_frames=SP_T, temperature=1e6, x_durations=dur, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    return dict(chunk=out.cpu().numpy(), chunk_local_stats=local.cpu().numpy(),
                qualname=fn.__qualname__,
                collectives_per_eval=per_eval[0], collective_bytes_per_eval=per_eval[1],
                eval_wall_ms=[1e3 * w for w in walls[1:]], small_allreduce_ms=small_ms,
                synth_wall_s=time.perf_counter() - t0,
                dec=np.asarray(res[1].cpu()), y_lengths=np.asarray(res[3].cpu()))


class _Ranks:
    """The two rank processes of phases 15-16, spawned once (each takes
    seconds to import torch and reach the card)."""

    def __init__(self):
        import multiprocessing as mp
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(DP_RANKS)]
        self.results = ctx.Queue()
        # daemons: a failed phase exits, and the ranks with it
        self.procs = [ctx.Process(target=_rank_serve, args=(r, port, self.jobs[r], self.results),
                                  daemon=True) for r in range(DP_RANKS)]
        for p in self.procs:
            p.start()

    def run(self, name, *args, timeout=300):
        import queue

        for q in self.jobs:
            q.put((name, args))
        got = {}
        for _ in range(DP_RANKS):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                fail(f"{name}: a rank gave no result in {timeout} s "
                     f"(alive: {[p.is_alive() for p in self.procs]})")
            if not ok:
                fail(f"{name}: rank {rank} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(DP_RANKS)]

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        codes = [p.exitcode for p in self.procs]
        if codes != [0] * DP_RANKS:
            fail(f"rank processes exited with {codes}")


def write_text_mel_corpus(root, n_train=16, n_valid=8):
    """A seeded v2 corpus (`text_mel`) under `root`: 22.05 kHz wavs of
    1.2-2.5 s and `wav|text` training and validation filelists."""
    import numpy as np

    from arttts_tpu_torch.audio.io import save_wav

    r = np.random.default_rng(31)
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i in range(n_train + n_valid):
        t = np.arange(int(22050 * float(r.uniform(1.2, 2.5)))) / 22050.0
        wav = 0.2 * np.sin(2 * np.pi * (110 + 7 * i) * t) + 0.02 * r.standard_normal(t.size)
        save_wav(root / "wavs" / f"dp{i:03d}.wav", wav.astype(np.float32), 22050)
        lines.append(f"DUMMY/wavs/dp{i:03d}.wav|{CLI_TEXTS[i % len(CLI_TEXTS)]}")
    (root / "train.txt").write_text("\n".join(lines[:n_train]))
    (root / "valid.txt").write_text("\n".join(lines[n_train:]))


def dp_batches():
    """Phases 15 and 18's two global batches of DP_BATCH (numpy): seeded v2
    utterances at the preset's fixed buckets with pinned draws."""
    import numpy as np

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.data.batching import DataLoader

    exp = get_preset("v2")
    out_size, F_ = exp.train.out_size, exp.model.n_feats
    ds = SyntheticPairs(2 * DP_BATCH, 50, F_, n_vocab=exp.model.encoder.n_vocab)
    loader = DataLoader(ds, DP_BATCH, seed=0, min_frames=out_size,
                        text_bucket=exp.data.max_text_len, frame_bucket=exp.data.max_frame_len)
    r = np.random.default_rng(51)
    batches = []
    for b in loader:
        y_len = b["y_lengths"]
        batches.append(dict(b, pinned_t=r.uniform(0.05, 0.95, DP_BATCH).astype(np.float32),
                            pinned_z=r.standard_normal((DP_BATCH, out_size, F_)).astype(
                                np.float32),
                            pinned_offsets=(r.random(DP_BATCH) * np.maximum(y_len - out_size, 1)
                                            ).astype(np.int32)))
    return batches


def train_dp_phase(card, dev, K6):
    """Phase 15 (`train_dp`): v2 at full width, data-parallel over two gloo
    ranks sharing cuda:0 with CUDA tensors: two steps of the global batch of
    16 (8 rows a rank, the preset's fixed buckets, pinned draws, dropout
    0) against the one-process step on the same batches on the card
    (losses within TOL_DP_LOSS relative; the first step's gradients within
    phase 9b's rule; the parameters within the CPU tests' band; the ranks'
    bit for bit equal), K6 once a step on each rank and no plain MAS on the
    card; the gloo all-reduce of the gradient's bytes timed. Then the same
    ranks run `Trainer(mesh=...)` for an epoch on a seeded wav corpus (its
    rows, DDP, K6 once a step and a validation batch on each rank, rank 0's
    checkpoints behind barriers) and resume it, both ranks to the saved
    state. Last, `cli.train --mesh` under `torch.distributed.run
    --standalone --nproc_per_node=1` (NCCL, world size 1) resumes that
    checkpoint, trains epoch 2 and writes its own. Two ranks on one card
    measure the collectives' cost and correctness, not scaling. Returns (the
    K6 launches of the steps and of the Trainer, each summed over the ranks,
    the rank processes for phases 16 and 18, and the one-process steps'
    batches, metrics, parameters and walls for phase 18)."""
    import torch

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.train.step import make_optimizer, train_step

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    exp = get_preset("v2")
    out_size, lr = exp.train.out_size, exp.train.learning_rate
    batches = dp_batches()
    # the one-process step on the whole batches (before the ranks share the card)
    model = _v2_model(dev)
    opt = make_optimizer(model, lr)
    ref_metrics, ref_walls, ref_grads = [], [], None
    for i, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, tb, None, out_size)
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        ref_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            ref_grads = [p.grad.detach().cpu() for p in model.parameters()]
    ref_params = [p.detach().cpu() for p in model.parameters()]
    del model, opt
    torch.cuda.empty_cache()

    t_spawn = time.perf_counter()
    ranks = _Ranks()
    saved = root / "rank0.pt"
    r0, r1 = ranks.run("_dp_rank_job", batches, out_size, lr, str(saved))
    dp = torch.load(saved, weights_only=True)
    loss_rel = max(abs(a[k] - b[k]) / abs(b[k]) for got in (r0, r1)
                   for a, b in zip(got["metrics"], ref_metrics)
                   for k in ("total_loss", "dur_loss", "prior_loss", "diff_loss"))
    grad_worst = max(float((g - gr).abs().max()) / (1e-3 * float(gr.abs().max()) + 1e-7)
                     for g, gr in zip(dp["grads"], ref_grads))
    # both start from the same weights: the parameters' distance is the changes'
    change = torch.cat([(p - q).abs().reshape(-1) for p, q in zip(dp["params"], ref_params)])
    n_over, param_worst = int((change > 2e-6).sum()), float(change.max())
    result = dict(
        card=card, preset="v2", ranks=DP_RANKS, backend="gloo, CUDA tensors, one card",
        global_batch=DP_BATCH, rows_a_rank=r0["rows"], buckets=[exp.data.max_text_len,
                                                               exp.data.max_frame_len],
        steps=len(batches), metrics_ranks=r0["metrics"], metrics_one_process=ref_metrics,
        loss_rel_worst=loss_rel, grad_tolerance_share_worst=grad_worst,
        params_over_2e6=n_over, params=change.numel(), params_worst=param_worst,
        ranks_bit_equal=r0["params_digest"] == r1["params_digest"],
        k6_launches=[r0["k6_launches"], r1["k6_launches"]],
        plain_mas_on_card=[r0["plain_mas_on_card"], r1["plain_mas_on_card"]],
        step_wall_ms={"rank0": r0["step_wall_ms"], "rank1": r1["step_wall_ms"],
                      "one_process_B16": [1e3 * w for w in ref_walls]},
        allreduce=dict(parameters=r0["n_params"], bytes_a_step=r0["allreduce_bytes"],
                       ms=[r0["allreduce_ms"], r1["allreduce_ms"]],
                       share_of_rank_step_after_first=(r0["allreduce_ms"]
                                                       / r0["step_wall_ms"][1])),
        ranks_spawn_to_result_s=time.perf_counter() - t_spawn,
        tol=(f"losses rel {TOL_DP_LOSS} against the one-process step; first-step gradients "
             "1e-3 * max|g| + 1e-7 per tensor (phase 9b); parameter changes over 2e-6 at most "
             "1e-4 of the elements and none over 4e-4 (two Adam steps at lr 1e-4)"),
        note="two ranks on one card: the collectives' cost and correctness, not scaling")
    failures = []
    if loss_rel > TOL_DP_LOSS or grad_worst > 1.0:
        failures.append(f"losses {loss_rel} or gradients {grad_worst} off the one-process step")
    if n_over > 1e-4 * change.numel() or param_worst > 4 * lr or not result["ranks_bit_equal"]:
        failures.append(f"parameters: {n_over} over 2e-6, worst {param_worst}, ranks equal "
                        f"{result['ranks_bit_equal']}")
    if result["k6_launches"] != [len(batches)] * DP_RANKS or any(result["plain_mas_on_card"]):
        failures.append(f"K6 {result['k6_launches']}, plain MAS {result['plain_mas_on_card']}")

    # Trainer(mesh=...) on the ranks: an epoch of a seeded corpus, a checkpoint, a resume
    corpus, logs = root / "corpus", root / "logs"
    write_text_mel_corpus(corpus)
    t0 = time.perf_counter()
    tr = ranks.run("_dp_trainer_job", corpus, logs)
    result["trainer"] = dict(
        global_batch=DP_TRAINER_BATCH, rows=[q["rows"] for q in tr],
        steps=tr[0]["steps"], valid_batches=tr[0]["valid_batches"],
        fit_s=[q["fit_s"] for q in tr], k6_launches=[q["k6_launches"] for q in tr],
        plain_mas_on_card=[q["plain_mas_on_card"] for q in tr],
        checkpoints=tr[0]["checkpoints"], resume_start_epoch=[q["resume_start_epoch"] for q in tr],
        ranks_bit_equal=tr[0]["digest"] == tr[1]["digest"],
        resumed_equal=[q["resumed_digest"] == q["digest"] for q in tr],
        wall_s=time.perf_counter() - t0)
    k6_per_rank = tr[0]["steps"] + tr[0]["valid_batches"]  # a train step, a validation batch
    if not (all(q["ddp"] for q in tr) and tr[0]["rows"] == [0, DP_TRAINER_BATCH // 2]
            and tr[1]["rows"] == [DP_TRAINER_BATCH // 2, DP_TRAINER_BATCH]
            and result["trainer"]["k6_launches"] == [k6_per_rank] * DP_RANKS
            and not any(result["trainer"]["plain_mas_on_card"])
            and {"grad_1", "grad_best", "grad_final"} <= set(tr[0]["checkpoints"])
            and result["trainer"]["ranks_bit_equal"] and all(result["trainer"]["resumed_equal"])
            and result["trainer"]["resume_start_epoch"] == [2, 2]):
        failures.append(f"Trainer over two ranks: {result['trainer']}")

    # cli.train --mesh under torchrun (NCCL, world size 1): resumes the ranks'
    # checkpoint, trains epoch 2 and writes its own
    nccl_logs = root / "logs_nccl"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           "-m", "arttts_tpu_torch.cli.train", "--mesh", "--preset", "v2", "--data-root",
           str(corpus), "--train-filelist", str(corpus / "train.txt"), "--valid-filelist",
           str(corpus / "valid.txt"), "--log-dir", str(nccl_logs), "--batch-size", "8",
           "--epochs", "2", "--resume", str(logs / "grad_final")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    out = p.stdout + p.stderr
    (ROOT / "build" / "chip_smoke_torchrun.log").write_text(out)  # the launcher's whole output
    # the preset saves `grad_{epoch}` every 200 epochs: the run's checkpoint is grad_final
    files = sorted(q.name for q in nccl_logs.iterdir()) if nccl_logs.exists() else []
    meta = (json.loads((nccl_logs / "grad_final" / "meta.json").read_text())
            if "grad_final" in files else {})
    train_log = (nccl_logs / "train.log").read_text().splitlines() if nccl_logs.exists() else []
    result["torchrun"] = dict(
        rc=p.returncode, wall_s=time.perf_counter() - t0, nccl="over nccl" in out,
        resumed="Resumed from" in out and "at epoch 2" in out, checkpoints=files,
        saved_epoch=meta.get("extra", {}).get("epoch"),
        epoch_s=[float(line.rsplit(" ", 1)[1].rstrip("s")) for line in out.splitlines()
                 if "epoch " in line and ": loss=" in line])
    if p.returncode != 0:
        failures.append(f"torchrun: exit {p.returncode}:\n{out[-3000:]}")
    elif not (result["torchrun"]["nccl"] and result["torchrun"]["resumed"]
              and result["torchrun"]["saved_epoch"] == 2 and len(train_log) == 1):
        failures.append(f"torchrun: {result['torchrun']}")
    result["phase_s"] = time.perf_counter() - t_phase
    emit({"train_dp": result})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        ranks.close()
        fail("train_dp: " + "; ".join(failures))
    ref = dict(batches=batches, metrics=ref_metrics, params=ref_params,
               walls_ms=[1e3 * w for w in ref_walls])
    return (r0["k6_launches"] + r1["k6_launches"], sum(result["trainer"]["k6_launches"]),
            ranks, ref)


def sample_sp_phase(card, dev, ranks):
    """Phase 16 (`sample_sp`): v2's flagship geometry (80 x 768, dim 64,
    mults 1/2/4) sequence-parallel over phase 15's two gloo ranks on cuda:0:
    the SP score function against the unsharded module path on the card,
    within the CPU test's band (`tests/test_torch_sp.py`: 6e-2, and 2e-2 of
    max |ref| at the 99th percentile), on inputs whose two chunks differ in
    scale, and out of the band when each rank takes its own chunk's
    GroupNorm statistics (`_local_stats_block`); and a 4-step Euler
    `synthesize(mesh=...)` against the unsharded run (the kernels), within
    2% in relative L2; the collectives and the wall of an evaluation beside
    the module path's. Two ranks on one card measure the collectives' cost,
    not scaling."""
    import numpy as np
    import torch

    from arttts_tpu_torch.infer.sampler import synthesize

    t_phase = time.perf_counter()
    r = np.random.default_rng(61)
    F_ = 80
    # the second chunk's xt and mu 3x the first's: the chunks' GroupNorm
    # statistics differ, so a rank using its own would leave the band
    scale = np.where(np.arange(SP_T) < SP_T // DP_RANKS, 1.0, 3.0).astype(np.float32)
    inputs = (r.standard_normal((1, SP_T, F_)).astype(np.float32) * scale[:, None],
              np.ones((1, SP_T, 1), np.float32),
              r.standard_normal((1, SP_T, F_)).astype(np.float32) * scale[:, None],
              np.array([0.5], np.float32))
    x = r.integers(1, 100, (1, 96))
    synth = (x, np.array([96], np.int32), np.full((1, 96), SP_T / 96, np.float32))
    r0, r1 = ranks.run("_sp_rank_job", inputs, synth)
    model = _v2_model(dev).eval()
    xt, mask, mu, t = (torch.from_numpy(a).to(dev) for a in inputs)
    walls = []
    with torch.inference_mode():
        for _ in range(SP_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = model.estimate_noise(xt, mask, mu, t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    ref = ref.cpu().numpy()
    q99_limit = 2e-2 * max(1.0, float(np.abs(ref).max()))

    def in_band(chunks):
        err = np.abs(np.concatenate(chunks, axis=1) - ref)
        q99 = float(np.quantile(err, 0.99))
        return err, q99, bool((err <= 6e-2 + 6e-2 * np.abs(ref)).all()) and q99 < q99_limit

    err, q99, band_ok = in_band([r0["chunk"], r1["chunk"]])
    err_local, q99_local, local_ok = in_band([r0["chunk_local_stats"], r1["chunk_local_stats"]])
    _, dec, _, y_len = synthesize(model, torch.Generator(device=dev).manual_seed(7), synth[0],
                                  synth[1], n_timesteps=4, max_frames=SP_T, temperature=1e6,
                                  x_durations=synth[2], device=dev)
    dec = dec.cpu().numpy()
    rel = float(np.linalg.norm(r0["dec"] - dec) / np.linalg.norm(dec))
    module_ms = [1e3 * w for w in walls[1:]]
    result = dict(
        card=card, preset="v2", geometry=f"{F_} x {SP_T}, dim 64, mults 1/2/4",
        ranks=DP_RANKS, chunk_frames=SP_T // DP_RANKS, path=r0["qualname"],
        inputs="B=1, i.i.d. normal xt and mu, the second chunk's scaled by 3, no padding",
        score_max_abs_err=float(err.max()), score_q99_err=q99, score_band_ok=band_ok,
        local_stats=dict(max_abs_err=float(err_local.max()), q99_err=q99_local,
                         band_ok=local_ok),
        collectives_per_eval=r0["collectives_per_eval"],
        collective_bytes_per_eval=r0["collective_bytes_per_eval"],
        sp_eval_wall_ms={"rank0": r0["eval_wall_ms"], "rank1": r1["eval_wall_ms"]},
        # the collectives' share of an evaluation, each taken as one alone
        small_allreduce_ms=[r0["small_allreduce_ms"], r1["small_allreduce_ms"]],
        collectives_share_estimate=(r0["collectives_per_eval"] * r0["small_allreduce_ms"]
                                    / sorted(r0["eval_wall_ms"])[SP_REPS // 2]),
        module_eval_wall_ms=module_ms,
        synthesize=dict(steps=4, frames=[int(v) for v in r0["y_lengths"]], rel_l2=rel,
                        max_abs_err=float(np.abs(r0["dec"] - dec).max()),
                        ranks_equal=bool(np.array_equal(r0["dec"], r1["dec"])),
                        sp_wall_s=[r0["synth_wall_s"], r1["synth_wall_s"]]),
        tol="score: |sp - module| <= 6e-2 + 6e-2 |module|, q99 < 2e-2 max(1, max|module|), "
            "and the local-statistics run outside it; synthesize: relative L2 < 2e-2",
        note="two ranks on one card: the collectives' cost and correctness, not scaling",
        phase_s=time.perf_counter() - t_phase)
    emit({"sample_sp": result})
    if not (band_ok and not local_ok and rel < 2e-2
            and result["synthesize"]["ranks_equal"] and np.isfinite(r0["dec"]).all()
            and r0["qualname"] == "make_sp_score_fn.<locals>.score"
            and result["synthesize"]["frames"] == [SP_T] and int(y_len[0]) == SP_T):
        fail(f"sample_sp: {result}")


# ---- phase 18 (`train_tp`) ----------------------------------------------------

TP_GATHER_REPS = 3
# every parameter after the two TP steps against the same rank's one-process
# steps, both with cuDNN's deterministic algorithms: then two runs of either
# step are the same bits, and they differ only by the order in which the
# clip sums the gradients' squares (1.19e-7 in `scripts/tp_step_variance.py`)
TOL_TP_DET = 2e-6


def _tp_rank_job(batches, out_size, lr, save_to, deterministic=False):
    """Phase 18 on one rank: first the one-process step (v2 unsharded, two
    `train_step`s on the whole global batches, pinned draws) as this
    process's reference; then v2 sharded by `shard_tp` over a 1 x 2 mesh,
    the same two steps, K6 counted and the model row's all-reduces counted
    a step; the stored bytes of the parameters and Adam's moments beside
    the unsharded model's; one gather alone timed. Rank 0 saves the names,
    the gathered parameters and the reference's (in the unsharded model's
    order) to `save_to`. `deterministic`: both runs with cuDNN's
    deterministic algorithms (`torch.backends.cudnn.deterministic`)."""
    import torch

    torch.backends.cudnn.deterministic = deterministic
    try:
        return _tp_rank_steps(batches, out_size, lr, save_to)
    finally:
        torch.backends.cudnn.deterministic = False


def _tp_rank_steps(batches, out_size, lr, save_to):
    import torch
    import torch.distributed as dist

    from arttts_tpu_torch.ops import mas as K6
    from arttts_tpu_torch.parallel.mesh import make_mesh
    from arttts_tpu_torch.parallel.tp import gathered, shard_tp, tensor_parallel, tp_state_dict
    from arttts_tpu_torch.train.step import make_optimizer, train_step

    mesh = make_mesh(n_data=1, n_model=DP_RANKS, device_type="cuda")
    dev = mesh.device
    torch.cuda.empty_cache()  # phases 15-16's blocks
    free_bytes = torch.cuda.mem_get_info(dev)[0]
    tbs = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    model = _v2_model(dev)
    opt = make_optimizer(model, lr)
    ref_metrics, ref_walls = [], []
    for tb in tbs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, tb, None, out_size)
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        ref_metrics.append({k: float(v) for k, v in m.items()})
    ref_params = [p.detach().cpu() for p in model.parameters()]
    del model, opt
    torch.cuda.empty_cache()
    model = _v2_model(dev)
    names = [n for n, _ in model.named_parameters()]
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    shard_tp(mesh, model)
    tp = tensor_parallel(model)
    opt = make_optimizer(model, lr)
    torch.cuda.reset_peak_memory_stats(dev)
    K6.maximum_path.launches = K6.maximum_path_plain.cuda_calls = 0
    metrics, walls, comm = [], [], []
    for tb in tbs:
        calls, nbytes = tp.comm.calls, tp.comm.bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, tb, None, out_size)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        comm.append([tp.comm.calls - calls, tp.comm.bytes - nbytes])
        metrics.append({k: float(v) for k, v in m.items()})
    launches, plain = K6.maximum_path.launches, K6.maximum_path_plain.cuda_calls
    peak = torch.cuda.max_memory_allocated(dev)
    stored = sum(p.numel() * p.element_size() for p in model.parameters())
    adam = sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0)
    gather_ms = []
    with torch.no_grad():
        for _ in range(TP_GATHER_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with gathered(model):
                torch.cuda.synchronize()
            gather_ms.append(1e3 * (time.perf_counter() - t0))
    full = tp_state_dict(model)
    params = [full[n].detach().cpu() for n in names]
    if dist.get_rank() == 0:
        torch.save({"names": names, "params": params, "one_process": ref_params}, save_to)
    return dict(metrics=metrics, step_wall_ms=[1e3 * w for w in walls],
                one_process_metrics=ref_metrics,
                one_process_step_wall_ms=[1e3 * w for w in ref_walls],
                free_bytes_at_start=free_bytes,
                allreduces_a_step=comm, k6_launches=launches, plain_mas_on_card=plain,
                sharded_tensors=len(tp.entries), tensors=len(names),
                sharded_elements=sum(int(torch.Size(e.full_shape).numel()) for e in tp.entries),
                elements=sum(int(p.numel()) for p in params),
                full_param_bytes=full_bytes, stored_param_bytes=stored, adam_bytes=adam,
                peak_allocated_bytes=peak, gather_alone_ms=gather_ms,
                params_digest=_digest(params))


def train_tp_phase(card, ranks, ref):
    """Phase 18 (`train_tp`): v2 at full width sharded by
    `parallel/tp.py:shard_tp` over phase 15's two gloo ranks on cuda:0 (a
    1 x 2 mesh: each rank stores half of every sharded tensor and of its
    Adam moments, and gathers them once a step): two steps of phase 15's
    global batches of 16 (pinned draws, dropout 0) against the one-process
    steps on the same batches that each rank runs just before, both with
    cuDNN's deterministic algorithms (with its default ones the backward's
    bits change from run to run, and two runs land a few parameters over
    2e-6 apart): the losses within TOL_DP_LOSS of those and of phase 15's;
    the parameters within TOL_TP_DET of the same rank's and within the CPU
    tests' band of phase 15's (cuDNN's default algorithms), the tensors
    that hold the most reported; the ranks' gathered parameters bit for bit
    equal; K6 once a step on each rank and no plain MAS on the
    card, two all-reduces of the model row a step (the gather, and the
    gradients' squares with the replicated gradients); each rank's stored
    parameter and Adam bytes against the one-process figure; the step
    walls and one gather alone. Then `Trainer` on the same ranks as a 1 x 2
    mesh (the state replicated over the model axis, as the JAX trainer
    does; 8 rows a rank; the row takes rank 0's gradients, one all-reduce a
    step) for an epoch and a resume: rank 0 alone writes the checkpoints,
    and the ranks end bit for bit equal. Stops the rank processes. Returns
    the K6 launches of the steps and of the Trainer, each summed over the
    ranks."""
    import torch

    from arttts_tpu_torch.core.config import get_preset

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    exp = get_preset("v2")
    out_size, lr = exp.train.out_size, exp.train.learning_rate
    batches = ref["batches"]
    saved = root / "rank0.pt"
    torch.cuda.empty_cache()  # the blocks this process holds from phases 1-16
    free_bytes = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    r0, r1 = ranks.run("_tp_rank_job", batches, out_size, lr, str(saved), True)
    steps_s = time.perf_counter() - t0
    rank0 = torch.load(saved, weights_only=True)
    names, tp_params = rank0["names"], rank0["params"]

    def against(metrics_refs, params_ref):
        """The TP steps against a one-process run's metrics (one list a
        rank) and parameters: the losses' and the norm's worst relative
        distance, the elements over 2e-6 and the tensors holding most."""
        keys = ("total_loss", "dur_loss", "prior_loss", "diff_loss")
        pairs = [(a, b) for got, mref in zip((r0, r1), metrics_refs)
                 for a, b in zip(got["metrics"], mref)]
        errs = [(p - q).abs() for p, q in zip(tp_params, params_ref)]
        over = [int((e > 2e-6).sum()) for e in errs]
        return dict(loss_rel_worst=max(abs(a[k] - b[k]) / abs(b[k]) for a, b in pairs for k in keys),
                    grad_norm_rel_worst=max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                            for a, b in pairs),
                    params_over_2e6=sum(over), params=sum(e.numel() for e in errs),
                    params_worst=max(float(e.max()) for e in errs),
                    most_over=[[n, c] for c, n in sorted(zip(over, names), reverse=True)[:3] if c])

    # each rank's own one-process steps, run just before in the same process
    # and mode; phase 15's, run in this process with cuDNN's default algorithms
    own = against([r0["one_process_metrics"], r1["one_process_metrics"]], rank0["one_process"])
    cross = against([ref["metrics"]] * DP_RANKS, ref["params"])
    one_process = 3 * r0["full_param_bytes"]  # parameters, Adam's exp_avg and exp_avg_sq
    result = dict(
        card=card, preset="v2", mesh="1 x 2 (data x model)", ranks=DP_RANKS,
        backend="gloo, CUDA tensors, one card", global_batch=DP_BATCH, rows_a_rank=DP_BATCH,
        steps=len(batches), metrics_ranks=r0["metrics"],
        metrics_one_process=r0["one_process_metrics"],
        against_one_process_same_rank=own, against_phase15_one_process=cross,
        ranks_bit_equal=r0["params_digest"] == r1["params_digest"],
        k6_launches=[r0["k6_launches"], r1["k6_launches"]],
        plain_mas_on_card=[r0["plain_mas_on_card"], r1["plain_mas_on_card"]],
        sharded=dict(tensors=r0["sharded_tensors"], of_tensors=r0["tensors"],
                     elements=r0["sharded_elements"], of_elements=r0["elements"]),
        stored_bytes=dict(
            one_process=one_process,
            ranks=[q["stored_param_bytes"] + q["adam_bytes"] for q in (r0, r1)],
            params=[q["stored_param_bytes"] for q in (r0, r1)],
            adam=[q["adam_bytes"] for q in (r0, r1)],
            share=[(q["stored_param_bytes"] + q["adam_bytes"]) / one_process for q in (r0, r1)]),
        peak_allocated_bytes=[r0["peak_allocated_bytes"], r1["peak_allocated_bytes"]],
        allreduces_a_step=[r0["allreduces_a_step"], r1["allreduces_a_step"]],
        step_wall_ms={"rank0": r0["step_wall_ms"], "rank1": r1["step_wall_ms"],
                      "one_process_in_rank": [r0["one_process_step_wall_ms"],
                                              r1["one_process_step_wall_ms"]],
                      "one_process_alone_B16": ref["walls_ms"]},
        gather_alone_ms=[r0["gather_alone_ms"], r1["gather_alone_ms"]],
        free_bytes_at_start={"parent": free_bytes, "ranks": [r0["free_bytes_at_start"],
                                                              r1["free_bytes_at_start"]]},
        steps_s=steps_s,
        cudnn="deterministic algorithms (the TP steps and the same rank's one-process steps)",
        tol=(f"losses rel {TOL_DP_LOSS} against both one-process runs; parameters within "
             f"{TOL_TP_DET} of the same rank's one-process run; against phase 15's, parameter "
             "changes over 2e-6 at most 1e-4 of the elements and none over 4e-4 (two Adam steps "
             "at lr 1e-4); the ranks' gathered parameters bit for bit equal"),
        note=("two ranks on one card, each on the whole batch: the sharded layout's memory, "
              "its collectives' cost and correctness, not scaling"))
    failures = []
    if max(own["loss_rel_worst"], cross["loss_rel_worst"]) > TOL_DP_LOSS:
        failures.append(f"losses off the one-process steps: {own}, {cross}")
    if (own["params_worst"] > TOL_TP_DET or cross["params_over_2e6"] > 1e-4 * cross["params"]
            or cross["params_worst"] > 4 * lr or not result["ranks_bit_equal"]):
        failures.append(f"parameters: {own}, {cross}, ranks equal {result['ranks_bit_equal']}")
    if result["k6_launches"] != [len(batches)] * DP_RANKS or any(result["plain_mas_on_card"]):
        failures.append(f"K6 {result['k6_launches']}, plain MAS {result['plain_mas_on_card']}")
    if any(c != 2 for q in (r0, r1) for c, _ in q["allreduces_a_step"]):
        failures.append(f"all-reduces a step {result['allreduces_a_step']}, not 2")
    if not all(0.45 < v < 0.55 for v in result["stored_bytes"]["share"]):
        failures.append(f"stored bytes {result['stored_bytes']}")

    # Trainer on the ranks as a 1 x 2 mesh: the state replicated over the model axis
    corpus, logs = root / "corpus", root / "logs"
    write_text_mel_corpus(corpus)
    t0 = time.perf_counter()
    tr = ranks.run("_dp_trainer_job", corpus, logs, DP_RANKS)
    ranks.close()
    result["trainer"] = dict(
        mesh=tr[0]["mesh"], global_batch=DP_TRAINER_BATCH, rows=[q["rows"] for q in tr],
        steps=tr[0]["steps"], valid_batches=tr[0]["valid_batches"],
        fit_s=[q["fit_s"] for q in tr], k6_launches=[q["k6_launches"] for q in tr],
        plain_mas_on_card=[q["plain_mas_on_card"] for q in tr],
        checkpoints=tr[0]["checkpoints"], saves=[q["saves"] for q in tr],
        resume_start_epoch=[q["resume_start_epoch"] for q in tr],
        ranks_bit_equal=tr[0]["digest"] == tr[1]["digest"],
        resumed_equal=[q["resumed_digest"] == q["digest"] for q in tr],
        row_allreduces=[q["row_allreduces"] for q in tr],
        wall_s=time.perf_counter() - t0)
    k6_per_rank = tr[0]["steps"] + tr[0]["valid_batches"]
    if not (not any(q["ddp"] for q in tr) and tr[0]["mesh"] == [1, DP_RANKS]
            and all(q["row_allreduces"][0] == tr[0]["steps"] for q in tr)
            and all(q["rows"] == [0, DP_TRAINER_BATCH] for q in tr)
            and result["trainer"]["k6_launches"] == [k6_per_rank] * DP_RANKS
            and not any(result["trainer"]["plain_mas_on_card"])
            and {"grad_1", "grad_best", "grad_final"} <= set(tr[0]["checkpoints"])
            and tr[0]["saves"] == ["grad_1", "grad_best", "grad_final"] and tr[1]["saves"] == []
            and result["trainer"]["ranks_bit_equal"] and all(result["trainer"]["resumed_equal"])
            and result["trainer"]["resume_start_epoch"] == [2, 2]):
        failures.append(f"Trainer on a 1 x 2 mesh: {result['trainer']}")
    result["phase_s"] = time.perf_counter() - t_phase
    emit({"train_tp": result})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("train_tp: " + "; ".join(failures))
    return r0["k6_launches"] + r1["k6_launches"], sum(result["trainer"]["k6_launches"])


# ---- phase 17 (`ema_corpus`) -------------------------------------------------
EMA_CORPORA = ("mngu0", "mocha", "mspka", "pb2007")
EMA_SENTENCES = 3  # a corpus
# each corpus's own phone symbols (MOCHA's labels are IPA already) and silence
EMA_PHONES = {
    "mngu0": ["p", "aI", "t", "@U", "D", "E", "n", "tS", "I@", "lw", "s", "i", "k", "m"],
    "mocha": ["ð", "ə", "k", "æ", "t", "ɝ", "ɚ", "s", "ɪ", "n", "aɪ", "ʃ", "m", "u"],
    "mspka": ["tS", "a", "nf", "E1", "r", "dZ", "o", "ss", "LL", "ttS", "i", "gg", "m", "e"],
    "pb2007": ["a", "s^", "e~", "b", "o^", "z^", "x", "r", "q", "a~", "j", "w", "m", "i"],
}
EMA_SILENCE = {"mngu0": "#", "mocha": "sil", "mspka": "sil", "pb2007": "__"}
EMA_NAN_SENTENCE = ("pb2007", 1)  # 10% of its frames NaN: invalid at the 5% threshold
TOL_EMA_CONTROL_PCC = 0.95


def write_ema_corpora(root):
    """A few seeded sentences of 1.5-4 s of each EMA corpus under
    `root/{corpus}`, in the corpus's own format: labels (`labels/`: MNGU0
    `.lab`, MOCHA `.phnm`, MSPKA octal-escaped `.lab`, PB2007 `.phone` in
    100 Hz frames) and EMA (`ema/`: MOCHA EST `.ema` at 500 Hz, MSPKA ASCII
    21 x T at 400 Hz, PB2007 float32 `.bin` at 100 Hz; MNGU0 none). Each
    sentence's 12 SPARC-ordered channels are smooth sines (0.5-3 Hz), laid
    into the raw columns the reader selects. Returns {corpus: {stem: (T50,
    12) the same channels sampled at 50 Hz}}."""
    import numpy as np

    from arttts_tpu_torch.corpora import get_corpus, tables
    from arttts_tpu_torch.corpora.configs import CORPUS_LAYOUTS

    r = np.random.default_rng(17)
    out = {}
    for corpus in EMA_CORPORA:
        d = root / corpus
        (d / "labels").mkdir(parents=True)
        (d / "ema").mkdir()
        rate = CORPUS_LAYOUTS[corpus].ema_sr
        out[corpus] = {}
        for i in range(EMA_SENTENCES):
            stem = f"{corpus}_{i:03d}"
            dur = float(r.uniform(1.5, 4.0))
            k = max(6, int(dur / 0.12))
            b = np.concatenate([[0.0], np.sort(r.uniform(0.05, dur - 0.05, k - 1)), [dur]])
            phones = [EMA_SILENCE[corpus], *r.choice(EMA_PHONES[corpus], k - 2),
                      EMA_SILENCE[corpus]]
            label = d / "labels" / f"{stem}{get_corpus(corpus).label_ext}"
            if corpus == "mngu0":
                label.write_text("separator ;\nnfields 1\n#\n" + "".join(
                    f"{e:.3f} 26 {p}\n" for p, e in zip(phones, b[1:])))
            elif corpus == "mocha":
                label.write_text("".join(f"{s:.4f} {e:.4f} {p}\n"
                                         for p, s, e in zip(phones, b[:-1], b[1:])))
            elif corpus == "mspka":  # octal-escaped UTF-8 words on some lines
                words = ["perch\\303\\251", "citt\\303\\240", "casa"]
                label.write_bytes("".join(
                    f"{s:.5f} {e:.5f} {p}" + (f" {words[j % 3]}" if j % 3 == 1 else "") + "\n"
                    for j, (p, s, e) in enumerate(zip(phones, b[:-1], b[1:]))).encode("latin1"))
            else:
                f = np.rint(b * 100).astype(int)
                label.write_text("".join(f"{s} {e} {p}\n" for p, s, e in zip(phones, f[:-1], f[1:])))
            freqs, phases = r.uniform(0.5, 3.0, 12), r.uniform(0, 2 * np.pi, 12)

            def tracks(hz, n):
                return np.sin(2 * np.pi * freqs * (np.arange(n)[:, None] / hz) + phases)

            out[corpus][stem] = tracks(50, int(dur * 50)).astype(np.float32)
            if corpus == "mngu0":
                continue
            T = int(dur * rate)
            sparc = tracks(rate, T).astype(np.float32)
            if (corpus, i) == EMA_NAN_SENTENCE:
                sparc[r.choice(T, T // 10, replace=False), 5] = np.nan
            if corpus == "pb2007":
                raw = np.zeros((T, 12), np.float32)
                raw[:, tables.PB2007_IDX_TO_KEEP] = sparc
                raw.tofile(d / "ema" / f"{stem}.bin")
            elif corpus == "mocha":
                ema = r.standard_normal((T, 20)).astype(np.float32)
                ema[:, tables.MOCHA_IDX_TO_KEEP] = sparc
                frames = np.concatenate([(np.arange(T) / rate)[:, None], np.ones((T, 1)), ema],
                                        axis=1).astype(np.float32)
                with open(d / "ema" / f"{stem}.ema", "wb") as fo:
                    fo.write(f"EST_File Track\nDataType binary\nByteOrder 01\nNumFrames {T}\n"
                             "NumChannels 20\nEST_Header_End\n".encode("ascii"))
                    frames.tofile(fo)
            else:
                raw = r.standard_normal((21, T)).astype(np.float32)
                raw[tables.MSPKA_EMA_IDX_TO_KEEP] = sparc.T
                (d / "ema" / f"{stem}.ema").write_text(
                    "\n".join(" ".join(f"{v:.6f}" for v in row) for row in raw) + "\n")
    return out


def ema_corpus_phase(card, dev, counters, plains):
    """Phase 17 (`ema_corpus`): the EMA corpora and the corpus evaluation
    they feed, on seeded files in each corpus's own format
    (`write_ema_corpora`, under `build/chip_smoke_ema/`, removed after):
    `cli.generate_phnm3.main` over each corpus (every file written and
    equal to the reader's phnm3); for each corpus with EMA,
    `SpeakerMetadata(ema_rate=<the layout's ema_sr>).scan`, `validate_ema`
    (the NaN sentence invalid, the rest valid), `set_splits` and
    `agg_Xy_split`; v1 at full width from a seeded checkpoint through
    `cli.synthesize.main` (Euler@50) over a phnm3 filelist of every
    sentence, laid out as `write_cli_corpus` lays out v1's, the launch
    counters set to 0 just before and read just after (K1-K3 13 / 2 / 2 an
    evaluation x 50 x sentences, no plain version and no module path on the
    card); `quanti_art_corpus` of those artifacts against the corpus EMA at
    50 Hz (one finite CSV row a valid sentence, none for the invalid one);
    a control whose predictions are the corpus channels at 50 Hz in the
    artifact's decoder rows plus 1% noise (mean PCC above 0.95 for every
    corpus with EMA: the readers, channel selections and resampling end to
    end); one sentence's 4-step v1 artifact on the card against the CPU
    (phase 10's technique and TOL_WAV); walls by stage. Returns the K1-K5
    launches of the synthesis."""
    import csv

    import numpy as np
    import torch

    from arttts_tpu_torch.cli import generate_phnm3 as cli_phnm3
    from arttts_tpu_torch.cli import synthesize as cli_synthesize
    from arttts_tpu_torch.core.checkpoint import save_checkpoint
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.corpora import get_corpus
    from arttts_tpu_torch.corpora.configs import CORPUS_LAYOUTS
    from arttts_tpu_torch.corpora.ema_metadata import SpeakerMetadata
    from arttts_tpu_torch.eval.quanti_corpus import quanti_art_corpus
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d

    root = ROOT / "build" / "chip_smoke_ema"
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    failures, walls = [], {}
    analytic = write_ema_corpora(root)
    stems = {c: sorted(analytic[c]) for c in EMA_CORPORA}
    with_ema = [c for c in EMA_CORPORA if get_corpus(c).get_ema is not None]
    walls["write_s"] = time.perf_counter() - t_phase

    # 1. phnm3 through the CLI, every file equal to its reader's output
    t0 = time.perf_counter()
    phnm3_dir = root / "phnm" / "phnm3"
    written = {c: cli_phnm3.main(["--corpus", c, "--phnm-dir", str(root / c / "labels"),
                                  "--save-dir", str(phnm3_dir)]) for c in EMA_CORPORA}
    walls["phnm3_s"] = time.perf_counter() - t0
    phnm3_ok = {}
    for c in EMA_CORPORA:
        ok = written[c] == [str(phnm3_dir / f"{s}_phnm3.npy") for s in stems[c]]
        for s in stems[c]:
            a = np.load(phnm3_dir / f"{s}_phnm3.npy")
            b = get_corpus(c).get_phnm3(root / c / "labels" / f"{s}{get_corpus(c).label_ext}")
            ok = ok and a.dtype == b.dtype and all(np.array_equal(a[f], b[f])
                                                   for f in a.dtype.names)
        phnm3_ok[c] = bool(ok)
        if not ok:
            failures.append(f"phnm3 of {c}: {written[c]}")

    # 2. metadata: scan, validate, splits, training pairs
    t0 = time.perf_counter()
    metas, meta_rec = {}, {}
    for c in with_ema:
        meta = SpeakerMetadata(c, "spk", str(root / c), ema_rate=CORPUS_LAYOUTS[c].ema_sr).scan(
            str(root / c / "labels"), str(root / c / "ema"))
        meta.validate_ema()
        meta.extract_durations()
        meta.set_splits()
        X, y = meta.agg_Xy_split("train")
        valid = {s.stem: s.valid for s in meta.get_sentences()}
        want = {s: (c, int(s[-3:])) != EMA_NAN_SENTENCE for s in stems[c]}
        meta_rec[c] = dict(ema_rate=meta.ema_rate, valid=valid,
                           durations_s=[s.duration for s in meta.get_sentences()],
                           train_pairs=len(X),
                           ema_shapes_100hz=[list(e.shape) for e in y])
        if (valid != want or len(X) != sum(want.values()) or len(y) != len(X)
                or not all(e.shape[1] == 12 and np.isfinite(e).all() for e in y)):
            failures.append(f"metadata of {c}: {meta_rec[c]}")
        metas[c] = meta
    walls["metadata_s"] = time.perf_counter() - t0

    # 3. v1 synthesis through the CLI, on a filelist laid out as v1's corpus
    art_dir = root / "phnm" / "encoded_audio_en" / "emasrc"
    art_dir.mkdir(parents=True)
    r = np.random.default_rng(18)
    lines = []
    for c in EMA_CORPORA:
        for s in stems[c]:
            tr = analytic[c][s]
            art = np.concatenate([tr, 120 + 20 * r.standard_normal((len(tr), 1)),
                                  r.uniform(0.1, 1.0, (len(tr), 1))], axis=1)
            np.save(art_dir / f"{s}.npy", art.astype(np.float32))
            lines.append(f"DUMMY/wavs/{s}.wav|DUMMY/phnm/phnm3/{s}_phnm3.npy")
    (root / "phnm.txt").write_text("\n".join(lines))
    (root / "one.txt").write_text(lines[len(stems["mngu0"])])  # MOCHA's first sentence
    model = build_model(get_preset("v1").model, device="cpu", seed=21)
    save_checkpoint(str(root / "ckpt"), "v1", model.state_dict())

    def synthesize(tag, filelist, steps, device, extra=()):
        return cli_synthesize.main([
            "--preset", "v1", "--ckpt", str(root / "ckpt" / "v1"), "--filelist",
            str(root / filelist), "--data-root", str(root), "--save-dir", str(root / tag),
            "--n-timesteps", str(steps), "--solver", "euler", "--device", device, *extra])

    for f in counters + plains:
        setattr(f, "launches" if f in counters else "cuda_calls", 0)
    GradLogPEstimator2d.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = synthesize("art", "phnm.txt", N_STEPS, str(dev))
    torch.cuda.synchronize()
    walls["synthesis_s"] = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    plain = {f.__name__: f.cuda_calls for f in plains}
    n = len(lines)
    want = {"resblock2d": 13 * N_STEPS * n, "downsample2d": 2 * N_STEPS * n,
            "conv_transpose2d": 2 * N_STEPS * n, "mrf_stage": 0, "upsample1d": 0}
    arts = {Path(p).stem: np.load(p) for p in paths}
    frames = {k: int(a.shape[1]) for k, a in arts.items()}
    if launches != want or any(plain.values()) or GradLogPEstimator2d.cuda_calls:
        failures.append(f"synthesis: launches {launches}, expected {want}; plain {plain}; "
                        f"module path {GradLogPEstimator2d.cuda_calls}")
    if sorted(arts) != sorted(s for c in EMA_CORPORA for s in stems[c]) or not all(
            a.shape[0] == 29 and np.isfinite(a).all() for a in arts.values()):
        failures.append(f"synthesis: artifacts {frames}")

    # 4. quanti of the artifacts against the corpus EMA at 50 Hz, one CSV
    t0 = time.perf_counter()
    out_csv = root / "quanti.csv"
    quanti = {c: quanti_art_corpus(str(root / "art"), metas[c], out_csv=str(out_csv))
              for c in with_ema}
    walls["quanti_s"] = time.perf_counter() - t0
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    valid_stems = sorted(s for c in with_ema for s, v in meta_rec[c]["valid"].items() if v)
    csv_ok = (rows[0] == ["sample_id", "dtw", "ema_pcc"]
              and sorted(row[0] for row in rows[1:]) == valid_stems
              and all(np.isfinite([float(row[1]), float(row[2])]).all() for row in rows[1:]))
    if not csv_ok:
        failures.append(f"quanti CSV: {rows}")

    # 5. control: the corpus channels at 50 Hz in the decoder rows, plus 1% noise
    ctrl = root / "control"
    ctrl.mkdir()
    for c in with_ema:
        for s in stems[c]:
            tr = analytic[c][s]
            a = r.standard_normal((29, len(tr))).astype(np.float32)
            a[14:26] = tr.T + 0.01 * r.standard_normal(tr.T.shape)
            np.save(ctrl / f"{s}.npy", a)
    t0 = time.perf_counter()
    control = {c: quanti_art_corpus(str(ctrl), metas[c]) for c in with_ema}
    walls["control_quanti_s"] = time.perf_counter() - t0
    control_pcc = {c: min(v["ema_pcc"] for v in res.values()) for c, res in control.items()}
    if not all(len(control[c]) == sum(meta_rec[c]["valid"].values())
               and control_pcc[c] > TOL_EMA_CONTROL_PCC for c in with_ema):
        failures.append(f"control: min PCC {control_pcc} (<= {TOL_EMA_CONTROL_PCC}?)")

    # 6. one sentence on the card against the CPU: 4 steps, temperature 1e6
    g, c_ = (np.load(synthesize(f"one_{device}", "one.txt", 4, device,
                                ("--temperature", "1e6"))[0])
             for device in (str(dev), "cpu"))
    err = float(np.abs(g - c_).max()) if g.shape == c_.shape else math.inf
    vs_cpu = dict(file=lines[len(stems["mngu0"])].split("|")[0], frames=int(g.shape[1]),
                  steps=4, max_abs_err=err, max_abs_cpu=float(np.abs(c_).max()), tol=TOL_WAV,
                  input_map_equal=bool(g.shape == c_.shape and np.array_equal(g[28], c_[28])))
    vs_cpu["ok"] = err <= TOL_WAV and vs_cpu["input_map_equal"]
    if not vs_cpu["ok"]:
        failures.append(f"card vs CPU: {vs_cpu}")

    emit({"ema_corpus": {
        "card": card, "corpora": {c: len(stems[c]) for c in EMA_CORPORA},
        "seconds_of_speech": sum(len(a) / 50 for c in EMA_CORPORA for a in analytic[c].values()),
        "phnm3_files_equal_reader": phnm3_ok, "metadata": meta_rec,
        "synthesis": dict(entry="cli.synthesize.main", preset="v1", solver="euler",
                          steps=N_STEPS, sentences=n, frames=frames, launches=launches,
                          expected_launches=want, plain_calls_on_card=plain,
                          module_path_calls_on_card=GradLogPEstimator2d.cuda_calls),
        "quanti": quanti,
        "csv_rows": len(rows) - 1, "csv_ok": csv_ok,
        "control_min_pcc": control_pcc, "control_tol": TOL_EMA_CONTROL_PCC,
        "card_vs_cpu": vs_cpu, "walls": walls,
        "phase_s": time.perf_counter() - t_phase}})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        fail("ema_corpus: " + "; ".join(failures))
    return launches


def main():
    if not (ROOT / "arttts_tpu_torch" / "csrc").is_dir():
        fail("arttts_tpu_torch/ is not beside chip_smoke.py: run from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))

    # ---- 1. environment -----------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    emit({"env": {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                  "python": sys.version.split()[0],
                  "nvcc": nvcc if nvcc and os.path.exists(nvcc) else shutil.which("nvcc"),
                  "triton": triton_v, "device_count": torch.cuda.device_count()}})
    dev = torch.device("cuda")

    # ---- 2. build --------------------------------------------------------
    from arttts_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = {}
    for name in _build.SOURCES:
        fn = None
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    emit({"build": {"seconds": round(time.perf_counter() - t0, 2), "ptxas": ptxas}})

    from arttts_tpu_torch.ops import mas as K6
    from arttts_tpu_torch.ops import mrf as K4
    from arttts_tpu_torch.ops import resblock2d as K1
    from arttts_tpu_torch.ops import updown
    from arttts_tpu_torch.ops import upsample as K5

    # ---- 3. each kernel against its plain version -------------------------
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def block_w(c_in, c_out, block_only=False):
        w = dict(w1=rnd(c_out, c_in, 3, 3, scale=(9 * c_in) ** -0.5), b1=rnd(c_out, scale=0.1),
                 gn1_w=1 + rnd(c_out, scale=0.1), gn1_b=rnd(c_out, scale=0.1))
        if not block_only:
            w.update(w2=rnd(c_out, c_out, 3, 3, scale=(9 * c_out) ** -0.5),
                     b2=rnd(c_out, scale=0.1), gn2_w=1 + rnd(c_out, scale=0.1),
                     gn2_b=rnd(c_out, scale=0.1))
            if c_in != c_out:
                w.update(w_res=rnd(c_out, c_in, scale=c_in ** -0.5), b_res=rnd(c_out, scale=0.1))
        return K1.BlockWeights(**w)

    def attn_w(c):
        return K1.AttnWeights(gain=torch.full((1,), 0.3, device=dev),
                              w_qkv=rnd(384, c, scale=c ** -0.5),
                              w_out=rnd(c, 128, scale=128 ** -0.5), b_out=rnd(c, scale=0.1))

    def cuda_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_kernel(a):
        """A device event of the profile that is work, not the device-side
        copy of a user annotation (the port's `arttts.*` spans among them)."""
        return (a.device_type == DeviceType.CUDA and not getattr(a, "is_user_annotation", False)
                and not a.key.startswith("arttts."))

    def device_ms(fn, key=None, n=20):
        """Device time per call of the kernels whose name holds `key` (all
        kernels when None), from torch.profiler over n calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(a.self_device_time_total for a in prof.key_averages()
                 if device_kernel(a) and (key is None or key in a.key))
        return us / 1e3 / n

    def compare(kernel_fn, plain_fn):
        got, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"kernel output shape {tuple(got.shape)}, plain {tuple(ref.shape)}")
        if not torch.isfinite(got).all():
            fail("kernel output is not finite")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        return err, scale

    cases = []
    mas_cases = []
    cases16 = []  # phase 3b

    def bf16_check(kernel, case, lengths, run16, plain16, plain32, flops, nbytes, key, timed,
                   n=10, attn=False, core=None, lib16=None):
        """Phase 3b's record of one case: the bf16 kernel against its plain
        bf16 version, within the kernel's tolerance and within a share of
        the plain version's own bf16-vs-float32 distance on the same inputs
        (the mode and its rounding points), a second run's bits, event and
        device ms, and the bf16 bound (operations over the dense bf16 peak,
        or bytes). `core`: the attention core's own record, when fused.
        `lib16`: one PyTorch call of the same function on bf16 operands
        (cuDNN accumulates in float32), timed beside it."""
        got, ref = run16(), plain16()
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"bf16 kernel output shape {tuple(got.shape)}, plain {tuple(ref.shape)}")
        if not torch.isfinite(got).all():
            fail("bf16 kernel output is not finite")
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        gap = (ref - plain32()).abs().max().item()
        same = bool(torch.equal(got, run16()))
        del got, ref
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ref = next((c for c in cases if c["kernel"] == kernel and c["case"] == case
                    and c.get("lengths") == lengths), {})
        cases16.append(dict(
            kernel=kernel, case=case, lengths=lengths, shape=ref.get("shape"),
            in_eval=ref.get("in_eval", False), attn=attn,
            artic=ref.get("artic", False), max_abs_err=err, max_abs_ref=scale,
            max_rel_err=err / max(1.0, scale), tol=TOL_KERNEL_BF16[kernel + "+attn" * attn],
            same_bits_twice=same, plain_bf16_vs_f32=gap, gap_share=err / gap,
            max_gap_share=BF16_GAP_SHARE_ATTN_BLOCK if attn else BF16_GAP_SHARE, attn_core=core,
            ms=cuda_ms(run16, n), device_ms_per_call=device_ms(run16, key, n) if timed else None,
            bound_ms=b_ms, bound_by=b_by, f32_ms=ref.get("ms"),
            f32_device_ms=ref.get("device_ms_per_call"), f32_bound_ms=ref.get("bound_ms"),
            library_ms=ref.get("library_ms"), library_conv_ms=ref.get("library_conv_ms"),
            library_bf16_ms=cuda_ms(lib16, n) if lib16 else None,
            library_bf16_device_ms=device_ms(lib16, None, n) if lib16 else None))

    def ordered_bf16(t):
        """bf16 values as integers in their order: neighbours differ by 1."""
        i = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    def attn_core_check(B, P, a, small=False):
        """K1's attention core alone in the bf16 mode, the same qkv on both
        sides (the bf16 product of a block-sized input). Its rounding
        points: the kernel's context is bf16 (rounded after the division
        by S) and equals the plain one but for at most 1% of its entries
        (a float32 sum of P terms that cancel lands on the other side of a
        rounding boundary), while a context from unrounded v or unrounded
        exp(k - max), computed here as controls, must differ in more (14-29%
        of them on the CPU at P 1,024 and 61,440); its q ctx is bf16(q)
        times its context to float32 accuracy. `small`: a P whose sums keep
        the flips rare, where the output must also lie within half the
        core's own bf16-vs-float32 distance."""
        y = rnd(B, a.w_qkv.shape[1], P, scale=3.0)
        qkv = torch.einsum("oc,bcp->bop", K1.round_bf16(a.w_qkv), K1.round_bf16(y)).contiguous()
        ctx_k, out_k = K1.attention_core_cuda(k1_lib, qkv, bf16=True)
        ctx_p, out_p = K1.attention_core_plain(qkv, bf16=True)
        out_32 = K1.attention_core_plain(qkv)[1]
        q, k, v = qkv.reshape(B, 3, K1.HEADS, K1.DIM_HEAD, P).unbind(1)
        ke = torch.exp(k - k.amax(dim=-1, keepdim=True))
        S = ke.sum(dim=-1)[..., None]
        ctx_of = lambda kk, vv: K1.round_bf16(torch.einsum("bhdn,bhen->bhde", kk, vv) / S)  # noqa
        flips = lambda c: float((c != ctx_p).float().mean())  # noqa: E731
        out_on_k = torch.einsum("bhde,bhdn->bhen", ctx_k, K1.round_bf16(q)).reshape(out_k.shape)
        err, gap = (out_k - out_p).abs().max().item(), (out_p - out_32).abs().max().item()
        r = dict(B=B, P=P, ctx_is_bf16=bool(torch.equal(K1.round_bf16(ctx_k), ctx_k)),
                 ctx_flipped_share=flips(ctx_k),
                 control_v_unrounded=flips(ctx_of(K1.round_bf16(ke), v)),
                 control_exp_unrounded=flips(ctx_of(ke, K1.round_bf16(v))),
                 q_ctx_rel_err=((out_k - out_on_k).abs().max()
                                / out_on_k.abs().max().clamp(min=1.0)).item(),
                 max_abs_err=err, plain_bf16_vs_f32=gap, gap_share=err / gap)
        r["ok"] = (r["ctx_is_bf16"] and r["ctx_flipped_share"] <= 0.01
                   and min(r["control_v_unrounded"], r["control_exp_unrounded"]) > 0.01
                   and r["q_ctx_rel_err"] <= TOL_KERNEL
                   and (not small or r["gap_share"] <= BF16_GAP_SHARE))
        return r

    def k6_case(name, t_xs, t_ys, T_x, T_y, integer=False, in_step=False):
        B = len(t_xs)
        if integer:  # small whole numbers: DP entries tie
            value = torch.randint(-2, 3, (B, T_x, T_y), generator=g, device=dev).float()
        else:
            value = rnd(B, T_x, T_y)
        tx = torch.tensor(t_xs, dtype=torch.int32, device=dev)
        ty = torch.tensor(t_ys, dtype=torch.int32, device=dev)
        mask = ((torch.arange(T_x, device=dev)[None, :, None] < tx[:, None, None])
                & (torch.arange(T_y, device=dev)[None, None, :] < ty[:, None, None])).float()
        masked = value * mask
        kern = lambda: K6.maximum_path(value, mask)  # noqa: E731
        plain = lambda: K6.maximum_path_plain(masked, tx, ty)  # noqa: E731
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        oracle = K6.mas_reference_numpy(masked.cpu().numpy(), np.asarray(t_xs), np.asarray(t_ys))
        off_oracle = int((got.cpu().numpy().astype(np.int32) != oracle).sum())
        n = B * T_x * T_y
        # the function's bytes: value and mask read, path written
        bytes_ms = 3 * 4 * n / PEAK_BYTES * 1e3
        ops_ms = 8 * n / PEAK_F32_FLOPS * 1e3  # compares, selects, max, add per cell
        chain_ms = T_y * MAS_CHAIN_CYCLES / CLOCK_HZ * 1e3
        lib = _build.library("mas")
        kernel_only = lambda: K6._maximum_path_cuda(lib, masked, tx, ty)  # noqa: E731
        # the wrapper's own work before the launch: the masking and the length sums
        masking = lambda: (value * mask, mask[:, :, 0].sum(1).to(torch.int32),  # noqa: E731
                           mask[:, 0, :].sum(1).to(torch.int32))
        # csrc/mas.cu's route: one warp an utterance up to 1,024 positions,
        # else ceil(T_x / 1024) warps; decision words in device memory when
        # they do not fit in shared memory
        mas_cases.append(dict(
            kernel="maximum_path", case=name, shape=[B, T_x, T_y], t_x=list(t_xs), t_y=list(t_ys),
            integer_values=integer, in_step=in_step, exact_vs_plain=bool(torch.equal(got, ref)),
            cells_off_oracle=off_oracle, max_abs_err=(got - ref).abs().max().item(),
            warps_per_utterance=-(-T_x // 1024),
            words_in_device_memory=lib.mas_dec_words(B, T_x, T_y) > 0,
            ms=cuda_ms(kern), kernel_only_ms=cuda_ms(kernel_only),
            masking_ms=cuda_ms(masking) if in_step else None,
            # device ms per call by part: forward and backtrace (mas_dp*), path write
            device_ms_by_part=dict(
                forward_and_backtrace=device_ms(kernel_only, "mas_dp"),
                path_write=device_ms(kernel_only, "mas_path_kernel")) if in_step else None,
            plain_ms=cuda_ms(plain, n=2), bound_ms=max(bytes_ms, ops_ms, chain_ms),
            bound_by="bytes" if bytes_ms >= max(ops_ms, chain_ms) else "operations",
            bytes_ms=bytes_ms, ops_ms=ops_ms, dependent_chain_ms=chain_ms, library_ms=None))

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k1_lib = _build.library("resblock2d")
    # the `wgmma` route's kernels as the runtime sees them (registers a
    # thread, blocks an SM, dynamic shared memory a block) and as ptxas
    # reported them
    wgmma_tiles = {}
    for rows in K1.WGMMA_ROWS:
        info = (ctypes.c_int * 3)()
        _build.call(k1_lib, "conv_wgmma_info", rows, info)
        wgmma_tiles[rows] = dict(registers=info[0], blocks_per_sm=info[1], smem_bytes=info[2])
    emit({"k1_wgmma_route": {"card": card, "sms": n_sm, "tiles": wgmma_tiles,
                             "ptxas": {fn: lines for fn, lines in ptxas.items()
                                       if "WgmmaTile" in fn}}})

    def k1_case(name, cs, c_out, H, T, lengths, attn=False, masked=True, block_only=False,
                in_eval=True, artic=False, bf16=False):
        B = len(lengths)
        xs = [rnd(B, c, H, T) for c in cs]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        temb = None if block_only else rnd(B, c_out)
        w = block_w(sum(cs), c_out, block_only)
        a = attn_w(c_out) if attn else None
        kw = dict(masked_stats=masked, eps=1e-6, attn=a)
        kern = lambda: K1.resblock2d(xs, lens, temb, w, **kw)  # noqa: E731
        plain = lambda: K1.resblock2d_plain(xs, lens, temb, w, **kw)  # noqa: E731
        c_in, P = sum(cs), B * H * T
        flops = 2 * 9 * c_in * c_out * P
        if not block_only:
            flops += 2 * 9 * c_out * c_out * P + (2 * c_in * c_out * P if c_in != c_out else 0)
        if attn:  # qkv, context, q.ctx, output projection
            flops += 2 * 384 * c_out * P + 2 * 2 * 4 * 32 * 32 * P + 2 * 128 * c_out * P
        wbytes = sum(t.numel() for t in vars(w).values() if t is not None)
        if a is not None:
            wbytes += sum(t.numel() for t in vars(a).values())
        nbytes = 4 * (c_in * P + c_out * P + wbytes + (B * c_out if temb is not None else 0))
        if bf16:
            kw16 = dict(kw, bf16=True)
            return bf16_check(
                "resblock2d", name, lengths, lambda: K1.resblock2d(xs, lens, temb, w, **kw16),
                lambda: K1.resblock2d_plain(xs, lens, temb, w, **kw16), plain, flops, nbytes,
                None, in_eval or artic, attn=attn, core=attn_core_check(B, P, a) if attn else None)
        err, scale = compare(kern, plain)
        again = kern()
        same_bits = bool(torch.equal(kern(), again))
        # the products run on the tensor cores in three TF32 passes (3xTF32)
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        f32_ms, _ = bound(flops, nbytes)
        # blocks of each product launch: the 3x3 convs on the route
        # `conv3x3_route` gives them (rows of the `wgmma` tile, or 0 for the
        # `mma.sync` body, which picks its tile per shape), then the 1x1
        # products (`mma.sync`)
        routes = [K1.conv3x3_route(B, c, c_out, H, T, False, n_sm)
                  for c in ((c_in,) if block_only else (c_in, c_out))]
        blocks_3x3 = [k1_lib.conv_blocks(B, c_out, H, T, r) for r in routes]
        blocks = min(blocks_3x3)
        blocks_1x1 = [k1_lib.conv_blocks(B, c_out, H, T, 0)] if w.w_res is not None else []
        if attn:
            blocks_1x1 += [k1_lib.conv_blocks(B, 384, H, T, 0),
                           k1_lib.conv_blocks(B, c_out, H, T, 0)]
        # the 3x3 products alone: device time beside their 3xTF32 bound
        flops_3x3 = 2 * 9 * c_out * P * (c_in + (0 if block_only else c_out))
        # yardstick of one part: the block's 3x3 convolutions through cuDNN
        # (TF32 off), never called by the port; not the block's function
        x_cat = torch.cat(xs, dim=1)
        h_mid = rnd(B, c_out, H, T)
        convs = [(x_cat, w.w1, w.b1)] + ([] if block_only else [(h_mid, w.w2, w.b2)])
        lib_conv = lambda: [torch.nn.functional.conv2d(i, k, bb, padding=1)  # noqa: E731
                            for i, k, bb in convs]
        timed = in_eval or artic
        cases.append(dict(kernel="resblock2d", case=name, shape=[B, list(cs), c_out, H, T],
                          lengths=lengths, attn=attn, masked_stats=masked, block_only=block_only,
                          in_eval=in_eval, artic=artic, max_abs_err=err, max_abs_ref=scale,
                          same_bits_twice=same_bits, wgmma_rows=routes, wgmma=any(routes),
                          blocks=blocks, blocks_3x3=blocks_3x3, blocks_1x1=blocks_1x1,
                          ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                          bound_by=b_by, bound_f32_cuda_core_ms=f32_ms,
                          device_ms_per_call=device_ms(kern) if timed else None,
                          conv3x3_device_ms=(device_ms(kern, "conv3x3_kernel") if timed
                                             else None),
                          conv3x3_bound_ms=3 * flops_3x3 / PEAK_TF32_FLOPS * 1e3,
                          library_ms=None,
                          library_conv_ms=cuda_ms(lib_conv) if timed else None,
                          library_conv_device_ms=device_ms(lib_conv) if timed else None))

    def updown_case(kernel, cin, H, T, lengths, artic=False, bf16=False):
        B = len(lengths)
        x = rnd(B, cin, H, T)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if kernel == "downsample2d":
            w, b = rnd(cin, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cin, scale=0.1)
            # csrc/updown.cu's launcher: 64 channels x 4 x 16 output pixels a
            # block where that gives a block to every SM, else 64 x 2 x 16
            for r in (4, 2):
                blocks = (math.ceil((H + 1) // 2 / r) * math.ceil((T + 1) // 2 / 16)
                          * (cin // 64) * B)
                if blocks >= n_sm:
                    break
            kern = lambda: updown.downsample2d(x, lens, w, b)  # noqa: E731
            plain = lambda: updown.downsample2d_plain(x, lens, w, b)  # noqa: E731
            lib = lambda: torch.nn.functional.conv2d(x, w, b, stride=2, padding=1)  # noqa: E731
            out_n = B * cin * ((H + 1) // 2) * ((T + 1) // 2)
            flops = 2 * 9 * cin * out_n
        else:
            w, b = rnd(cin, cin, 4, 4, scale=(4 * cin) ** -0.5), rnd(cin, scale=0.1)
            kern = lambda: updown.conv_transpose2d(x, lens, w, b)  # noqa: E731
            plain = lambda: updown.conv_transpose2d_plain(x, lens, w, b)  # noqa: E731
            lib = lambda: torch.nn.functional.conv_transpose2d(  # noqa: E731
                x, w, b, stride=2, padding=1)
            out_n = B * cin * 4 * H * T
            flops = 2 * 4 * cin * out_n  # 4 of the 16 taps reach each output
            # 64 channels x an input tile of 2 x 16 a block
            blocks = math.ceil(H / 2) * math.ceil(T / 16) * (cin // 64) * B
        nbytes = 4 * (B * cin * H * T + out_n + w.numel() + b.numel())
        full = lengths == [T]
        name = "downsample_kernel" if kernel == "downsample2d" else "convt_kernel"
        if bf16:
            fn = getattr(updown, kernel)
            lib_fn = (torch.nn.functional.conv2d if kernel == "downsample2d"
                      else torch.nn.functional.conv_transpose2d)
            x16, w16, b16 = (t.to(torch.bfloat16) for t in (x, w, b))
            return bf16_check(kernel, f"C={cin} {H}x{T}", lengths,
                              lambda: fn(x, lens, w, b, bf16=True),
                              lambda: getattr(updown, kernel + "_plain")(x, lens, w, b,
                                                                         bf16=True),
                              plain, flops, nbytes, name, full or artic,
                              lib16=(lambda: lib_fn(x16, w16, b16, stride=2, padding=1))
                              if full else None)
        err, scale = compare(kern, plain)
        again = kern()
        same_bits = bool(torch.equal(kern(), again))
        # the tensor-core route: three TF32 passes per product (3xTF32)
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        f32_ms, _ = bound(flops, nbytes)
        # the main path's calls (B=1, unpadded; the v2 evaluation's unless
        # `artic`); there the library call is the same function
        lib_ms = cuda_ms(lib) if full else None
        cases.append(dict(kernel=kernel, case=f"C={cin} {H}x{T}", shape=[B, cin, H, T],
                          lengths=lengths, in_eval=full and not artic, artic=artic,
                          max_abs_err=err, max_abs_ref=scale,
                          same_bits_twice=same_bits, blocks=blocks,
                          ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                          bound_by=b_by, bound_f32_cuda_core_ms=f32_ms,
                          device_ms_per_call=device_ms(kern, name) if full else None,
                          library_ms=lib_ms,
                          library_device_ms=device_ms(lib) if full else None))

    k4_lib = _build.library("mrf")

    def k4_case(name, B, C, T, ks=(3, 7, 11), film=False, in_eval=False, n=5, bf16=False):
        w = tuple(K4.MRFBranch(w1=rnd(3, C, C, k, scale=(k * C) ** -0.5), b1=rnd(3, C, scale=0.1),
                               w2=rnd(3, C, C, k, scale=(k * C) ** -0.5), b2=rnd(3, C, scale=0.1),
                               dilations=(1, 3, 5)) for k in ks)
        x = rnd(B, C, T)
        f = ((1 + rnd(len(ks), 3, B, C, scale=0.3), rnd(len(ks), 3, B, C, scale=0.1))
             if film else None)
        kern = lambda: K4.mrf_stage(x, w, f)  # noqa: E731
        plain = lambda: K4.mrf_stage_plain(x, w, f)  # noqa: E731
        flops = 2 * 2 * C * C * B * T * 3 * sum(ks)  # two convs per round, 3 rounds
        wbytes = sum(t.numel() for br in w for t in (br.w1, br.b1, br.w2, br.b2))
        nbytes = 4 * (2 * B * C * T + wbytes + (2 * f[0].numel() if film else 0))
        if bf16:
            return bf16_check("mrf_stage", name, None, lambda: K4.mrf_stage(x, w, f, bf16=True),
                              lambda: K4.mrf_stage_plain(x, w, f, bf16=True), plain, flops,
                              nbytes, "mrf_round_kernel", True, n)
        err, scale = compare(kern, plain)
        again = kern()
        same_bits = bool(torch.equal(kern(), again))
        # the products run on the tensor cores in three TF32 passes (3xTF32)
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        f32_ms, _ = bound(flops, nbytes)
        # blocks of each branch's launches (csrc/mrf.cu: NF - (k - 1) frames a block)
        blocks = [k4_lib.mrf_blocks(B, C, k, T) for k in ks]
        # yardstick of one part: the stage's 18 convolutions through cuDNN (TF32
        # off), never called by the port; not the stage's function
        convs = [(br.w1[r], br.b1[r], d * (br.w1.shape[-1] - 1) // 2, d)
                 for br in w for r, d in enumerate(br.dilations)]
        convs += [(br.w2[r], br.b2[r], (br.w2.shape[-1] - 1) // 2, 1)
                  for br in w for r in range(len(br.dilations))]
        lib_conv = lambda: [  # noqa: E731
            torch.nn.functional.conv1d(x, k_, b_, padding=p_, dilation=d_)
            for k_, b_, p_, d_ in convs]
        cases.append(dict(kernel="mrf_stage", case=name, shape=[B, C, T], kernel_sizes=list(ks),
                          film=film, in_eval=in_eval, max_abs_err=err, max_abs_ref=scale,
                          same_bits_twice=same_bits, blocks=min(blocks), blocks_by_branch=blocks,
                          ms=cuda_ms(kern, n), plain_ms=cuda_ms(plain, n), bound_ms=b_ms,
                          bound_by=b_by, bound_f32_cuda_core_ms=f32_ms,
                          device_ms_per_call=device_ms(kern, "mrf_round_kernel", n)
                          if in_eval else None,
                          library_ms=None,
                          library_conv_ms=cuda_ms(lib_conv, n) if in_eval else None,
                          library_conv_device_ms=device_ms(lib_conv, None, n)
                          if in_eval else None))

    k5_lib = _build.library("upsample1d")

    def k5_case(name, B, cin, cout, T, pad, outpad, in_eval=False):
        x = rnd(B, cin, T)
        w, b = rnd(cin, cout, 4, scale=(2 * cin) ** -0.5), rnd(cout, scale=0.1)
        xl = torch.nn.functional.leaky_relu(x, 0.1)
        kern = lambda: K5.upsample1d(x, w, b, 2, pad, outpad)  # noqa: E731
        plain = lambda: K5.upsample1d_plain(x, w, b, 2, pad, outpad)  # noqa: E731
        lib = lambda: torch.nn.functional.conv_transpose1d(xl, w, b, 2, pad, outpad)  # noqa: E731
        err, scale = compare(kern, plain)
        again = kern()
        same_bits = bool(torch.equal(kern(), again))
        t_out = (T - 1) * 2 - 2 * pad + 4 + outpad
        flops = 2 * 2 * cin * cout * B * t_out  # 2 of the 4 taps reach each output
        nbytes = 4 * (B * cin * T + B * cout * t_out + w.numel() + b.numel())
        # the products run on the tensor cores in three TF32 passes (3xTF32)
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        f32_ms, _ = bound(flops, nbytes)
        cases.append(dict(kernel="upsample1d", case=name, shape=[B, cin, cout, T],
                          padding=[pad, outpad], in_eval=in_eval, max_abs_err=err,
                          max_abs_ref=scale, same_bits_twice=same_bits,
                          blocks=k5_lib.upsample1d_blocks(B, cin, cout, T, pad, outpad),
                          ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                          bound_ms=b_ms, bound_by=b_by, bound_f32_cuda_core_ms=f32_ms,
                          device_ms_per_call=device_ms(kern, "upsample_kernel")
                          if in_eval else None,
                          library_ms=cuda_ms(lib),
                          library_device_ms=device_ms(lib) if in_eval else None))

    replay = []  # phase 3's K1-K3 cases, run again in the bf16 mode by phase 3b

    def recorded(case_fn):
        def call(*args, **kw):
            replay.append((case_fn, args, kw))
            return case_fn(*args, **kw)
        return call

    k1_case, updown_case = recorded(k1_case), recorded(updown_case)
    # the 13 K1 calls of one score evaluation at 80x768 (masked statistics:
    # bucket 768 is one where the JAX package runs its TPU kernels)
    k1_case("ResnetBlock2d_0", (2,), 64, 80, 768, [768])
    k1_case("ResnetBlock2d_1+attn0", (64,), 64, 80, 768, [768], attn=True)
    k1_case("ResnetBlock2d_2", (64,), 128, 40, 384, [384])
    k1_case("ResnetBlock2d_3+attn1", (128,), 128, 40, 384, [384], attn=True)
    k1_case("ResnetBlock2d_4", (128,), 256, 20, 192, [192])
    k1_case("ResnetBlock2d_5+attn2", (256,), 256, 20, 192, [192], attn=True)
    k1_case("ResnetBlock2d_6+attn3", (256,), 256, 20, 192, [192], attn=True)
    k1_case("ResnetBlock2d_7", (256,), 256, 20, 192, [192])
    k1_case("ResnetBlock2d_8", (256, 256), 128, 20, 192, [192])
    k1_case("ResnetBlock2d_9+attn4", (128,), 128, 20, 192, [192], attn=True)
    k1_case("ResnetBlock2d_10", (128, 128), 64, 40, 384, [384])
    k1_case("ResnetBlock2d_11+attn5", (64,), 64, 40, 384, [384], attn=True)
    k1_case("Block2d_0 (block_only)", (64,), 64, 80, 768, [768], block_only=True)
    # padded frames in both statistics modes (not part of the timed evaluation)
    k1_case("padded, masked stats", (64,), 64, 80, 768, [700], attn=True, in_eval=False)
    k1_case("padded, unmasked stats", (128,), 128, 40, 384, [300], attn=True, masked=False,
            in_eval=False)
    k1_case("padded chunks, unmasked", (256, 256), 128, 20, 192, [150], masked=False,
            in_eval=False)
    k1_case("B=2 padded, masked stats", (64,), 64, 80, 768, [768, 513], attn=True,
            in_eval=False)
    k1_case("B=2 padded, unmasked", (128, 128), 64, 40, 384, [301, 384], masked=False,
            in_eval=False)
    # bucket 1024 (the longest requests): the `wgmma` route's 2-row tile at
    # 20 rows with attention, and its 4-row tile at 40 rows, padded
    k1_case("bucket 1024 ResnetBlock2d_5+attn2", (256,), 256, 20, 256, [256], attn=True,
            in_eval=False)
    k1_case("bucket 1024 ResnetBlock2d_3+attn1, padded", (128,), 128, 40, 512, [455],
            attn=True, in_eval=False)
    updown_case("downsample2d", 64, 80, 768, [768])
    updown_case("downsample2d", 128, 40, 384, [384])
    updown_case("downsample2d", 64, 80, 768, [701])
    updown_case("downsample2d", 128, 40, 384, [384, 250])
    updown_case("conv_transpose2d", 128, 20, 192, [192])
    updown_case("conv_transpose2d", 64, 40, 384, [384])
    updown_case("conv_transpose2d", 64, 40, 384, [351])
    updown_case("conv_transpose2d", 128, 20, 192, [97, 192])
    # the articulatory model's shapes (v6: 16 feature rows, the speaker plane
    # as a third input channel of ResnetBlock2d_0): K1 at c_in 3 and at 16 /
    # 8 / 4 rows, K2 16 -> 8 and 8 -> 4 rows, K3 4 -> 8 and 8 -> 16; their
    # blocks are recorded, not held to the SM count
    k1_case("artic ResnetBlock2d_0 c_in 3, padded", (3,), 64, 16, 256, [181], in_eval=False,
            artic=True)
    k1_case("artic ResnetBlock2d_1+attn0", (64,), 64, 16, 512, [512], attn=True,
            in_eval=False, artic=True)
    k1_case("artic ResnetBlock2d_3+attn1", (128,), 128, 8, 256, [256], attn=True,
            in_eval=False, artic=True)
    k1_case("artic ResnetBlock2d_5+attn2", (256,), 256, 4, 128, [128], attn=True,
            in_eval=False, artic=True)
    # v6.batch's batches of 16 at bucket 256 (the `wgmma` route's 4-row tile)
    k1_case("artic B=16 ResnetBlock2d_1+attn0, padded", (64,), 64, 16, 256,
            [256, 201] * 8, attn=True, in_eval=False, artic=True)
    updown_case("downsample2d", 64, 16, 512, [512], artic=True)
    updown_case("downsample2d", 128, 8, 256, [256], artic=True)
    updown_case("conv_transpose2d", 128, 4, 128, [128], artic=True)
    updown_case("conv_transpose2d", 64, 8, 256, [256], artic=True)
    # the vocoder's K4 and K5 calls of one 768-frame request (rates 8, 8, 2, 2)
    k4_case("C=128 stage", 1, 128, 768 * 64, in_eval=True)
    k4_case("C=64 stage", 1, 64, 768 * 128, in_eval=True)
    k4_case("C=32 stage", 1, 32, 768 * 256, in_eval=True)
    k5_case("128->64, mel padding (k-u)//2", 1, 128, 64, 768 * 64, 1, 0, in_eval=True)
    k5_case("64->32, mel padding (k-u)//2", 1, 64, 32, 768 * 128, 1, 0, in_eval=True)
    # SPARC window batches (8 windows of 576 frames), FiLM on, SPARC padding
    # u//2 + u%2 with output padding u%2 (1 and 0 at stride 2)
    for C, up in ((128, 64), (64, 128), (32, 256)):
        k4_case(f"FiLM C={C}, SPARC window batch", 8, C, 576 * up, film=True, n=2)
    k5_case("128->64, SPARC padding, window batch", 8, 128, 64, 576 * 64, 1, 0)
    k5_case("64->32, SPARC padding, window batch", 8, 64, 32, 576 * 128, 1, 0)
    # the vocoder trainer's discriminator pass (phase 13): B=16, 32 mel frames
    # (segment 8192), the three K4 stages and the two K5 upsamples
    k4_case("training C=128 stage, B=16", 16, 128, 32 * 64)
    k4_case("training C=64 stage, B=16", 16, 64, 32 * 128)
    k4_case("training C=32 stage, B=16", 16, 32, 32 * 256)
    k5_case("training 128->64, B=16", 16, 128, 64, 32 * 64, 1, 0)
    k5_case("training 64->32, B=16", 16, 64, 32, 32 * 128, 1, 0)
    # edges: two utterances, a ragged T, single k=11 branches over many tiles,
    # and the tap routing at other paddings
    k4_case("B=2", 2, 64, 24576)
    k4_case("ragged T", 1, 32, 3001)
    k4_case("k=11 only, 17 tiles", 1, 32, 8192, ks=(11,))
    k4_case("k=11 only, FiLM, 35 tiles", 2, 128, 4096, ks=(11,), film=True)
    k5_case("padding 2, output padding 1", 2, 64, 32, 1001, 2, 1)
    k5_case("padding 0", 1, 128, 64, 999, 0, 0)
    # K6 (MAS): the training bucket (T_x ~ U[100, 190] in text bucket 192,
    # T_y = T_x * U(2.5, 4.5) in frame bucket 1024), edges, both routes of
    # csrc/mas.cu (one warp an utterance up to T_x 1,024, several above),
    # decision words in shared and in device memory, and ties
    r = np.random.default_rng(0)
    t_x = [192] + [int(v) for v in r.integers(100, 191, 15)]
    t_y = [1024] + [min(1024, int(v * r.uniform(2.5, 4.5))) for v in t_x[1:]]
    k6_case("training bucket, ragged", t_x, t_y, 192, 1024, in_step=True)
    k6_case("B=1 at (1, 1)", [1], [1], 1, 1)
    k6_case("T_y = T_x", [160, 120, 77], [160, 120, 77], 160, 160)
    k6_case("t_x > t_y (the band's tests kept)", [40, 33, 10], [25, 30, 7], 40, 30)
    k6_case("T_x > 1024 (2 warps an utterance)", [1100, 1037], [2048, 1999], 1100, 2048)
    k6_case("T_x = 33 (2 positions a lane), T_y % 32 != 0", [33, 20, 1], [100, 77, 5], 33, 100)
    k6_case("T_x = 1024 (one warp, 32 positions a lane), words in device memory",
            [1000, 613], [1100, 990], 1024, 1100)
    k6_case("T_x = 1025 (2 warps, hand-off at x = 1024)", [1025, 1003], [1300, 1111], 1025, 1300)
    k6_case("T_x = 1025 (2 warps), words in shared memory", [700, 512], [851, 800], 1025, 851)
    k6_case("ties (whole numbers)", [64, 50, 33, 64], [256, 200, 150, 64], 64, 256,
            integer=True)
    for c in cases:
        c["ok"] = (c["max_abs_err"] <= TOL_KERNEL * max(1.0, c["max_abs_ref"])
                   and c.get("same_bits_twice", True)
                   and not (c["in_eval"]
                            and min([c.get("blocks", n_sm)] + c.get("blocks_1x1", [])) < n_sm))
        emit({"kernel_case": c})
    for c in mas_cases:
        c["ok"] = c["exact_vs_plain"] and c["cells_off_oracle"] == 0
        emit({"kernel_case": c})
    bad = [f"{c['kernel']} {c['case']}" for c in cases + mas_cases if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version, differs between two runs or "
             f"under-fills the card: {bad}")
    # PERF.md's kernel table, rows 3-6: K2 and K3 at the main path's shapes
    rows = {("downsample2d", 64): 3, ("downsample2d", 128): 4, ("conv_transpose2d", 128): 5,
            ("conv_transpose2d", 64): 6}
    emit({"updown_vs_library": [
        dict(row=rows[(c["kernel"], c["shape"][1])], kernel=c["kernel"], case=c["case"],
             blocks=c["blocks"], sms=n_sm, ms=c["ms"], library_ms=c["library_ms"],
             beat_library=c["ms"] <= c["library_ms"],
             device_ms_per_call=c["device_ms_per_call"],
             library_device_ms=c["library_device_ms"],
             beat_library_on_device=c["device_ms_per_call"] <= c["library_device_ms"])
        for c in cases if c["kernel"] in ("downsample2d", "conv_transpose2d") and c["in_eval"]]})
    # PERF.md's kernel table, row 8: K5's two calls of a 768-frame request
    # against one `F.conv_transpose1d` each on the leaky-ReLU'd input (TF32
    # off), event-timed and on the device; K5 must not lose to it
    k5_ev = [c for c in cases if c["kernel"] == "upsample1d" and c["in_eval"]]
    k5_row = dict(calls=len(k5_ev), blocks=[c["blocks"] for c in k5_ev], sms=n_sm,
                  ms=sum(c["ms"] for c in k5_ev), library_ms=sum(c["library_ms"] for c in k5_ev),
                  device_ms=sum(c["device_ms_per_call"] for c in k5_ev),
                  library_device_ms=sum(c["library_device_ms"] for c in k5_ev))
    k5_row.update(beat_library=k5_row["ms"] <= k5_row["library_ms"],
                  beat_library_on_device=k5_row["device_ms"] <= k5_row["library_device_ms"])
    emit({"upsample_vs_library": k5_row})
    if not (k5_row["beat_library"] and k5_row["beat_library_on_device"]):
        fail(f"K5 is slower than F.conv_transpose1d on the main path's calls: {k5_row}")
    # PERF.md's kernel table, rows 1 and 2: K1 per bench-shape request (50
    # evaluations); row 1 is `resblock2d_packed`'s calls (C=64 at 80x768)
    k1_rows = {}
    for c in cases:
        if c["kernel"] == "resblock2d" and c["in_eval"]:
            row = k1_rows.setdefault(1 if c["shape"][3] == 80 else 2, dict(
                calls_per_evaluation=0, ms=0.0, device_ms=0.0, bound_ms=0.0,
                bound_f32_cuda_core_ms=0.0, plain_ms=0.0, library_conv_ms=0.0,
                library_conv_device_ms=0.0, min_blocks=None))
            row["calls_per_evaluation"] += 1
            for k in ("ms", "bound_ms", "bound_f32_cuda_core_ms", "plain_ms", "library_conv_ms"):
                row[k] += N_STEPS * c[k]
            row["device_ms"] += N_STEPS * c["device_ms_per_call"]
            row["library_conv_device_ms"] += N_STEPS * c["library_conv_device_ms"]
            least = min([c["blocks"]] + c["blocks_1x1"])
            row["min_blocks"] = least if row["min_blocks"] is None else min(row["min_blocks"],
                                                                             least)
    emit({"resblock2d_rows_per_request": {"card": card, "sms": n_sm, "steps": N_STEPS,
                                          "rows": k1_rows}})
    emit({"artic_kernel_shapes": {"card": card, "sms": n_sm, "cases": [
        dict(kernel=c["kernel"], case=c["case"], shape=c["shape"], lengths=c["lengths"],
             blocks=c["blocks"], blocks_1x1=c.get("blocks_1x1"), ms=c["ms"],
             device_ms_per_call=c["device_ms_per_call"], bound_ms=c["bound_ms"],
             bound_f32_cuda_core_ms=c["bound_f32_cuda_core_ms"], plain_ms=c["plain_ms"],
             library_ms=c["library_ms"], max_abs_err=c["max_abs_err"],
             same_bits_twice=c["same_bits_twice"])
        for c in cases if c.get("artic")]}})

    # ---- 3b. bf16: the bf16 modes of K1-K4 against their plain bf16 versions --
    # every K1-K3 case of phase 3 (new draws): K1's 13 call sites of an 80x768
    # evaluation, its padded, unmasked and two-utterance cases and v6's
    # 16 / 8 / 4-row ones; K2 and K3 at both boundaries and v6's; K4's three
    # stages and FiLM. Each within its TOL_KERNEL_BF16 and its share of the
    # plain version's bf16-vs-float32 distance, the same bits twice; each
    # fused attention's core alone at its rounding points.
    t3b = time.perf_counter()
    for case_fn, args, kw in replay:
        case_fn(*args, **kw, bf16=True)
    k4_case("C=128 stage", 1, 128, 768 * 64, bf16=True)
    k4_case("C=64 stage", 1, 64, 768 * 128, bf16=True)
    k4_case("C=32 stage", 1, 32, 768 * 256, bf16=True)
    k4_case("FiLM C=128, SPARC window batch", 8, 128, 576 * 64, film=True, n=2, bf16=True)
    core_small = attn_core_check(2, 1024, attn_w(64), small=True)
    emit({"bf16_attention_core": core_small})
    if not core_small["ok"]:
        fail(f"bf16: K1's attention core does not round where the plain version does: "
             f"{core_small}")
    for c in cases16:
        c["ok"] = (c["max_rel_err"] <= c["tol"] and c["same_bits_twice"]
                   and c["gap_share"] <= c["max_gap_share"]
                   and (c["attn_core"] is None or c["attn_core"]["ok"]))
        emit({"bf16_case": c})
    bad = [f"{c['kernel']} {c['case']}" for c in cases16 if not c["ok"]]
    if bad:
        fail(f"bf16: a kernel disagrees with its plain bf16 version, differs between two "
             f"runs, does not round where it does or its attention core does not: {bad}")
    # per bench-shape request (50 evaluations; the vocoder's three stages once),
    # by the kernel table's rows: K1 row 1 (80 rows) and row 2, K2/K3 by width, K4
    rows16 = {}
    for c in cases16:
        if not c["in_eval"]:
            continue
        if c["kernel"] == "resblock2d":
            row = 1 if c["shape"][3] == 80 else 2  # resblock2d_packed: the 80-row calls
        elif c["kernel"] == "mrf_stage":
            row = 7
        else:
            row = {("downsample2d", 64): 3, ("downsample2d", 128): 4,
                   ("conv_transpose2d", 128): 5,
                   ("conv_transpose2d", 64): 6}[(c["kernel"], c["shape"][1])]
        k = 1 if row == 7 else N_STEPS
        r = rows16.setdefault(row, dict(kernel=c["kernel"], calls_per_evaluation=0, ms=0.0,
                                        device_ms=0.0, bound_ms=0.0, f32_ms=0.0,
                                        f32_device_ms=0.0))
        r["calls_per_evaluation"] += 1
        for key in ("ms", "bound_ms", "f32_ms"):
            r[key] += k * c[key]
        r["device_ms"] += k * c["device_ms_per_call"]
        r["f32_device_ms"] += k * (c["f32_device_ms"] or 0.0)
        if c["library_bf16_ms"] is not None:  # rows 3-6: F.conv2d / F.conv_transpose2d in bf16
            r["library_bf16_ms"] = r.get("library_bf16_ms", 0.0) + k * c["library_bf16_ms"]
            r["library_bf16_device_ms"] = (r.get("library_bf16_device_ms", 0.0)
                                           + k * c["library_bf16_device_ms"])
    emit({"bf16_rows_per_request": {"card": card, "steps": N_STEPS, "rows": rows16,
                                    "phase_s": time.perf_counter() - t3b}})

    # ---- 4. the score network: kernel path against the module path --------
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.infer import sampler
    from arttts_tpu_torch.models.hifigan import build_vocoder, hifigan_forward_fast
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d, GroupNorm
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn, masked_statistics

    cfg = get_preset("v2").model
    model = build_model(cfg, device=dev, seed=0)
    est = model.decoder.estimator
    sites = [lv[2] for lv in est.downs] + [est.mid_attn] + [u[2] for u in est.ups]
    with torch.no_grad():
        # Rezero gains start at 0, which would silence every attention site
        for k, site in enumerate(sites):
            site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        # durations: each symbol gets ceil(2.5) = 3 frames, so the requests
        # below land in chosen buckets
        model.encoder.proj_w.proj.weight.zero_()
        model.encoder.proj_w.proj.bias.fill_(math.log(2.5))
    vocoder = build_vocoder(device=dev, seed=1)
    F_ = cfg.n_feats

    score_checks = []
    with torch.inference_mode():
        for T, L in ((768, 768), (128, 100)):
            xt, mu = rnd(1, T, F_), rnd(1, T, F_)
            mask = (torch.arange(T, device=dev) < L).float()[None, :, None]
            t = torch.full((1,), 0.37, device=dev)
            fast = make_score_fn(model, T)
            got = fast(xt, mask, mu, t)
            ref = model.estimate_noise(xt, mask, mu, t)
            torch.cuda.synchronize()
            err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= TOL_SCORE * max(1.0, scale)
            score_checks.append(dict(T=T, length=L, max_abs_err=err, max_abs_ref=scale,
                                     tol=TOL_SCORE, ok=ok,
                                     kernel_ms=cuda_ms(lambda: fast(xt, mask, mu, t), n=5),
                                     plain_ms=cuda_ms(
                                         lambda: model.estimate_noise(xt, mask, mu, t), n=5)))
    emit({"score_network": score_checks})
    if not all(c["ok"] for c in score_checks):
        fail("score network: kernel path disagrees with the module path")

    # the v6 estimator at full width with the speaker plane (16 rows, c_in 3
    # at ResnetBlock2d_0): bucket 256 takes masked statistics, 128 not. The
    # module path computes what the kernel path does at each bucket: its
    # GroupNorms take masked statistics where `masked_statistics` says so
    # (eps stays v6's 1e-6), as the JAX package's TPU kernels do there
    artic = build_model(get_preset("v6").model, device=dev, seed=3)
    est_a = artic.decoder.estimator
    with torch.no_grad():
        for k, site in enumerate([lv[2] for lv in est_a.downs] + [est_a.mid_attn]
                                 + [u[2] for u in est_a.ups]):
            site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
    spk_checks = []
    with torch.inference_mode():
        for T, L in ((256, 181), (128, 100)):
            xt, mu, spk = rnd(1, T, 16), rnd(1, T, 16), rnd(1, 1024)
            mask = (torch.arange(T, device=dev) < L).float()[None, :, None]
            t = torch.full((1,), 0.37, device=dev)
            fast = make_score_fn(artic, T)
            module = copy.deepcopy(artic)
            for gn in module.modules():
                if isinstance(gn, GroupNorm):
                    gn.masked = masked_statistics(artic.config, T)
            got = fast(xt, mask, mu, t, spk)
            ref = module.estimate_noise(xt, mask, mu, t, spk)
            torch.cuda.synchronize()
            err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= TOL_SCORE * max(1.0, scale)
            spk_checks.append(dict(preset="v6", T=T, length=L, rows=16,
                                   masked_stats=masked_statistics(artic.config, T),
                                   max_abs_err=err, max_abs_ref=scale, tol=TOL_SCORE, ok=ok,
                                   kernel_ms=cuda_ms(lambda: fast(xt, mask, mu, t, spk), n=5),
                                   plain_ms=cuda_ms(
                                       lambda: module.estimate_noise(xt, mask, mu, t, spk), n=5)))
    emit({"score_network_speaker": spk_checks})
    if not all(c["ok"] for c in spk_checks) or [c["masked_stats"] for c in spk_checks] != [
            True, False]:
        fail("score network with the speaker plane: kernel path disagrees with the module path")

    # ---- 4b. the vocoder alone: fast path (K4, K5) against the module path ----
    voc_checks = []
    with torch.inference_mode():
        for T in (128, 384, 768):
            mel = rnd(1, T, F_)
            fast = lambda: hifigan_forward_fast(vocoder, mel)  # noqa: E731
            module = lambda: vocoder(mel)  # noqa: E731
            got, ref = fast(), module()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ok = (tuple(got.shape) == (1, T * 256, 1) and bool(torch.isfinite(got).all())
                  and err <= TOL_VOC)
            voc_checks.append(dict(frames=T, max_abs_err=err, tol=TOL_VOC, ok=ok,
                                   fast_ms=cuda_ms(fast, n=5), module_ms=cuda_ms(module, n=5)))
    emit({"vocoder": {"card": card, "checks": voc_checks}})
    if not all(c["ok"] for c in voc_checks):
        fail("vocoder: fast path disagrees with the module path")

    # ---- 5. a short request on the card against the CPU --------------------
    rng_text = torch.Generator().manual_seed(7)
    x_small = torch.randint(1, cfg.encoder.n_vocab, (1, 30), generator=rng_text)
    small_kw = dict(n_timesteps=4, max_frames=128, temperature=1e6)
    wav_gpu, yl_gpu = sampler.synthesize_to_wav(
        model, vocoder, torch.Generator(device=dev).manual_seed(0), x_small,
        torch.tensor([30]), device=dev, **small_kw)
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_voc = build_vocoder(device="cpu")
    cpu_voc.load_state_dict(vocoder.state_dict())
    wav_cpu, yl_cpu = sampler.synthesize_to_wav(
        cpu_model, cpu_voc, torch.Generator().manual_seed(0), x_small, torch.tensor([30]),
        device="cpu", **small_kw)
    err = (wav_gpu.cpu() - wav_cpu).abs().max().item()
    ref_check = dict(frames=int(yl_gpu[0]), wav_shape=list(wav_gpu.shape), max_abs_err=err,
                     tol=TOL_WAV, steps=small_kw["n_timesteps"],
                     ok=bool(torch.isfinite(wav_gpu).all()) and err <= TOL_WAV
                     and int(yl_gpu[0]) == int(yl_cpu[0]) == 90)
    emit({"card_vs_cpu_request": ref_check})
    if not ref_check["ok"]:
        fail("text -> wav on the card disagrees with the CPU plain path")

    # ---- 6. the main path ----------------------------------------------------
    hop, sr = 256, 22050
    rng_np = torch.Generator().manual_seed(0)
    requests = [("serve", 30), ("serve", 100), ("serve", 200), ("bench", 96)]
    texts = [torch.randint(1, cfg.encoder.n_vocab, (1, n), generator=rng_np)
             for _, n in requests]
    gen = torch.Generator(device=dev).manual_seed(1)
    # warm-up request (allocator, cuDNN plans for the vocoder), not counted
    sampler.serve_text_to_wav(model, vocoder, gen, texts[0], torch.tensor([30]), n_timesteps=2,
                              device=dev)
    torch.cuda.synchronize()

    counters = [K1.resblock2d, updown.downsample2d, updown.conv_transpose2d, K4.mrf_stage,
                K5.upsample1d]
    plains = [K1.resblock2d_plain, updown.downsample2d_plain, updown.conv_transpose2d_plain,
              K4.mrf_stage_plain, K5.upsample1d_plain]
    for f in counters + plains:
        setattr(f, "launches" if f in counters else "cuda_calls", 0)
    GradLogPEstimator2d.cuda_calls = 0
    K1.resblock2d.wgmma_launches = 0

    served = []
    for (kind, n), x in zip(requests, texts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "serve":
            wav, yl, bucket = sampler.serve_text_to_wav(
                model, vocoder, gen, x, torch.tensor([n]), n_timesteps=N_STEPS, device=dev)
        else:
            bucket = 768
            wav, yl = sampler.synthesize_to_wav(
                model, vocoder, gen, x, torch.tensor([n]), n_timesteps=N_STEPS,
                max_frames=bucket, x_durations=torch.full((1, n), bucket / n), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = (tuple(wav.shape) == (1, bucket * hop, 1) and bool(torch.isfinite(wav).all())
              and 1 <= int(yl[0]) <= bucket and float(wav.abs().max()) <= 1.0)
        served.append(dict(entry=("serve_text_to_wav" if kind == "serve"
                                  else "synthesize_to_wav"), T_x=n, bucket=bucket,
                           frames=int(yl[0]), wav_samples=wav.shape[1], steps=N_STEPS,
                           wall_s=wall, rtf=wall / (bucket * hop / sr), ok=ok))
    launches = {f.__name__: f.launches for f in counters}
    plain_on_card = {f.__name__: f.cuda_calls for f in plains}
    plain_on_card["GradLogPEstimator2d"] = GradLogPEstimator2d.cuda_calls
    # K1 calls with a 3x3 product on the `wgmma` route: as many as the
    # route rule gives the requests' buckets
    wgmma_want = N_STEPS * sum(k1_wgmma_calls(K1, 1, cfg.n_feats, 2, r["bucket"], n_sm)
                               for r in served)
    emit({"main_path": {"card": card, "requests": served, "launches": launches,
                        "wgmma_launches": K1.resblock2d.wgmma_launches,
                        "wgmma_launches_expected": wgmma_want,
                        "plain_calls_on_card": plain_on_card}})
    if not all(r["ok"] for r in served):
        fail("a served request gave a wrong or non-finite waveform")
    if sorted(r["bucket"] for r in served[:3]) != [128, 384, 768]:
        fail(f"served buckets {[r['bucket'] for r in served[:3]]}, expected 128, 384, 768")
    n_eval = N_STEPS * len(requests)
    # per request: 3 MRF stages with C <= 128 and 2 stride-2 upsamples
    want = {"resblock2d": 13 * n_eval, "downsample2d": 2 * n_eval,
            "conv_transpose2d": 2 * n_eval, "mrf_stage": 3 * len(requests),
            "upsample1d": 2 * len(requests)}
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    if any(plain_on_card.values()):
        fail(f"a plain version ran on the card in the main path: {plain_on_card}")
    if not 0 < K1.resblock2d.wgmma_launches == wgmma_want:
        fail(f"K1 calls on the wgmma route {K1.resblock2d.wgmma_launches}, expected {wgmma_want}")

    # ---- 6b. the main path in bf16: the same four requests with kernel_bf16 ----
    t6b = time.perf_counter()
    counters16 = counters[:4]  # K1-K4 have a bf16 mode; K5 has none
    for f in counters + plains:
        setattr(f, "launches" if f in counters else "cuda_calls", 0)
    for f in counters16:
        f.bf16_launches = 0
    GradLogPEstimator2d.cuda_calls = 0
    K1.resblock2d.wgmma_launches = 0
    gen16 = torch.Generator(device=dev).manual_seed(2)
    served16 = []
    for (kind, n), x in zip(requests, texts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "serve":
            wav, yl, bucket = sampler.serve_text_to_wav(
                model, vocoder, gen16, x, torch.tensor([n]), n_timesteps=N_STEPS, device=dev,
                kernel_bf16=True)
        else:
            bucket, bench_state = 768, gen16.get_state()
            wav, yl = sampler.synthesize_to_wav(
                model, vocoder, gen16, x, torch.tensor([n]), n_timesteps=N_STEPS,
                max_frames=bucket, x_durations=torch.full((1, n), bucket / n), device=dev,
                kernel_bf16=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = (tuple(wav.shape) == (1, bucket * hop, 1) and bool(torch.isfinite(wav).all())
              and 1 <= int(yl[0]) <= bucket and float(wav.abs().max()) <= 1.0)
        served16.append(dict(entry=("serve_text_to_wav" if kind == "serve"
                                    else "synthesize_to_wav"), T_x=n, bucket=bucket,
                             frames=int(yl[0]), steps=N_STEPS, wall_s=wall,
                             rtf=wall / (bucket * hop / sr), ok=ok))
    launches16 = {f.__name__: f.launches for f in counters}
    bf16_launches = {f.__name__: f.bf16_launches for f in counters16}
    wgmma16 = K1.resblock2d.wgmma_launches  # before the float32 request below
    plain16 = {f.__name__: f.cuda_calls for f in plains}
    plain16["GradLogPEstimator2d"] = GradLogPEstimator2d.cuda_calls
    # the bench request in float32 from the same draws: how far the mode moves the wav
    gen32 = torch.Generator(device=dev)
    gen32.set_state(bench_state)
    x, n = texts[-1], requests[-1][1]
    wav32, _ = sampler.synthesize_to_wav(model, vocoder, gen32, x, torch.tensor([n]),
                                         n_timesteps=N_STEPS, max_frames=768,
                                         x_durations=torch.full((1, n), 768 / n), device=dev)
    bf16_vs_f32 = (wav - wav32).abs().max().item()
    # phase 5's request (same weights, temperature 1e6: z = mu) with kernel_bf16,
    # the card's kernels against the CPU's plain bf16 versions
    w16_gpu, _ = sampler.synthesize_to_wav(
        model, vocoder, torch.Generator(device=dev).manual_seed(0), x_small, torch.tensor([30]),
        device=dev, kernel_bf16=True, **small_kw)
    w16_cpu, _ = sampler.synthesize_to_wav(
        cpu_model, cpu_voc, torch.Generator().manual_seed(0), x_small, torch.tensor([30]),
        device="cpu", kernel_bf16=True, **small_kw)
    err16 = (w16_gpu.cpu() - w16_cpu).abs().max().item()
    # the check must tell the modes apart: its tolerance below the CPU's own
    # bf16-vs-float32 distance on this request, and the card's float32
    # request outside it
    cpu_check = dict(steps=small_kw["n_timesteps"], max_abs_err=err16, tol=TOL_WAV_BF16,
                     vs_f32_request=(w16_gpu - wav_gpu).abs().max().item(),
                     cpu_bf16_vs_f32=(w16_cpu - wav_cpu).abs().max().item(),
                     f32_request_vs_cpu_bf16=(wav_gpu.cpu() - w16_cpu).abs().max().item())
    cpu_check["ok"] = (bool(torch.isfinite(w16_gpu).all()) and err16 <= TOL_WAV_BF16
                       < min(cpu_check["cpu_bf16_vs_f32"], cpu_check["f32_request_vs_cpu_bf16"]))
    emit({"main_path_bf16": {"card": card, "requests": served16, "launches": launches16,
                             "bf16_launches": bf16_launches,
                             "wgmma_launches": wgmma16, "plain_calls_on_card": plain16,
                             "bench_wav_bf16_vs_f32_max_abs": bf16_vs_f32,
                             "card_vs_cpu_request": cpu_check,
                             "phase_s": time.perf_counter() - t6b}})
    if not all(r["ok"] for r in served16):
        fail("bf16: a served request gave a wrong or non-finite waveform")
    if launches16 != want or bf16_launches != {k: want[k] for k in bf16_launches}:
        fail(f"bf16: launch counts {launches16}, in the bf16 mode {bf16_launches}, "
             f"expected {want} and all of K1-K4's in the bf16 mode")
    if any(plain16.values()):
        fail(f"bf16: a plain version ran on the card in the main path: {plain16}")
    if wgmma16:
        fail(f"bf16: {wgmma16} K1 calls took the float32 wgmma route")
    if not cpu_check["ok"]:
        fail(f"bf16: the request on the card disagrees with the CPU's plain bf16 versions: "
             f"{cpu_check}")

    # ---- 7. where the time goes: one bench-shape request under the profiler --
    from arttts_tpu_torch.utils import profiling, trace_analysis

    x, n = texts[-1], requests[-1][1]
    trace_dir = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profiling.trace(str(trace_dir)) as prof:
        t0 = time.perf_counter()
        sampler.synthesize_to_wav(model, vocoder, gen, x, torch.tensor([n]),
                                  n_timesteps=N_STEPS, max_frames=768,
                                  x_durations=torch.full((1, n), 768 / n), device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel time by the port's kernel it belongs to; the rest is PyTorch's
    # own (cuDNN convolutions, GEMVs, elementwise)
    k1_parts = {"3x3 conv": ("conv3x3_kernel",), "1x1 products": ("conv1x1_kernel",),
                "GroupNorm stats": ("gn_stats_kernel",), "GroupNorm apply": ("gn_act_kernel",),
                "attention core": ("attn_",)}
    families = {"K1 resblock2d": sum(k1_parts.values(), ()),
                "K2 downsample2d": ("downsample_kernel",), "K3 conv_transpose2d": ("convt_kernel",),
                "K4 mrf_stage": ("mrf_round_kernel",), "K5 upsample1d": ("upsample_kernel",)}

    def kernel_time(prof):
        """(device ms and count by kernel name, busy ms, ms and launches by family)."""
        by_name = {}
        for a in prof.key_averages():
            if device_kernel(a) and a.self_device_time_total > 0:
                by_name[a.key] = (a.self_device_time_total / 1e3, a.count)
        by_family = dict.fromkeys(list(families) + ["other"], 0.0)
        calls = dict.fromkeys(list(families) + ["other"], 0)
        for k, (ms, c) in by_name.items():
            fam = [f for f, keys in families.items() if any(key in k for key in keys)]
            by_family[fam[0] if fam else "other"] += ms
            calls[fam[0] if fam else "other"] += c
        return by_name, sum(ms for ms, _ in by_name.values()), by_family, calls

    by_name, busy, by_family, calls = kernel_time(prof)
    # the same profile written as a Chrome trace and read back by
    # utils/trace_analysis: the busy union and the families' device time must
    # agree with the sums above within 1% (one stream: a union is a sum)
    t_read = time.perf_counter()
    helper_busy = trace_analysis.device_busy_seconds(str(trace_dir)) * 1e3
    helper_fam = trace_analysis.grouped_report(str(trace_dir), families)
    trace_check = dict(file=Path(trace_analysis._latest_trace_file(str(trace_dir))).name,
                       device_events=len(trace_analysis.load_device_events(str(trace_dir))),
                       read_s=time.perf_counter() - t_read, device_busy_ms=helper_busy,
                       device_kernel_ms=busy, busy_rel_diff=abs(helper_busy - busy) / busy,
                       kernel_ms_by_family=helper_fam,
                       family_rel_diff={f: abs(helper_fam[f] - ms) / ms
                                        for f, ms in by_family.items() if ms})
    shutil.rmtree(trace_dir, ignore_errors=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    k1_by_part = {part: dict(ms=0.0, launches_per_evaluation=0.0) for part in k1_parts}
    for k, (ms, c) in by_name.items():
        part = [f for f, keys in k1_parts.items() if any(key in k for key in keys)]
        if part:
            k1_by_part[part[0]]["ms"] += ms
            k1_by_part[part[0]]["launches_per_evaluation"] += c / N_STEPS
    # the 3x3 part by route (the `wgmma` kernels are `conv3x3_kernel`s of
    # a `WgmmaTile`), an evaluation's time beside its 3xTF32 bound
    conv = k1_by_part["3x3 conv"]
    for route, mark in (("wgmma", True), ("mma_sync", False)):
        conv[route] = dict(ms=0.0, launches_per_evaluation=0.0)
        for k, (ms, c) in by_name.items():
            if "conv3x3_kernel" in k and ("WgmmaTile" in k) == mark:
                conv[route]["ms"] += ms
                conv[route]["launches_per_evaluation"] += c / N_STEPS
    conv["ms_per_evaluation"] = conv["ms"] / N_STEPS
    conv["bound_ms_per_evaluation"] = 3 * sum(
        2 * 9 * c_in * c_out * H * T for c_in, c_out, H, T, _ in
        k1_products(cfg.n_feats, 2, 768)) / PEAK_TF32_FLOPS * 1e3
    emit({"trace": {"card": card, "request": "bench shape, 768 frames, 50 steps",
                    "wall_ms_under_profiler": wall_ms, "device_kernel_ms": busy,
                    "idle_share": (1 - busy / wall_ms) if busy else None,
                    "kernel_ms_by_family": by_family,
                    "k1_by_part": k1_by_part,
                    # K2 and K3: 100 launches each per request (2 per evaluation)
                    "device_ms_per_call": {f: by_family[f] / calls[f] for f in
                                           ("K2 downsample2d", "K3 conv_transpose2d")
                                           if calls[f]},
                    "kernels_by_time": [{"name": k[:90], "ms": ms, "count": c}
                                        for k, (ms, c) in top],
                    "trace_analysis": trace_check}})
    if trace_check["busy_rel_diff"] > 0.01:
        fail(f"trace: device_busy_seconds {helper_busy} ms against the profiler's {busy} ms")
    if (helper_fam.keys() != by_family.keys() or any(not ms and helper_fam[f] for f, ms in
                                                     by_family.items())
            or max(trace_check["family_rel_diff"].values()) > 0.01):
        fail(f"trace: grouped_report {helper_fam} against kernel_ms_by_family {by_family}")

    # ---- 7b. where the time goes in bf16: the bench-shape request and a B=4
    # decode at bucket 384 under the profiler, float32 then bf16 ------------
    t7b = time.perf_counter()
    x, n = texts[-1], requests[-1][1]

    def profiled(run):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _, busy, fam, calls = kernel_time(prof)
        return dict(wall_ms_under_profiler=wall, device_kernel_ms=busy,
                    idle_share=1 - busy / wall, kernel_ms_by_family=fam,
                    launches_by_family=calls)

    B4, T4, steps4 = 4, 384, 10
    z4, mu4 = rnd(B4, T4, F_), rnd(B4, T4, F_)
    mask4 = (torch.arange(T4, device=dev)[None, :]
             < torch.tensor([384, 350, 301, 256], device=dev)[:, None]).float()[..., None]
    trace16 = {}
    for mode, kb in (("float32", False), ("bf16", True)):
        req = profiled(lambda: sampler.synthesize_to_wav(
            model, vocoder, torch.Generator(device=dev).manual_seed(3), x, torch.tensor([n]),
            n_timesteps=N_STEPS, max_frames=768, x_durations=torch.full((1, n), 768 / n),
            device=dev, kernel_bf16=kb))
        sampler.reverse_diffusion(model, z4, mask4, mu4, 2, kernel_bf16=kb)  # warm-up
        dec = profiled(lambda: sampler.reverse_diffusion(model, z4, mask4, mu4, steps4,
                                                         kernel_bf16=kb))
        fam = dec["kernel_ms_by_family"]
        trace16[mode] = dict(
            request=req, k1_k4_device_ms_per_request=sum(
                req["kernel_ms_by_family"][f] for f in list(families)[:4]),
            b4_decode=dict(dec, evaluations=steps4, device_ms_per_evaluation=dec[
                "device_kernel_ms"] / steps4, k1_k3_device_ms_per_evaluation=sum(
                    fam[f] for f in list(families)[:3]) / steps4,
                wall_ms_per_evaluation=dec["wall_ms_under_profiler"] / steps4))
    emit({"trace_bf16": {"card": card, "request": "bench shape, 768 frames, 50 steps",
                         "b4_decode": f"B={B4}, bucket {T4}, {steps4} Euler steps",
                         "modes": trace16, "phase_s": time.perf_counter() - t7b}})

    # ---- 8. the SPARC articulatory vocoder ------------------------------------
    from arttts_tpu_torch.infer.chunked import vocode_chunked, vocode_sparc
    from arttts_tpu_torch.models.hifigan import build_sparc_vocoder

    sparc = build_sparc_vocoder(device=dev, seed=2)  # 14 in, 512 ch, (8, 8, 2, 2), spk_ft 1024
    g_cpu = torch.Generator().manual_seed(3)
    spk_ft = torch.randn(1024, generator=g_cpu).numpy()

    def track(T):
        c = torch.randn(T, 14, generator=g_cpu)
        c[:, 12] = 120 + 30 * c[:, 12]  # pitch in Hz
        return c.numpy()

    # warm-up of both paths at both batch shapes (allocator, cuDNN plans)
    for T in (100, 1000):
        vocode_sparc(sparc, track(T), spk_ft, device=dev)
        with torch.inference_mode():
            vocode_chunked(lambda c, s: sparc(c, s), track(T), spk=spk_ft, device=dev)
    sparc_runs = []
    for T, how in ((1500, "windows"), (400, "two placements")):
        feats = track(T)
        for f in (K4.mrf_stage, K5.upsample1d):
            f.launches = 0
        K4.mrf_stage.film_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = vocode_sparc(sparc, feats, spk_ft, device=dev)
        fast_s = time.perf_counter() - t0
        counts = dict(mrf_stage=K4.mrf_stage.launches, film=K4.mrf_stage.film_launches,
                      upsample1d=K5.upsample1d.launches)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = vocode_chunked(lambda c, s: sparc(c, s), feats, spk=spk_ft, device=dev)
        module_s = time.perf_counter() - t0
        err = float(abs(wav - ref).max())
        finite = bool(torch.isfinite(torch.from_numpy(wav)).all())
        ok = (wav.shape == (T * 256,) and finite and float(abs(wav).max()) <= 1.0
              and err <= TOL_VOC and counts == dict(mrf_stage=3, film=3, upsample1d=2))
        sparc_runs.append(dict(frames=T, path=how, wav_samples=int(wav.shape[0]),
                               max_abs_err=err, tol=TOL_VOC, launches=counts,
                               fast_wall_s=fast_s, module_wall_s=module_s,
                               rtf=fast_s / (T * 256 / 16000), ok=ok))
    emit({"sparc": {"card": card, "entry": "vocode_sparc (vocode_chunked + "
                    "spk_sparc_forward_fast), chunk 512, halo 32, win_batch 8",
                    "runs": sparc_runs}})
    if not all(r["ok"] for r in sparc_runs):
        fail("SPARC: the fast path disagrees with the module path or skipped a kernel")

    # ---- 8b. artic_ms: the v6 preset, VoxCommunis phones -> SPARC wav ---------
    from arttts_tpu_torch.audio.io import load_wav, save_wav
    from arttts_tpu_torch.data.ms_datasets import MsPhnmDataset
    from arttts_tpu_torch.infer import pipeline
    from arttts_tpu_torch.infer.chunked import HOP
    from arttts_tpu_torch.voxcommunis.data import FeatureTokenizer
    from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder
    from arttts_tpu_torch.voxcommunis.io import write_manifest

    exp_a = get_preset("v6")
    art_dir = ROOT / "build" / "chip_smoke_artic"
    shutil.rmtree(art_dir, ignore_errors=True)
    r = np.random.default_rng(9)
    frames = (120, 231, 480)  # aligned frames: buckets 128 (unmasked), 256 (padded), 512
    phones = ["a", "t", "t͡ʃ", "aɪ", "kʰ", "ɛ", "ŋ", "ʃ", "i", "o", "u", "m", "n", "s", "SIL"]
    (art_dir / "wavs").mkdir(parents=True)
    spk_dir = art_dir / "encoded_audio_multi" / "ab" / "spk_preemb"
    spk_dir.mkdir(parents=True)
    lines = []
    for i, n in enumerate(frames):
        fid = f"cv_ab_ab_{i:04d}"
        save_wav(art_dir / "wavs" / f"{fid}.wav", r.standard_normal(1600) * 0.1, 16000)
        np.save(spk_dir / f"{fid}.npy", r.standard_normal(1024).astype(np.float32))
        seq, left = [], 2 * n  # 100 Hz alignment frames, downsampled to 50 Hz by the dataset
        while left:
            k = min(left, 2 * int(r.integers(2, 9)))
            seq += [str(r.choice(phones))] * k
            left -= k
        lines.append(f"{fid}\t{' '.join(seq)}")
    write_manifest(art_dir / "wavs", art_dir / "man.tsv")
    (art_dir / "align.align").write_text("\n".join(lines) + "\n")
    ms_ds = MsPhnmDataset(art_dir, art_dir / "man.tsv", art_dir / "align.align",
                          FeatureTokenizer(FeatureDecoder(sum_diphthong=True)))

    class One:
        """One utterance of `ms_ds` as a dataset of its own (timed alone)."""

        def __init__(self, i):
            self.manifest = [ms_ds.manifest[i]]
            self.item = ms_ds[i]

        def __len__(self):
            return 1

        def __getitem__(self, _):
            return self.item

    spk_ft = ms_ds[0]["spk"]
    stats = dict(pitch_stats=(140.0, 30.0))
    # warm-up (allocator, cuDNN plans of the encoder), not counted
    pipeline.run_acoustic_inference(exp_a, artic, One(0), str(art_dir / "warm"),
                                    n_timesteps=2, use_align=True, device=dev)
    for f in counters + plains:
        setattr(f, "launches" if f in counters else "cuda_calls", 0)
    GradLogPEstimator2d.cuda_calls = 0
    utts = []
    for i, n in enumerate(frames):
        one = One(i)
        bucket = sampler.frame_bucket(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (path,) = pipeline.run_acoustic_inference(exp_a, artic, one, str(art_dir / "art"),
                                                  n_timesteps=N_STEPS, use_align=True,
                                                  device=dev)
        torch.cuda.synchronize()
        acoustic_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (wav_path,) = pipeline.run_sparc_vocoder(sparc, [path], spk_ft, str(art_dir / "wav"),
                                                 device=dev, **stats)
        torch.cuda.synchronize()
        vocoder_s = time.perf_counter() - t0
        arr = np.load(path)
        wav, sr = load_wav(wav_path)
        L = int(np.ceil(one.item["durations"]).sum())
        imap = arr[28]
        ok = (arr.shape == (29, L) and L == n and bool(np.isfinite(arr).all())
              and np.array_equal(imap, np.round(imap)) and imap.min() >= 0
              and imap.max() < one.item["x"].shape[0] and sr == 16000
              and wav.shape == (L * HOP,) and bool(np.isfinite(wav).all()))
        utts.append(dict(file=Path(path).name, T_x=int(one.item["x"].shape[0]), frames=L,
                         bucket=bucket, masked_stats=masked_statistics(artic.config, bucket),
                         artifact_shape=list(arr.shape), wav_samples=int(wav.shape[0]),
                         steps=N_STEPS, acoustic_wall_s=acoustic_s, vocoder_wall_s=vocoder_s,
                         acoustic_rtf=acoustic_s / (L / 50), rtf=(acoustic_s + vocoder_s)
                         / (L * HOP / 16000), ok=ok))
    art_launches = {f.__name__: f.launches for f in counters}
    # where the time goes: the 480-frame utterance's acoustic stage again, profiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.run_acoustic_inference(exp_a, artic, One(2), str(art_dir / "prof"),
                                        n_timesteps=N_STEPS, use_align=True, device=dev)
        torch.cuda.synchronize()
        art_wall_ms = (time.perf_counter() - t0) * 1e3
    _, art_busy, art_family, art_calls = kernel_time(prof)
    art_trace = dict(utterance="480 frames, bucket 512, 50 steps, acoustic stage",
                     wall_ms_under_profiler=art_wall_ms, device_kernel_ms=art_busy,
                     idle_share=1 - art_busy / art_wall_ms, kernel_ms_by_family=art_family,
                     launches_by_family=art_calls,
                     k1_k2_k3_device_ms_per_evaluation=sum(
                         art_family[f] for f in list(families)[:3]) / N_STEPS)
    art_plain = {f.__name__: f.cuda_calls for f in plains}
    art_plain["GradLogPEstimator2d"] = GradLogPEstimator2d.cuda_calls
    W = 512 + 2 * 32  # vocode_chunked's window (chunk 512, halo 32); 8 windows a batch
    voc_calls = sum(1 if n <= W else math.ceil(math.ceil(n / 512) / 8) for n in frames)
    want_art = {"resblock2d": 13 * N_STEPS * len(frames),
                "downsample2d": 2 * N_STEPS * len(frames),
                "conv_transpose2d": 2 * N_STEPS * len(frames),
                "mrf_stage": 3 * voc_calls, "upsample1d": 2 * voc_calls}
    emit({"artic_ms": {"card": card, "preset": "v6", "entry": "infer/pipeline.py: "
                       "run_acoustic_inference(use_align=True) + run_sparc_vocoder",
                       "utterances": utts, "trace": art_trace, "launches": art_launches,
                       "expected_launches": want_art, "plain_calls_on_card": art_plain}})
    if not all(u["ok"] for u in utts):
        fail("artic_ms: a wrong artifact or waveform")
    if [u["bucket"] for u in utts] != [128, 256, 512] or [
            u["masked_stats"] for u in utts] != [False, True, True]:
        fail(f"artic_ms: buckets {[u['bucket'] for u in utts]}, expected 128, 256, 512")
    if art_launches != want_art:
        fail(f"artic_ms: launch counts {art_launches}, expected {want_art}")
    if any(art_plain.values()):
        fail(f"artic_ms: a plain version ran on the card: {art_plain}")

    # ---- 8c. card_vs_cpu_artic: the 120-frame utterance, card against CPU ------
    cpu_artic = build_model(artic.config, device="cpu")
    cpu_artic.load_state_dict(artic.state_dict())
    short = dict(n_timesteps=4, temperature=1e6, use_align=True)
    (p_gpu,) = pipeline.run_acoustic_inference(exp_a, artic, One(0), str(art_dir / "gpu"),
                                               device=dev, **short)
    (p_cpu,) = pipeline.run_acoustic_inference(exp_a, cpu_artic, One(0), str(art_dir / "cpu"),
                                               device="cpu", **short)
    a_gpu, a_cpu = np.load(p_gpu), np.load(p_cpu)
    err = float(np.abs(a_gpu - a_cpu).max()) if a_gpu.shape == a_cpu.shape else math.inf
    artic_check = dict(frames=int(a_gpu.shape[1]), steps=4, max_abs_err=err, tol=TOL_WAV,
                       input_map_equal=bool(np.array_equal(a_gpu[28], a_cpu[28])),
                       ok=a_gpu.shape == a_cpu.shape == (29, 120) and err <= TOL_WAV)
    emit({"card_vs_cpu_artic": artic_check})
    shutil.rmtree(art_dir, ignore_errors=True)
    if not artic_check["ok"]:
        fail("the articulatory artifact on the card disagrees with the CPU plain path")
    del cpu_artic

    # ---- 8d. the bf16 decoder: v2 with compute_dtype="bfloat16", module path ----
    t8d = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                 compute_dtype="bfloat16"))
    dec16 = {}
    for where, d, voc in (("card", dev, vocoder), ("cpu", "cpu", cpu_voc)):
        m16 = build_model(cfg16, device=d)
        m16.load_state_dict(model.state_dict())
        for f in counters + plains:
            setattr(f, "launches" if f in counters else "cuda_calls", 0)
        GradLogPEstimator2d.cuda_calls = 0
        gen_d = torch.Generator(device=d).manual_seed(0)
        t0 = time.perf_counter()
        w16, yl16 = sampler.synthesize_to_wav(m16, voc, gen_d, x_small, torch.tensor([30]),
                                              device=d, **small_kw)
        if where == "card":
            torch.cuda.synchronize()
        dec16[where] = dict(wav=w16.cpu(), frames=int(yl16[0]), wall_s=time.perf_counter() - t0,
                            launches={f.__name__: f.launches for f in counters},
                            module_forwards_on_card=GradLogPEstimator2d.cuda_calls)
        del m16
    err_dec = (dec16["card"]["wav"] - dec16["cpu"]["wav"]).abs().max().item()
    # as in 6b: the tolerance below the CPU's bf16-vs-float32 distance, and
    # the card's float32 request outside it
    dec_vs = dict(cpu_bf16_vs_f32=(dec16["cpu"]["wav"] - wav_cpu).abs().max().item(),
                  f32_request_vs_cpu_bf16=(wav_gpu.cpu() - dec16["cpu"]["wav"]).abs().max().item())
    dec_check = dict(
        frames=dec16["card"]["frames"], steps=small_kw["n_timesteps"], max_abs_err=err_dec,
        tol=TOL_DEC_BF16, vs_f32_request=(dec16["card"]["wav"] - wav_gpu.cpu()).abs().max().item(),
        **dec_vs, launches_card=dec16["card"]["launches"],
        module_forwards_on_card=dec16["card"]["module_forwards_on_card"],
        walls_s={k: v["wall_s"] for k, v in dec16.items()},
        ok=bool(torch.isfinite(dec16["card"]["wav"]).all())
        and err_dec <= TOL_DEC_BF16 < min(dec_vs.values())
        and dec16["card"]["frames"] == dec16["cpu"]["frames"] == 90
        and all(dec16["card"]["launches"][k] == 0
                for k in ("resblock2d", "downsample2d", "conv_transpose2d"))
        and dec16["card"]["module_forwards_on_card"] == small_kw["n_timesteps"],
        phase_s=time.perf_counter() - t8d)
    emit({"bf16_decoder": {"card": card, "preset": "v2, compute_dtype=bfloat16",
                           "check": dec_check}})
    if not dec_check["ok"]:
        fail(f"bf16 decoder: card against CPU, or a kernel ran: {dec_check}")

    # ---- 9. training: the v2 preset through the port's Trainer --------------
    from arttts_tpu_torch.train import trainer as trainer_mod
    from arttts_tpu_torch.train.losses import mas_log_prior
    from arttts_tpu_torch.train.step import make_optimizer, train_step
    from arttts_tpu_torch.train.trainer import Trainer

    exp = get_preset("v2")
    log_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(log_dir, ignore_errors=True)
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, log_dir=str(log_dir), n_epochs=1, save_every=1, val_every=1, random_seed=0))
    train_ds = SyntheticPairs(48, 10, F_, n_vocab=cfg.encoder.n_vocab)  # LJSpeech's shape at v2
    valid_ds = SyntheticPairs(16, 11, F_, n_vocab=cfg.encoder.n_vocab)
    trainer = Trainer(exp, train_ds, valid_dataset=valid_ds, device=dev)
    first = [p.detach().clone() for p in trainer.model.parameters()]
    step_walls = []

    def timed_step(*a, **k):  # host clock around a step that ends in a sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(*a, **k)
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
        return m

    for f in counters + plains + [K6.maximum_path, K6.maximum_path_plain]:
        setattr(f, "launches" if f in counters or f is K6.maximum_path else "cuda_calls", 0)
    GradLogPEstimator2d.cuda_calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer_mod.train_step = timed_step
    t0 = time.perf_counter()
    try:
        train_metrics = trainer.fit(n_epochs=1)
        torch.cuda.synchronize()
    finally:
        trainer_mod.train_step = train_step
    fit_s = time.perf_counter() - t0
    train_launches = {f.__name__: f.launches for f in counters + [K6.maximum_path]}
    train_plain = {f.__name__: f.cuda_calls for f in plains + [K6.maximum_path_plain]}
    module_forwards = GradLogPEstimator2d.cuda_calls
    peak_bytes = torch.cuda.max_memory_allocated()
    val_metrics = trainer.validate(1)
    n_steps, n_val = len(trainer.train_loader), len(trainer.valid_loader)
    moved = sum(not torch.equal(a, p) for a, p in zip(first, trainer.model.parameters()))
    n_tensors = len(first)
    trainer2 = Trainer(exp, train_ds, valid_dataset=valid_ds, device=dev)
    start = trainer2.resume(str(log_dir / "grad_1"))
    steps_restored = {float(st["step"]) for st in trainer2.optimizer.state.values()}
    same = all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                  trainer2.model.state_dict().values()))
    files = sorted(p.name for p in log_dir.iterdir())
    shutil.rmtree(log_dir, ignore_errors=True)
    # where a step's time goes: one more step (the longest batch) under the profiler
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(trainer.train_loader)).items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(trainer.model, trainer.optimizer, batch, trainer.generator,
                   exp.train.out_size)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    step_kernels = {}
    for a in prof.key_averages():  # kernels only: a user annotation (Adam.step) spans some
        if (a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
                and not getattr(a, "is_user_annotation", False)):
            step_kernels[a.key] = (a.self_device_time_total / 1e3, a.count)
    step_busy = sum(ms for ms, _ in step_kernels.values())
    kinds = {"K6 mas_dp_kernel, mas_path_kernel": ("mas_dp", "mas_path_kernel"),
             "convolutions and matmuls (cuDNN, cuBLAS)": ("conv", "cudnn", "xmma", "cutlass",
                                                          "gemm", "sm90_", "wgrad", "dgrad"),
             "Adam (foreach)": ("multi_tensor_apply",), "reductions": ("reduce",),
             "elementwise": ("elementwise", "vectorized")}
    step_by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for k, (ms, _) in step_kernels.items():
        kind = [f for f, keys in kinds.items() if any(key in k for key in keys)]
        step_by_kind[kind[0] if kind else "other"] += ms
    step_profile = dict(
        batch_shape=list(batch["y"].shape), wall_ms_under_profiler=prof_wall_ms,
        device_kernel_ms=step_busy, idle_share_under_profiler=1 - step_busy / prof_wall_ms,
        kernel_launches=sum(c for _, c in step_kernels.values()),
        kernel_ms_by_kind=step_by_kind,
        kernels_by_time=[{"name": k[:90], "ms": ms, "count": c} for k, (ms, c) in
                         sorted(step_kernels.items(), key=lambda kv: -kv[1][0])[:12]])
    del trainer, trainer2, first, batch
    step_ms = sorted(1e3 * w for w in step_walls[1:])
    median_ms = step_ms[len(step_ms) // 2] if step_ms else None
    mas_train = next(c for c in mas_cases if c["in_step"])
    training = dict(
        card=card, preset="v2", batch_size=exp.train.batch_size, out_size=exp.train.out_size,
        steps=n_steps, validation_batches=n_val, fit_s=fit_s,
        step_wall_ms=[1e3 * w for w in step_walls], median_step_ms_after_first=median_ms,
        k6_ms_per_step=mas_train["ms"],
        k6_share_of_step=mas_train["ms"] / median_ms if median_ms else None,
        max_memory_allocated_bytes=peak_bytes, train_metrics=train_metrics,
        val_metrics=val_metrics, launches=train_launches, plain_calls_on_card=train_plain,
        module_path_forwards_on_card=module_forwards, tensors_moved=moved, n_tensors=n_tensors,
        checkpoints=files, resume_epoch=start, resume_adam_steps=sorted(steps_restored),
        resume_weights_equal=same, step_profile=step_profile,
        # the profiled step's kernel time against an unprofiled step's wall
        idle_share_of_median_step=1 - step_busy / median_ms if median_ms else None)
    emit({"training": training})
    want_mas = n_steps + n_val
    if n_steps != 3 or n_val != 1:
        fail(f"training: {n_steps} steps and {n_val} validation batches, expected 3 and 1")
    if train_launches["maximum_path"] != want_mas or any(train_plain.values()):
        fail(f"training: MAS launches {train_launches}, plain calls {train_plain}; "
             f"expected {want_mas} K6 launches and no plain version on the card")
    if not all(math.isfinite(v) for v in [*train_metrics.values(), *val_metrics.values()]):
        fail(f"training: a loss is not finite: {train_metrics} {val_metrics}")
    if not moved or start != 2 or steps_restored != {float(n_steps)} or not same:
        fail(f"training: moved {moved} tensors, resumed at epoch {start} with Adam steps "
             f"{steps_restored}, weights equal {same}")
    if not {"grad_1", "grad_best", "grad_final"} <= set(files):
        fail(f"training: checkpoints {files}")

    # ---- 9b. one train step on the card against the same step on the CPU ------
    cfg0 = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout=0.0, prenet_dropout=0.0))  # dropout's masks differ by device
    out_size = exp.train.out_size
    r = np.random.default_rng(5)
    x_l, y_l = np.array([64, 50], np.int32), np.array([256, 201], np.int32)
    xb = r.integers(1, cfg.encoder.n_vocab, (2, 64))
    yb = r.standard_normal((2, 256, F_)).astype(np.float32)
    for i in range(2):
        xb[i, x_l[i]:] = 0
        yb[i, y_l[i]:] = 0
    batch_np = dict(x=xb, x_lengths=x_l, y=yb, y_lengths=y_l,
                    pinned_t=r.uniform(0.05, 0.95, 2).astype(np.float32),
                    pinned_z=r.standard_normal((2, out_size, F_)).astype(np.float32),
                    pinned_offsets=(r.random(2) * (y_l - out_size)).astype(np.int32))
    side = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = build_model(cfg0, device=d, seed=0)
        est_d = m.decoder.estimator
        with torch.no_grad():
            for k, site in enumerate([lv[2] for lv in est_d.downs] + [est_d.mid_attn]
                                     + [u[2] for u in est_d.ups]):
                site.fn.g.fill_((0.03 + 0.01 * k) * (-1) ** k)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
        with torch.no_grad():
            mu_x, _, x_mask = m.encode(b["x"], b["x_lengths"])
            y_mask = (torch.arange(256, device=d)[None] < b["y_lengths"][:, None]).float()
            lp, am = mas_log_prior(mu_x, b["y"], x_mask, y_mask[:, :, None])
            path = K6.maximum_path(lp, am)
        metrics = train_step(m, make_optimizer(m, exp.train.learning_rate), b, None, out_size)
        side[name] = dict(path=path.cpu(), log_prior=lp.cpu(),
                            metrics={k: float(v) for k, v in metrics.items()},
                            grads={n: p.grad.cpu() for n, p in m.named_parameters()})
        del m
    gpu, cpu = side["card"], side["cpu"]
    diff_frames = (gpu["path"] != cpu["path"]).any(dim=1)  # (B, T_y)
    lp_diff = ((gpu["log_prior"] - cpu["log_prior"]).abs().amax(dim=1)[diff_frames].max().item()
               if diff_frames.any() else 0.0)
    loss_rel = {k: abs(gpu["metrics"][k] - cpu["metrics"][k]) / max(abs(cpu["metrics"][k]), 1e-30)
                for k in cpu["metrics"]}
    grad_worst, grad_name = 0.0, ""
    for n, gc in cpu["grads"].items():
        share = ((gpu["grads"][n] - gc).abs().max().item()
                 / (1e-3 * gc.abs().max().item() + 1e-7))
        if share > grad_worst:
            grad_worst, grad_name = share, n
    step_check = dict(card=card, B=2, T_x=64, T_y=256, out_size=out_size,
                      path_frames_differing=int(diff_frames.sum()),
                      log_prior_max_diff_there=lp_diff, metrics_card=gpu["metrics"],
                      metrics_cpu=cpu["metrics"], metrics_rel_diff=loss_rel,
                      grad_tolerance_share_worst=grad_worst, grad_worst_tensor=grad_name,
                      tol="losses rtol 1e-4; grads 1e-3 * max|g_cpu| + 1e-7 per tensor")
    emit({"card_vs_cpu_train_step": step_check})
    if diff_frames.any():
        fail(f"card vs CPU step: MAS paths differ in {int(diff_frames.sum())} frames "
             f"(largest log-prior difference there {lp_diff})")
    if max(loss_rel.values()) > 1e-4 or grad_worst > 1.0:
        fail(f"card vs CPU step: losses {loss_rel}, worst gradient {grad_name} at "
             f"{grad_worst:.3g} of its tolerance")

    # ---- 10. cli: every single-speaker preset through the port's CLIs --------
    cli_launches = cli_phase(card, dev, counters, plains, kernel_time, families)

    # ---- 11. train_presets: v1, v3, v5, v6, msml1h through cli.train ----------
    train_presets_launches = train_presets_phase(card, dev, counters, plains, K6)

    # ---- 12. eval: encode_audio, the pipelines, the demo, card against CPU ----
    eval_launches = eval_phase(card, dev, counters, plains)

    # ---- 13. train_vocoder: the HiFi-GAN GAN step through cli.train_vocoder ----
    vocoder_launches = train_vocoder_phase(card, dev, counters, plains)

    # ---- 14. train_bf16: bf16 decoder training against float32 ---------------
    bf16_train_k6 = train_bf16_phase(card, dev, counters, plains, K6)

    # ---- 15. train_dp: two gloo ranks on the card, and cli.train --mesh on NCCL --
    dp_k6, dp_trainer_k6, ranks, dp_ref = train_dp_phase(card, dev, K6)

    # ---- 16. sample_sp: the SP score function and synthesize(mesh=...) ---------
    sample_sp_phase(card, dev, ranks)

    # ---- 18. train_tp: shard_tp steps and a Trainer on a 1 x 2 mesh, same ranks --
    tp_k6, tp_trainer_k6 = train_tp_phase(card, ranks, dp_ref)

    # ---- 17. ema_corpus: the EMA corpora, v1 over them, quanti against their EMA --
    ema_launches = ema_corpus_phase(card, dev, counters, plains)

    # ---- the kernels line --------------------------------------------------
    meta = {
        "resblock2d": ("arttts_tpu_torch/csrc/resblock2d.cu",
                       "arttts_tpu/ops/resblock2d_pallas.py:394",
                       ["resblock2d_packed :916 (pallas_call :999)",
                        "resblock2d_wide :1107 (pallas_call :1191)"]),
        "downsample2d": ("arttts_tpu_torch/csrc/updown.cu",
                         "arttts_tpu/ops/updown_pallas.py:85",
                         ["downsample2d_to_real64 :137 (_down_kernel :85)",
                          "downsample2d_wide :362 (_down_wide_kernel :304)"]),
        "conv_transpose2d": ("arttts_tpu_torch/csrc/updown.cu",
                             "arttts_tpu/ops/updown_pallas.py:228",
                             ["conv_transpose2d_from_real64 :561 (_convt_kernel :228)",
                              "conv_transpose2d_wide :498 (_convt_wide_kernel :437)"]),
        "mrf_stage": ("arttts_tpu_torch/csrc/mrf.cu", "arttts_tpu/ops/mrf_pallas.py:138",
                      ["mrf_stage :432 (_mrf_kernel :138, pallas_call :349)"]),
        "upsample1d": ("arttts_tpu_torch/csrc/upsample1d.cu",
                       "arttts_tpu/ops/upsample_pallas.py:103",
                       ["upsample_packed :135 (_ups_kernel :103, pallas_call :168)"]),
    }
    def bf16_entry(name):
        """The kernel's bf16 mode: its launches on the bf16 main path (6b),
        its phase 3b cases' errors, and the sums over one evaluation's (or one
        request vocoder's) calls of its times and bound, beside the float32
        kernel's, and its device ms per bench-shape request (7b)."""
        mine = [c for c in cases16 if c["kernel"] == name]
        ev = [c for c in mine if c["in_eval"]]
        cores = [c["attn_core"] for c in mine if c["attn_core"]]
        fam = {"resblock2d": "K1 resblock2d", "downsample2d": "K2 downsample2d",
               "conv_transpose2d": "K3 conv_transpose2d", "mrf_stage": "K4 mrf_stage"}[name]
        return {
            "arithmetic": ("bf16 operands (round to nearest even), mma.sync m16n8k16 bf16, "
                           "float32 accumulation"),
            "launches": launches16[name],
            "launches_by_path": {"v2 main path, kernel_bf16": launches16[name]},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_rel_err"] for c in mine),
            "max_gap_share": max(c["gap_share"] for c in mine),
            "tolerance": {k: f"max|kernel-plain bf16| <= {v} * max(1, max|plain|)"
                          for k, v in TOL_KERNEL_BF16.items() if k.startswith(name)},
            "gap_share_limit": ("max|kernel-plain bf16| <= share * max|plain bf16-plain f32|, "
                                f"share {BF16_GAP_SHARE} ({BF16_GAP_SHARE_ATTN_BLOCK} for a "
                                "block with the attention, whose core alone is held to "
                                f"{BF16_GAP_SHARE})"),
            "ms": sum(c["ms"] for c in ev), "device_ms": sum(c["device_ms_per_call"] for c in ev),
            "bound_ms": sum(c["bound_ms"] for c in ev),
            "bound_by": max(ev, key=lambda c: c["bound_ms"])["bound_by"],
            "f32_ms": sum(c["f32_ms"] for c in ev),
            # one PyTorch call on bf16 operands (K2/K3: F.conv2d / F.conv_transpose2d)
            "library_ms": (sum(c["library_bf16_ms"] for c in ev)
                           if all(c["library_bf16_ms"] is not None for c in ev) else None),
            "library_device_ms": (sum(c["library_bf16_device_ms"] for c in ev)
                                  if all(c["library_bf16_device_ms"] is not None for c in ev)
                                  else None),
            "device_ms_per_bench_request": trace16["bf16"]["request"]["kernel_ms_by_family"][fam],
            "f32_device_ms_per_bench_request":
                trace16["float32"]["request"]["kernel_ms_by_family"][fam],
            **({"attention_core": {
                "cases": len(cores), "max_gap_share": max(r["gap_share"] for r in cores),
                "max_ctx_flipped_share": max(r["ctx_flipped_share"] for r in cores),
                "min_control_flipped_share": min(min(r["control_v_unrounded"],
                                                     r["control_exp_unrounded"]) for r in cores),
                "small_p": core_small,
                "max_q_ctx_rel_err": max(r["q_ctx_rel_err"] for r in cores)}} if cores else {}),
        }

    kernels = []
    launches_by_path = {name: {"v2 main path": launches[name], "artic_ms": art_launches[name],
                               "cli": cli_launches[name],
                               "train_presets": train_presets_launches[name],
                               "eval": eval_launches[name],
                               **({"ema_corpus": ema_launches[name]}
                                  if name not in ("mrf_stage", "upsample1d") else {}),
                               **({"train_vocoder": vocoder_launches[name]}
                                  if name in ("mrf_stage", "upsample1d") else {})}
                        for name in meta}
    for name, (src, replaces, wrappers) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        ev = [c for c in mine if c["in_eval"]]
        lib = [c["library_ms"] for c in ev]
        updown_extra = {}
        if name in ("resblock2d", "mrf_stage"):
            updown_extra = {
                "arithmetic": "3xTF32 on the tensor cores (mma.sync m16n8k8), float32 accumulation",
                "bound_f32_cuda_core_ms": sum(c["bound_f32_cuda_core_ms"] for c in ev),
                "device_ms": sum(c["device_ms_per_call"] for c in ev),
                "library_conv_ms": sum(c["library_conv_ms"] for c in ev),
                "library_conv_device_ms": sum(c["library_conv_device_ms"] for c in ev)}
        if name in ("downsample2d", "conv_transpose2d", "upsample1d"):
            updown_extra = {
                "arithmetic": "3xTF32 on the tensor cores (mma.sync m16n8k8), float32 accumulation",
                "bound_f32_cuda_core_ms": sum(c["bound_f32_cuda_core_ms"] for c in ev),
                "device_ms": sum(c["device_ms_per_call"] for c in ev),
                "library_device_ms": sum(c["library_device_ms"] for c in ev)}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_wrappers": wrappers, "launches": sum(launches_by_path[name].values()),
            "launches_by_path": launches_by_path[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_abs_err"] / max(1.0, c["max_abs_ref"]) for c in mine),
            "tolerance": f"max|kernel-plain| <= {TOL_KERNEL} * max(1, max|plain|)",
            # the sum over this kernel's calls in one score evaluation at 80x768
            # (K1-K3) or in one 768-frame request's vocoder (K4, K5)
            "per": (f"one score evaluation, B=1 80x768 ({len(ev)} calls)"
                    if name in ("resblock2d", "downsample2d", "conv_transpose2d")
                    else f"one request's vocoder, B=1 768 frames ({len(ev)} calls)"),
            "ms": sum(c["ms"] for c in ev), "plain_ms": sum(c["plain_ms"] for c in ev),
            "bound_ms": sum(c["bound_ms"] for c in ev),
            "bound_by": max(ev, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            **updown_extra,
            **({"bf16": bf16_entry(name)} if name in bf16_launches else {}),
        })
    kernels.append({
        "name": "maximum_path", "route": "cuda", "source": "arttts_tpu_torch/csrc/mas.cu",
        "replaces": "arttts_tpu/ops/mas_pallas.py:41",
        "tpu_wrappers": ["mas_pallas :180 (_mas_kernel :41, pallas_call :109)"],
        "launches": (train_launches["maximum_path"] + train_presets_launches["maximum_path"]
                     + bf16_train_k6 + dp_k6 + dp_trainer_k6 + tp_k6 + tp_trainer_k6),
        "launches_by_path": {"training (v2)": train_launches["maximum_path"],
                             "train_presets": train_presets_launches["maximum_path"],
                             "train_bf16": bf16_train_k6,
                             "training (DP, 2 ranks)": dp_k6,
                             "Trainer (DP, 2 ranks)": dp_trainer_k6,
                             "training (TP, 2 ranks)": tp_k6,
                             "Trainer (1 x 2 mesh, 2 ranks)": tp_trainer_k6},
        "max_abs_err": max(c["max_abs_err"] for c in mas_cases),
        "exact": all(c["exact_vs_plain"] and c["cells_off_oracle"] == 0 for c in mas_cases),
        "tolerance": "bit for bit against the plain version and the NumPy oracle",
        "per": ("one call at the training bucket, B=16 192x1024 (once per train step and "
                "per validation batch)"),
        "ms": mas_train["ms"], "plain_ms": mas_train["plain_ms"],
        "bound_ms": mas_train["bound_ms"], "bound_by": mas_train["bound_by"],
        "library_ms": None,
        "kernel_only_ms": mas_train["kernel_only_ms"], "masking_ms": mas_train["masking_ms"],
        "device_ms_by_part": mas_train["device_ms_by_part"],
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
