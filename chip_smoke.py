#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`arttts_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases, each
fatal on failure (exit code 1, no result line):

1. environment: the card (`nvidia-smi` name and power limit), torch/CUDA
   versions, whether nvcc and triton are present;
2. build the hand-written kernels from `arttts_tpu_torch/csrc/` (nvcc,
   sm_90a) and print ptxas' register/spill report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the v2 serving path gives it (B=1, 80x768 mel, float32, TF32 off
   in both): K1 `resblock2d` at all 13 of its call sites of one score
   evaluation plus padded, unmasked-statistics and two-utterance cases, K2
   `downsample2d` and K3 `conv_transpose2d` at both U-Net boundaries, K4
   `mrf_stage` at the vocoder's three stages with C <= 128 plus FiLM
   (SPARC window batches), B=2, ragged and multi-tile cases, K5
   `upsample1d` at both stride-2 upsamples in both paddings; time each
   (CUDA events) beside its bound, plain version and library call;
4. hold the whole score network, kernel path against the module path, at
   80x768 (and at bucket 128 with padding);
4b. hold the full-width vocoder's fast path (K4, K5) against its module
   path at 768 frames, and time both alone at buckets 128, 384 and 768;
5. hold a short text -> wav request on the card (kernels) against the same
   request on the CPU (plain versions) with the same weights;
6. the main path: the full-width v2 GradTTS and HiFi-GAN from a seed serve
   three requests through `serve_text_to_wav` (buckets 128, 384 and 768:
   both GroupNorm statistics modes) and one bench-shape request through
   `synthesize_to_wav` (T_x 96, durations pinned to 768 frames, 50 steps),
   with every launch counter set to 0 just before and read just after:
   all five kernels must have run as often as the path calls them, and no
   plain version on the card;
7. one more bench-shape request under `torch.profiler`: kernel time by
   name and by the port's kernel it belongs to, and the card's idle share;
8. the SPARC articulatory vocoder at full width from a seed, through
   `vocode_sparc` (windowed and two-placement tracks), against
   `vocode_chunked` over its module path, with K4's FiLM mode and K5
   counted.

Prints JSON lines; the `{"kernels": [...]}` line and the card line come
before the last, which is `{"ok": true, "device": {...}}`.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 1e-4  # max |kernel - plain| <= TOL * max(1, max |plain|)
TOL_SCORE = 1e-3
TOL_VOC = 1e-3  # fast vocoder against its module path, on the wav in [-1, 1]
TOL_WAV = 2e-3
N_STEPS = 50


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    if not (ROOT / "arttts_tpu_torch" / "csrc").is_dir():
        fail("arttts_tpu_torch/ is not beside chip_smoke.py: run from a checkout")
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

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

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

    def k1_case(name, cs, c_out, H, T, lengths, attn=False, masked=True, block_only=False,
                in_eval=True):
        B = len(lengths)
        xs = [rnd(B, c, H, T) for c in cs]
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        temb = None if block_only else rnd(B, c_out)
        w = block_w(sum(cs), c_out, block_only)
        a = attn_w(c_out) if attn else None
        kw = dict(masked_stats=masked, eps=1e-6, attn=a)
        kern = lambda: K1.resblock2d(xs, lens, temb, w, **kw)  # noqa: E731
        plain = lambda: K1.resblock2d_plain(xs, lens, temb, w, **kw)  # noqa: E731
        err, scale = compare(kern, plain)
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
        b_ms, b_by = bound(flops, nbytes)
        cases.append(dict(kernel="resblock2d", case=name, shape=[B, list(cs), c_out, H, T],
                          lengths=lengths, attn=attn, masked_stats=masked, block_only=block_only,
                          in_eval=in_eval, max_abs_err=err, max_abs_ref=scale,
                          ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                          bound_by=b_by, library_ms=None))

    def updown_case(kernel, cin, H, T, lengths):
        B = len(lengths)
        x = rnd(B, cin, H, T)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if kernel == "downsample2d":
            w, b = rnd(cin, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cin, scale=0.1)
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
        err, scale = compare(kern, plain)
        b_ms, b_by = bound(flops, 4 * (B * cin * H * T + out_n + w.numel() + b.numel()))
        # the main path's calls (B=1, unpadded); there the library call is the
        # same function
        full = lengths == [T]
        lib_ms = cuda_ms(lib) if full else None
        cases.append(dict(kernel=kernel, case=f"C={cin} {H}x{T}", shape=[B, cin, H, T],
                          lengths=lengths, in_eval=full, max_abs_err=err, max_abs_ref=scale,
                          ms=cuda_ms(kern), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms))

    def k4_case(name, B, C, T, ks=(3, 7, 11), film=False, in_eval=False, n=5):
        w = tuple(K4.MRFBranch(w1=rnd(3, C, C, k, scale=(k * C) ** -0.5), b1=rnd(3, C, scale=0.1),
                               w2=rnd(3, C, C, k, scale=(k * C) ** -0.5), b2=rnd(3, C, scale=0.1),
                               dilations=(1, 3, 5)) for k in ks)
        x = rnd(B, C, T)
        f = ((1 + rnd(len(ks), 3, B, C, scale=0.3), rnd(len(ks), 3, B, C, scale=0.1))
             if film else None)
        kern = lambda: K4.mrf_stage(x, w, f)  # noqa: E731
        plain = lambda: K4.mrf_stage_plain(x, w, f)  # noqa: E731
        err, scale = compare(kern, plain)
        flops = 2 * 2 * C * C * B * T * 3 * sum(ks)  # two convs per round, 3 rounds
        wbytes = sum(t.numel() for br in w for t in (br.w1, br.b1, br.w2, br.b2))
        nbytes = 4 * (2 * B * C * T + wbytes + (2 * f[0].numel() if film else 0))
        b_ms, b_by = bound(flops, nbytes)
        cases.append(dict(kernel="mrf_stage", case=name, shape=[B, C, T], kernel_sizes=list(ks),
                          film=film, in_eval=in_eval, max_abs_err=err, max_abs_ref=scale,
                          ms=cuda_ms(kern, n), plain_ms=cuda_ms(plain, n), bound_ms=b_ms,
                          bound_by=b_by, library_ms=None))

    def k5_case(name, B, cin, cout, T, pad, outpad, in_eval=False):
        x = rnd(B, cin, T)
        w, b = rnd(cin, cout, 4, scale=(2 * cin) ** -0.5), rnd(cout, scale=0.1)
        xl = torch.nn.functional.leaky_relu(x, 0.1)
        kern = lambda: K5.upsample1d(x, w, b, 2, pad, outpad)  # noqa: E731
        plain = lambda: K5.upsample1d_plain(x, w, b, 2, pad, outpad)  # noqa: E731
        lib = lambda: torch.nn.functional.conv_transpose1d(xl, w, b, 2, pad, outpad)  # noqa: E731
        err, scale = compare(kern, plain)
        t_out = (T - 1) * 2 - 2 * pad + 4 + outpad
        flops = 2 * 2 * cin * cout * B * t_out  # 2 of the 4 taps reach each output
        b_ms, b_by = bound(flops, 4 * (B * cin * T + B * cout * t_out + w.numel() + b.numel()))
        cases.append(dict(kernel="upsample1d", case=name, shape=[B, cin, cout, T],
                          padding=[pad, outpad], in_eval=in_eval, max_abs_err=err,
                          max_abs_ref=scale, ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                          bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib)))

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
    updown_case("downsample2d", 64, 80, 768, [768])
    updown_case("downsample2d", 128, 40, 384, [384])
    updown_case("downsample2d", 64, 80, 768, [701])
    updown_case("downsample2d", 128, 40, 384, [384, 250])
    updown_case("conv_transpose2d", 128, 20, 192, [192])
    updown_case("conv_transpose2d", 64, 40, 384, [384])
    updown_case("conv_transpose2d", 64, 40, 384, [351])
    updown_case("conv_transpose2d", 128, 20, 192, [97, 192])
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
    # edges: two utterances, a ragged T, single k=11 branches over many tiles,
    # and the tap routing at other paddings
    k4_case("B=2", 2, 64, 24576)
    k4_case("ragged T", 1, 32, 3001)
    k4_case("k=11 only, 17 tiles", 1, 32, 8192, ks=(11,))
    k4_case("k=11 only, FiLM, 35 tiles", 2, 128, 4096, ks=(11,), film=True)
    k5_case("padding 2, output padding 1", 2, 64, 32, 1001, 2, 1)
    k5_case("padding 0", 1, 128, 64, 999, 0, 0)
    for c in cases:
        c["ok"] = c["max_abs_err"] <= TOL_KERNEL * max(1.0, c["max_abs_ref"])
        emit({"kernel_case": c})
    bad = [f"{c['kernel']} {c['case']}" for c in cases if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the score network: kernel path against the module path --------
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.infer import sampler
    from arttts_tpu_torch.models.hifigan import build_vocoder, hifigan_forward_fast
    from arttts_tpu_torch.models.tts import build_model
    from arttts_tpu_torch.models.unet2d import GradLogPEstimator2d
    from arttts_tpu_torch.models.unet2d_fast import make_score_fn

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
    emit({"main_path": {"card": card, "requests": served, "launches": launches,
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

    # ---- 7. where the time goes: one bench-shape request under the profiler --
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, n = texts[-1], requests[-1][1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.synthesize_to_wav(model, vocoder, gen, x, torch.tensor([n]),
                                  n_timesteps=N_STEPS, max_frames=768,
                                  x_durations=torch.full((1, n), 768 / n), device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0:
            by_name[a.key] = (a.self_device_time_total / 1e3, a.count)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    # kernel time by the port's kernel it belongs to; the rest is PyTorch's
    # own (cuDNN convolutions, GEMVs, elementwise)
    families = {"K1 resblock2d": ("conv3x3_stats", "pointwise_kernel", "gn_stats", "gn_act",
                                  "attn_"),
                "K2 downsample2d": ("downsample_kernel",), "K3 conv_transpose2d": ("convt_kernel",),
                "K4 mrf_stage": ("mrf_round_kernel",), "K5 upsample1d": ("upsample_kernel",)}
    by_family = dict.fromkeys(list(families) + ["other"], 0.0)
    for k, (ms, _) in by_name.items():
        fam = [f for f, keys in families.items() if any(key in k for key in keys)]
        by_family[fam[0] if fam else "other"] += ms
    emit({"trace": {"card": card, "request": "bench shape, 768 frames, 50 steps",
                    "wall_ms_under_profiler": wall_ms, "device_kernel_ms": busy,
                    "idle_share": (1 - busy / wall_ms) if busy else None,
                    "kernel_ms_by_family": by_family,
                    "kernels_by_time": [{"name": k[:90], "ms": ms, "count": c}
                                        for k, (ms, c) in top]}})

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
    kernels = []
    for name, (src, replaces, wrappers) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        ev = [c for c in mine if c["in_eval"]]
        lib = [c["library_ms"] for c in ev]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "tpu_wrappers": wrappers, "launches": launches[name],
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
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
