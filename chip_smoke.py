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
   shapes one score evaluation of the v2 serving path gives it (B=1, 80x768
   mel, float32, TF32 off in both): K1 `resblock2d` at all 13 of its call
   sites plus padded, unmasked-statistics and two-utterance cases, K2
   `downsample2d` and K3 `conv_transpose2d` at both U-Net boundaries; time
   each (CUDA events);
4. hold the whole score network, kernel path against the module path, at
   80x768 (and at bucket 128 with padding);
5. hold a short text -> wav request on the card (kernels) against the same
   request on the CPU (plain versions) with the same weights;
6. the main path: the full-width v2 GradTTS and HiFi-GAN from a seed serve
   three requests through `serve_text_to_wav` (buckets 128, 384 and 768:
   both GroupNorm statistics modes) and one bench-shape request through
   `synthesize_to_wav` (T_x 96, durations pinned to 768 frames, 50 steps),
   with every launch counter set to 0 just before and read just after:
   all three kernels must have run, and no plain version on the card;
7. one more bench-shape request under `torch.profiler`: kernel time by
   name and the card's idle share.

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

    from arttts_tpu_torch.ops import resblock2d as K1
    from arttts_tpu_torch.ops import updown

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
    for c in cases:
        c["ok"] = c["max_abs_err"] <= TOL_KERNEL * max(1.0, c["max_abs_ref"])
        emit({"kernel_case": c})
    bad = [f"{c['kernel']} {c['case']}" for c in cases if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the score network: kernel path against the module path --------
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.infer import sampler
    from arttts_tpu_torch.models.hifigan import build_vocoder
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

    counters = [K1.resblock2d, updown.downsample2d, updown.conv_transpose2d]
    plains = [K1.resblock2d_plain, updown.downsample2d_plain, updown.conv_transpose2d_plain]
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
    want = {"resblock2d": 13 * n_eval, "downsample2d": 2 * n_eval,
            "conv_transpose2d": 2 * n_eval}
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
    emit({"trace": {"card": card, "request": "bench shape, 768 frames, 50 steps",
                    "wall_ms_under_profiler": wall_ms, "device_kernel_ms": busy,
                    "idle_share": (1 - busy / wall_ms) if busy else None,
                    "kernels_by_time": [{"name": k[:90], "ms": ms, "count": c}
                                        for k, (ms, c) in top]}})

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
            # per score evaluation: the sum over this kernel's calls at 80x768
            "per": f"one score evaluation, B=1 80x768 ({len(ev)} calls)",
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
