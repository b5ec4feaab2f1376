"""Interactive demo server (port of `arttts_tpu/cli/demo.py`, the UTMOS-demo
`app.py` equivalent without gradio): a stdlib ThreadingHTTPServer with

  GET  /          a small HTML page (type text -> listen; upload wav -> MOS)
  POST /api/tts   JSON {"text": "...", "n_timesteps": 50, "solver": "euler"}
                  -> audio/wav through `infer/sampler.py:serve_text_to_wav`
                  (the score network on K1-K3, the vocoder on K4 and K5)
  POST /api/mos   raw wav body -> JSON {"mos": float} (resampled to 16 kHz,
                  tiled to its sample bucket, UTMOS)

    python -m arttts_tpu_torch.cli.demo --preset v2 --ckpt logs/v2/grad_best \
        --vocoder-ckpt ckpts/hifigan.pt --utmos-ckpt ckpts/utmos.ckpt

The models live on `--device` (the card by default; with no card the server
does not start). Without checkpoints they run on random weights, with a
loud warning: the audio is noise, but the whole serving path runs. A request
that raises gets a 500 with the error, and the server keeps running.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

log = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<title>arttts-tpu demo</title>
<h1>arttts-tpu</h1>
<h2>Text to speech</h2>
<form onsubmit="tts(event)"><input id=t size=60 value="Hello world.">
<button>Synthesize</button></form><audio id=a controls></audio>
<h2>MOS scoring (UTMOS)</h2>
<input type=file id=f accept=.wav onchange="mos()"><pre id=m></pre>
<script>
async function tts(e){e.preventDefault();
 const r=await fetch('/api/tts',{method:'POST',
  body:JSON.stringify({text:document.getElementById('t').value})});
 document.getElementById('a').src=URL.createObjectURL(await r.blob());}
async function mos(){const f=document.getElementById('f').files[0];
 const r=await fetch('/api/mos',{method:'POST',body:await f.arrayBuffer()});
 document.getElementById('m').textContent=await r.text();}
</script>"""


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """Mono 16-bit PCM WAV in memory (no file per request)."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
    hdr += struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    """The /api/mos body: 16/32-bit or float PCM, the first channel."""
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    wav = np.asarray(wav)
    if wav.ndim > 1:
        wav = wav[:, 0]
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    else:
        wav = wav.astype(np.float32)
    return wav, int(sr)


class DemoApp:
    """The serving state shared by the request threads; device work is
    serialised with a lock (one card, one queue)."""

    def __init__(self, preset: str = "v2", ckpt=None, vocoder_ckpt=None, utmos_ckpt=None,
                 sample_rate: int = 22050, vocoder=None, scorer=None,
                 max_frames_cap: int = 2048, device="cuda"):
        import torch

        from arttts_tpu_torch.core.config import get_preset
        from arttts_tpu_torch.core.device import resolve
        from arttts_tpu_torch.models.hifigan import HiFiGANGenerator, build_vocoder
        from arttts_tpu_torch.models.tts import GradTTSModel, build_model

        self.device = resolve(device)
        self.sample_rate = sample_rate
        self.max_frames_cap = max_frames_cap
        self.cfg = get_preset(preset)
        if self.cfg.model.n_feats != 80:
            raise ValueError("the TTS demo serves mel presets (n_feats=80)")
        self._lock = threading.Lock()

        if ckpt:
            from arttts_tpu_torch.core.checkpoint import load_checkpoint

            with torch.device("meta"):  # the checkpoint's tensors become the parameters
                self.model = GradTTSModel(self.cfg.model)
            self.model.load_state_dict(
                load_checkpoint(ckpt, map_location=self.device)["model"], assign=True)
            self.model.eval()
        else:
            log.warning("demo: RANDOM acoustic weights (no --ckpt): the audio will be noise")
            self.model = build_model(self.cfg.model, device=self.device, seed=0)

        if vocoder is not None:
            self.vocoder = vocoder
        elif vocoder_ckpt:
            from arttts_tpu_torch.utils.reference_weights import fold_weight_norm

            t_ckpt = torch.load(vocoder_ckpt, map_location="cpu", weights_only=False)
            with torch.device("meta"):
                self.vocoder = HiFiGANGenerator()
            self.vocoder.load_state_dict(fold_weight_norm(t_ckpt.get("generator", t_ckpt)),
                                         assign=True)
            self.vocoder = self.vocoder.to(self.device).eval()
        else:
            log.warning("demo: RANDOM vocoder weights (no --vocoder-ckpt)")
            self.vocoder = build_vocoder(device=self.device, seed=1)

        from arttts_tpu_torch.eval.utmos_scorer import UTMOSScorer

        if scorer is not None:
            self.scorer = scorer
        elif utmos_ckpt:
            self.scorer = UTMOSScorer.from_lightning_checkpoint(utmos_ckpt, device=self.device)
        else:
            log.warning("demo: RANDOM UTMOS weights (no --utmos-ckpt)")
            self.scorer = UTMOSScorer(device=self.device)

        from arttts_tpu_torch.core.paths import CMUDICT_PATH
        from arttts_tpu_torch.text.cmudict import CMUDict

        try:
            self.cmudict = CMUDict(str(CMUDICT_PATH))
        except OSError:
            self.cmudict = None

    # ---- endpoints -----------------------------------------------------
    def tts(self, text: str, n_timesteps: int = 50, solver: str = "euler") -> bytes:
        import torch

        from arttts_tpu_torch.infer.sampler import serve_text_to_wav
        from arttts_tpu_torch.text.sequence import intersperse, text_to_sequence
        from arttts_tpu_torch.text.symbols import symbols

        seq = intersperse(text_to_sequence(text, dictionary=self.cmudict), len(symbols))
        x = np.asarray(seq, np.int64)[None]
        xl = np.array([len(seq)], np.int64)
        with self._lock:
            generator = torch.Generator(self.device).manual_seed(
                int(np.random.randint(1 << 31)))
            wav, y_len, _bucket = serve_text_to_wav(
                self.model, self.vocoder, generator, x, xl, n_timesteps=n_timesteps,
                solver=solver, max_frames_cap=self.max_frames_cap, device=self.device)
            frames = int(y_len[0])
            audio = wav[0, : frames * 256, 0].cpu().numpy()
        return _wav_bytes(audio, self.sample_rate)

    def mos(self, wav_body: bytes) -> float:
        from arttts_tpu_torch.eval.utmos_scorer import _bucket, repeat_pad

        wav, sr = _parse_wav(wav_body)
        if sr != 16000:
            from scipy.signal import resample_poly

            g = int(np.gcd(sr, 16000))
            wav = resample_poly(wav, 16000 // g, sr // g).astype(np.float32)
        wav = repeat_pad(wav, _bucket(len(wav)))
        with self._lock:
            return float(self.scorer.score_batch([wav])[0])


def make_handler(app: DemoApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.info("demo: " + fmt, *args)

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            try:
                if self.path == "/api/tts":
                    req = json.loads(body or b"{}")
                    wav = app.tts(req.get("text", ""),
                                  n_timesteps=int(req.get("n_timesteps", 50)),
                                  solver=req.get("solver", "euler"))
                    self._send(200, wav, "audio/wav")
                elif self.path == "/api/mos":
                    self._send(200, json.dumps({"mos": app.mos(body)}).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # the server's boundary: report, keep serving
                log.exception("demo request failed")
                self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")

    return Handler


def serve(app: DemoApp, host: str = "127.0.0.1", port: int = 7860):
    """The ThreadingHTTPServer (gradio's default port); the caller runs
    `serve_forever()`."""
    return ThreadingHTTPServer((host, port), make_handler(app))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="v2")
    parser.add_argument("--ckpt")
    parser.add_argument("--vocoder-ckpt")
    parser.add_argument("--utmos-ckpt")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from arttts_tpu_torch.core.runtime import setup_runtime

    device = setup_runtime(args.device)
    app = DemoApp(args.preset, args.ckpt, args.vocoder_ckpt, args.utmos_ckpt, device=device)
    srv = serve(app, args.host, args.port)
    log.info("demo listening on http://%s:%d", args.host, args.port)
    srv.serve_forever()


if __name__ == "__main__":
    main()
