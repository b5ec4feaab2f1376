"""The benchmark's general part: finds a cell's files by the names in
`BENCHMARK.json`, builds the program and the reference from the seed, runs
the traffic's driver through set-up, the measured window, an optional
profiled slice and the correctness check, and assembles the result line.

What belongs to one configuration, traffic mix or per-layer metric lives in
a file of its own: `configs/<config>.json`, `traffic/<traffic>.json` (its
"kind" names the driver module `drivers/<kind>.py`), `limits/<cell>.json`
(the limits of the numbers the check compares) and `metrics/<name>.py` (a
reader with `read(ctx) -> float | None`).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import seeds
from portbench.isolation import forbidden_loaded

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TRACE_DIR = REPO / "build" / "portbench"


@dataclasses.dataclass
class Spec:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Window:
    """What a measured window did: its units' records (those of a unit
    before the profiled slice have `before_slice` set), its seconds, the
    units attempted and failed, the records of the profiled slice, the
    seconds spent inside the vocoding stage by the units before the slice
    (where a driver times it), and the seconds before the slice."""

    records: list
    window_s: float
    attempted: int
    failed: int
    slice_records: list
    vocode_s: float = 0.0
    seconds_before_slice: Optional[float] = None  # set by the harness in a traced run


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(workload: str, benchmark: Optional[dict] = None) -> Spec:
    bench = benchmark or json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Spec(cell, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


# ------------------------------------------------------------ the program
def program_config(config: dict):
    """The port's ExperimentConfig for a configuration file: its preset
    with the file's model group."""
    from arttts_tpu_torch.core.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                              get_preset)

    m = dict(config["model"])
    m["encoder"] = EncoderConfig(**m["encoder"])
    dec = dict(m["decoder"])
    dec["dim_mults"] = tuple(dec["dim_mults"])
    m["decoder"] = DecoderConfig(**dec)
    return dataclasses.replace(get_preset(config["preset"]), model=ModelConfig(**m))


def _device_of(state: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(state.values())).device


def program_model(config: dict, state: Dict[str, torch.Tensor]):
    from arttts_tpu_torch.models.tts import GradTTSModel

    with torch.device(_device_of(state)):
        model = GradTTSModel(program_config(config).model)
    return seeds.load(model, state).eval()


def program_vocoder(config: dict, state: Dict[str, torch.Tensor]):
    from arttts_tpu_torch.models.hifigan import HiFiGANGenerator, SpkSparcHiFiGANGenerator

    v = {k: (tuple(map(tuple, x)) if k.startswith("resblock_dil") else
             tuple(x) if isinstance(x, list) else x)
         for k, x in config["vocoder"].items() if k != "kind"}
    with torch.device(_device_of(state)):
        voc = HiFiGANGenerator(**v) if config["vocoder"]["kind"] == "hifigan" \
            else SpkSparcHiFiGANGenerator(**v)
    return seeds.load(voc, state).eval()


# ------------------------------------------------------------ the reference
def reference_models(config: dict, device="cpu"):
    """The reference's acoustic model and vocoder: they name and shape every
    tensor the seed draws. (Built where their tensors will be, not on the
    meta device, whose initialisers import `torch._dynamo`: seconds of
    set-up.)"""
    from portbench.reference.tts import AcousticModel
    from portbench.reference.vocoders import build_vocoder

    with torch.device(device):
        return AcousticModel(config["model"]), build_vocoder(config["vocoder"])


def seeded_weights(config: dict, seed: int, device):
    """(acoustic state, vocoder state): the tensors both sides are given."""
    model, voc = reference_models(config, device)
    assumed = config.get("assumed", {})
    return (seeds.seeded_state(model, seed, device, "acoustic", assumed.get("overrides"),
                               assumed.get("leaf_bounds")),
            seeds.seeded_state(voc, seed, device, "vocoder"))


def reference_on(module, state):
    return seeds.load(module, state).eval()


# ------------------------------------------------------------ one run
class Tracer:
    """The profiled slice of a `--trace 1` run: `n` units of the window from
    unit `skip`, the host's operations and the device's, written as a Chrome
    trace after the window closes. (On the card a trace of the device's
    activity alone gives its kernels no durations, so the host is recorded
    too. That slows the host from the slice on, its stop gathering the
    events included, so a rate of a traced run divides the units before
    the slice alone.)"""

    def __init__(self, enabled: bool, skip: int, n: int, device: torch.device):
        self.enabled, self.skip, self.n, self.device = enabled, skip, n, device
        self.prof = self.done = self.wall_s = self.t_first = self.t_start = None

    @property
    def tracing(self) -> bool:
        return self.prof is not None

    @property
    def before_slice(self) -> bool:
        """The units so far are the profiler's (in an untraced run, all)."""
        return self.t_start is None

    def seconds_before(self) -> Optional[float]:
        """The window's seconds before the slice, once it ran."""
        return self.t_start - self.t_first if self.done is not None else None

    def unit(self, i: int):
        """Call before the window's unit i."""
        if i == 0:
            self.t_first = time.perf_counter()
        if self.enabled and i == self.skip:
            self._begin()
        elif i == self.skip + self.n:
            self.finish()

    def _begin(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        sync(self.device)
        self.t_start = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function("portbench.slice")
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def finish(self):
        if self.prof is None:
            return
        sync(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        t = time.perf_counter()
        self.prof.stop()  # seconds: the profiler gathers its events here
        self.stop_s = time.perf_counter() - t
        self.done, self.prof = self.prof, None

    def export(self, stem: str) -> Optional[Path]:
        """The slice's trace file, written now that the window is closed."""
        if self.done is None:
            return None
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / f"{stem}.json"
        self.done.export_chrome_trace(str(path))
        return path


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a driver is handed: the spec, the seed and the device."""

    spec: Spec
    seed: int
    seconds: float
    device: torch.device
    trace: bool
    workload: str
    fault: Optional[str] = None  # a planted fault (tests and calibration only)
    control: bool = False  # the reference in the program's place, in TF32
    phases: list = dataclasses.field(default_factory=list)

    def phase(self, name: str):
        """Mark the end of a stage of set-up (reported beside the result)."""
        self.phases.append((name, time.perf_counter()))

    @functools.cached_property
    def work(self):
        """The useful work of this configuration (`work.WorkCounter`)."""
        from portbench.work import WorkCounter

        return WorkCounter(self.spec.config)


class tf32_mode:
    """TF32 on (the control's precision) or off for cuBLAS and cuDNN inside."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def launch_counts() -> Dict[str, int]:
    from arttts_tpu_torch.ops import mas, mrf, resblock2d, updown, upsample

    return {"K1": resblock2d.resblock2d.launches, "K2": updown.downsample2d.launches,
            "K3": updown.conv_transpose2d.launches, "K4": mrf.mrf_stage.launches,
            "K5": upsample.upsample1d.launches, "K6": mas.maximum_path.launches}


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the check compares beside its limit; a number passes at
    or under its limit, and a missing or non-finite one fails."""
    out = {}
    for name, limit in limits.items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": limit}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    import math

    return all(c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(run: Run, t0: float, log=print) -> dict:
    """Set-up, window, check: the result object (without printing it)."""
    spec = run.spec
    from portbench.faults import planted

    run.phase("imports")
    if run.device.type == "cuda":  # the CUDA context, apart from the cell's own set-up
        torch.zeros(1, device=run.device)
        sync(run.device)
        run.phase("cuda")
    drv = driver_class(spec.traffic["kind"])(run)
    trc = spec.traffic["trace"]
    tracer = Tracer(run.trace, trc["skip"], trc["units"], run.device)
    with planted(run.fault):
        drv.setup()
        sync(run.device)
        run.phase("warm")
        setup_s = time.perf_counter() - t0
        launches0 = launch_counts()
        window = drv.window(tracer)
        window.seconds_before_slice = tracer.seconds_before()
        launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    drv.free_program()
    readings = drv.check(window)
    checks = compare(readings, spec.limits["limits"])
    result = {"correct": passed(checks), "attempted": window.attempted,
              "failed": window.failed}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
              else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if not run.trace:
        values = dict(drv.end_to_end(window), setup_s=setup_s)
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from portbench.trace import TraceSlice

        path = tracer.export(f"trace-{run.workload}")
        ts = TraceSlice(str(path), tracer.wall_s) if path else None
        ctx = ReaderContext(run, drv, window, ts)
        for m in spec.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ts is not None:
            device["busy_s"] = ts.busy_s
            device["window_s"] = ts.window_s
            result["breakdown"] = ts.breakdown()
            # the host's recording slows the slice's units: their seconds beside those
            # before it
            log(json.dumps({"slice_records": len(window.slice_records),
                            "slice_s": tracer.wall_s, "stop_s": tracer.stop_s,
                            "records_before": sum(r["before_slice"] for r in window.records),
                            "seconds_before": window.seconds_before_slice}))
        log(json.dumps({"launches_in_window": launches, "power": power_limit()}))
    log(json.dumps({"setup_phases_s": {k: round(v - t0, 3) for k, v in run.phases}}))
    result["metrics"] = metrics
    result["device"] = device
    bad = forbidden_loaded()
    if bad:
        raise IsolationError(bad)
    result["checks"] = checks
    return result


class IsolationError(RuntimeError):
    pass


class ReaderContext:
    """What a per-layer metric's reader sees: the run, its driver (for the
    work it completed), the window and the profiled slice."""

    def __init__(self, run: Run, driver, window, trace):
        self.run, self.driver, self.window, self.trace = run, driver, window, trace
        self.mode = run.spec.traffic["kind"]
        self.precision = run.spec.config["precision"]

    def kernel_names(self, family: str) -> List[str]:
        return json.loads((HERE / "kernels.json").read_text())[family]["names"]


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None
