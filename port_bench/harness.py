"""What every cell shares: its files read by name, the program set up from the seed, the
measured window, the device trace read back, the comparison with the reference, and the
result line.

A cell (``workloads/<cell>.json``) names a configuration (``configs/<config>.json``) and a
traffic kind (``traffic/<kind>.py``), with the kind's parameters and the cell's limits.
Each metric is read by ``metrics/<metric>.py``'s ``read(run)``, which returns a number or
None (nothing to read: the metric is left out). Which metrics a run reports comes from
``BENCHMARK.json``: with ``--trace 0`` the end-to-end metrics that name the cell (or name no
cells), with ``--trace 1`` the per-layer metrics that do.

A traffic module has ``setup(run)`` (warm-up with the cell's shapes, counted in set-up),
``window(run, seconds)`` (the measured window: ``run.requests``, ``run.groups`` and
``run.spans`` filled, every request started before ``seconds`` run to its end) and
``judge(run)`` (the comparison with the reference: ``[Check]``, once the program is freed),
and may have ``close(run)``, which lets go of the program before the comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "foley_tpu")  # top-level module names, compared whole


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_file(name: str) -> Path:
    """A cell's file: ``workloads/<name>.json``, or a path to a ``.json`` file."""
    p = Path(name)
    return p if p.suffix == ".json" else BENCH / "workloads" / f"{name}.json"


def config_file(cell: dict, cell_path: Path) -> Path:
    local = cell_path.parent / f"{cell['config']}.json"
    return local if cell_path.parent != BENCH / "workloads" and local.exists() \
        else BENCH / "configs" / f"{cell['config']}.json"


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Request:
    """One request of the window: host times (``time.monotonic``), the seconds of audio,
    its seed and what the program returned (``pcm`` [T] int16 values as float, ``latents``
    [T, C] where the entry returns them). A request that raises ends the run: no result."""

    start: float
    end: float
    audio_s: float
    seed: int
    pcm: Optional[np.ndarray] = None
    latents: Optional[np.ndarray] = None
    timings: Optional[dict] = None


@dataclasses.dataclass
class Group:
    """One generation on the card: its rows (requests) and host times."""

    rows: int
    start: float
    end: float
    requests: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Run:
    """One run of one cell: what the traffic, the readers and the comparison share."""

    def __init__(self, cell: dict, config: dict, seed: int, device: torch.device,
                 t_process: float):
        self.cell, self.config, self.seed, self.device = cell, config, int(seed), device
        self.params = cell["params"]
        self.t_process = t_process
        self.requests: List[Request] = []
        self.groups: List[Group] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.counters: Dict[str, int] = {}
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.trace: Optional["Trace"] = None
        self.bundle = None
        self.state: dict = {}  # the traffic module's own objects (service, clips)
        self.reference: dict = {}  # the reference's answers, by the requests' seeds
        self.restart_seeds()

    def restart_seeds(self, *salt: int) -> None:
        """Start the requests' seeds again, drawn from the run's seed (and ``salt``)."""
        self._seeds = np.random.default_rng(np.random.SeedSequence([self.seed, *salt]))

    def request_seed(self) -> int:
        """The next request's seed, drawn from the run's seed."""
        return int(self._seeds.integers(0, 2 ** 31 - 1))

    def sample(self, n: int, k: int) -> List[int]:
        """``k`` of ``n`` indices, drawn from the run's seed."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1]))
        return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())

    @property
    def model_dtype(self) -> torch.dtype:
        """The denoiser's precision, as the configuration states it."""
        return {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}[
            self.config["model_precision"]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.append((name, start, end))

    # -- the program ----------------------------------------------------------------
    def pipeline_cfg(self):
        """The port's ``PipelineConfig`` of this configuration."""
        from foley_tpu_torch.configs import DACConfig, DiffusionConfig, MMDiTConfig, PipelineConfig

        fields = {f.name for f in dataclasses.fields(MMDiTConfig)}
        model = MMDiTConfig(**{k: v for k, v in self.config["model"].items() if k in fields})
        pipe = self.config["pipeline"]
        dac = {k: tuple(v) if isinstance(v, list) else v for k, v in self.config["dac"].items()
               if k in {f.name for f in dataclasses.fields(DACConfig)}}
        return PipelineConfig(model=model, diffusion=DiffusionConfig(**self.config["diffusion"]),
                              dac=DACConfig(**dac), siglip2_fps=pipe["siglip2_fps"],
                              synchformer_fps=pipe["synchformer_fps"])

    def build_bundle(self):
        """The program's models from seeded checkpoint-layout weights, through its
        checkpoint converter, in the configuration's precisions."""
        from foley_tpu_torch.io.convert import (convert_dac_state_dict,
                                                convert_mmdit_state_dict, module_from_state_dict)
        from foley_tpu_torch.models.dac_vae import DAC
        from foley_tpu_torch.models.mmdit import MMDiT
        from foley_tpu_torch.pipeline.generate import ModelBundle

        from port_bench import weights

        cfg = self.pipeline_cfg()
        dtype = self.model_dtype
        sd = weights.mmdit(self.config["model"], self.seed, self.device, dtype)
        model = module_from_state_dict(
            MMDiT, convert_mmdit_state_dict(sd, cfg.model, strict=True, consume=True),
            cfg.model, self.device, dtype)
        del sd
        sd = weights.dac(self.config["dac"], self.config["weights"]["dac_gains"], self.seed,
                         self.device)
        dac = module_from_state_dict(
            DAC, convert_dac_state_dict(sd, cfg.dac, strict=True, consume=True), cfg.dac,
            self.device, torch.float32)
        del sd
        self.bundle = ModelBundle(mmdit=model, dac=dac, pipeline_cfg=cfg, compute_dtype=dtype)
        return self.bundle

    def free_program(self) -> None:
        self.bundle = None
        self.state.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------------------

class Trace:
    """The card's activity in the window, from the profiler's raw events: names, start
    and end on the host's ``time.monotonic`` clock (aligned by the anchor kernel each run
    launches right after a synchronize at the window's start)."""

    def __init__(self, names: List[str], start: np.ndarray, end: np.ndarray):
        self.names, self.start, self.end = names, start, end

    @classmethod
    def from_profiler(cls, prof, anchor_host: float) -> "Trace":
        from torch.autograd import DeviceType

        names, starts, ends = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.start_ns() + e.duration_ns())
        start = np.asarray(starts, np.int64)
        end = np.asarray(ends, np.int64)
        order = np.argsort(start, kind="stable")
        names = [names[i] for i in order]
        start, end = start[order], end[order]
        anchor = next((i for i, n in enumerate(names) if "spin_kernel" in n), 0)
        offset = (start[anchor] if len(start) else 0) - int(anchor_host * 1e9)
        return cls(names, (start - offset) / 1e9, (end - offset) / 1e9)

    def merged(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of the events' intervals: (starts, ends) of disjoint busy stretches."""
        if not len(self.start):
            return self.start, self.end
        run_end = np.maximum.accumulate(self.end)
        new = np.ones(len(self.start), bool)
        new[1:] = self.start[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        ends = np.append(run_end[idx[1:] - 1], run_end[-1])
        return self.start[idx], ends

    def busy_s(self, t0: float, t1: float) -> float:
        s, e = self.merged()
        return float(np.clip(np.minimum(e, t1) - np.maximum(s, t0), 0, None).sum())

    def seconds_of(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(summed duration, count) of the events whose name ``match``es."""
        sel = [i for i, n in enumerate(self.names) if match(n)]
        return float((self.end[sel] - self.start[sel]).sum()), len(sel)

    def top_ops(self, n: int = 10) -> List[list]:
        by = {}
        for name, d in zip(self.names, self.end - self.start):
            by[name] = by.get(name, 0.0) + float(d)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, t0: float, t1: float, spans, n: int = 10) -> List[list]:
        """The window's stretches with nothing on the card, summed by what the host was doing:
        each gap is named by the innermost host span around its middle. [[name, seconds]],
        the largest first."""
        s, e = self.merged()
        gap_s = np.maximum(np.concatenate([[t0], e]), t0)
        gap_e = np.minimum(np.concatenate([s, [t1]]), t1)
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        mid = (gap_s + gap_e) / 2
        label = np.full(len(mid), -1)
        names = [name for name, _, _ in spans]
        # the longest spans first, so that an inner span's name overwrites its parent's
        for i in sorted(range(len(spans)), key=lambda i: spans[i][1] - spans[i][2]):
            _, lo, hi = spans[i]
            label[(mid >= lo) & (mid <= hi)] = i
        by: Dict[str, float] = {}
        for i, length in zip(label, gap_e - gap_s):
            name = names[i] if i >= 0 else "outside any span"
            by[name] = by.get(name, 0.0) + float(length)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ---------------------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------------------

def metric_names(bench: dict, cell: str, trace: bool) -> List[str]:
    """The metrics a run of ``cell`` reports, by ``BENCHMARK.json``."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return [m["name"] for m in e2e]
    reported = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}


def load(cell_name: str, seed: int, device: torch.device, t_process: float):
    """(run, traffic module) of a cell, its files read by name."""
    path = cell_file(cell_name)
    cell = load_json(path)
    config = load_json(config_file(cell, path))
    traffic = load_module(BENCH / "traffic" / f"{cell['traffic']}.py",
                          f"port_bench_traffic_{cell['traffic']}")
    return Run(cell, config, seed, device, t_process), traffic


def set_up(run: Run, traffic, log: Callable[[str], None] = lambda s: None) -> None:
    """The program built from the seed and warmed up with the cell's shapes."""
    log(f"imports and CUDA {time.monotonic() - run.t_process:.3f} s")
    run.build_bundle()
    sync(run.device)
    log(f"weights drawn and converted {time.monotonic() - run.t_process:.3f} s")
    traffic.setup(run)
    sync(run.device)
    log(f"warm-up {time.monotonic() - run.t_process:.3f} s")


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: torch.device,
            t_process: float, metrics: Optional[List[str]] = None,
            log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """One run of a cell: set-up, warm-up, the window, the trace, the comparison. Returns
    the result line's object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown`` when traced, ``checks`` last)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    run, traffic = load(cell_name, seed, device, t_process)
    names = metrics if metrics is not None else metric_names(bench, run.cell["name"], trace)
    readers = {n: load_module(BENCH / "metrics" / f"{n}.py", "port_bench_metric_" +
                              n.replace(".", "_").replace("-", "_")) for n in names}
    set_up(run, traffic, log)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        sync(device)
    t0 = time.monotonic()
    run.setup_s = t0 - t_process
    if device.type == "cuda":
        torch.cuda._sleep(1000)  # the anchor that aligns the trace with the host clock
    log(f"set-up {run.setup_s:.3f} s; window of {seconds} s")
    traffic.window(run, seconds)
    sync(device)
    run.window = (t0, time.monotonic())
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        t_read = time.monotonic()
        prof.__exit__(None, None, None)
        run.trace = Trace.from_profiler(prof, t0)
        del prof
        log(f"trace read: {len(run.trace.names)} device events, "
            f"{time.monotonic() - t_read:.3f} s")
    values = {}
    for n in names:
        v = readers[n].read(run)
        if v is not None:
            values[n] = {"value": v, "unit": units(bench).get(n, "")}
    log(f"window {run.window_s:.3f} s, {len(run.requests)} requests; "
        f"walls {[round(r.end - r.start, 3) for r in run.requests]}, "
        f"rows a generation {[g.rows for g in run.groups]}")

    if hasattr(traffic, "close"):
        traffic.close(run)
    run.free_program()
    t_judge = time.monotonic()
    checks = traffic.judge(run)
    log(f"comparison with the reference: {time.monotonic() - t_judge:.3f} s")
    out = {"correct": bool(checks) and all(c.ok for c in checks),
           "attempted": len(run.requests), "failed": 0, "metrics": values,
           "device": device_info(run, trace)}
    if run.trace is not None:
        out["breakdown"] = {
            "device_ops": run.trace.top_ops(),
            "idle_gaps": run.trace.idle_gaps(*run.window, run.spans)}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r}")
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (the peaks assume 700 W)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def device_info(run: Run, trace: bool) -> dict:
    dev = run.device
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(run.peak_bytes), "power_limit": power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s(*run.window)
        info["window_s"] = run.window_s
    return info
