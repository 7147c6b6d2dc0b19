"""Profiling helpers: capture a trace of a function and summarise time by
kernel.

The port's counterpart of the JAX package's ``utils/profiling.py``: the
trace comes from ``torch.profiler`` (CUDA activity on the card, the host's
operators on the CPU) as a Chrome trace, and the census reads any Chrome
trace, gzipped or not, as the JAX version reads its ``trace.json.gz``. The
reference's only profiling was wall-clock prints (MC-GPU_v1.3.cu:2806-2812).
"""

from __future__ import annotations

import collections
import gzip
import json
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from cbctmc_tpu_torch.engine.device import resolve_device


def capture_trace(fn: Callable[[], object], trace_dir: str | None = None,
                  device=None) -> str:
    """Run fn under ``torch.profiler`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``); returns the path of the Chrome trace. The card
    is synchronised before the profile closes, so every kernel fn launched
    is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    trace_dir = Path(trace_dir or tempfile.mkdtemp(prefix="cbctmc_trace_"))
    trace_dir.mkdir(parents=True, exist_ok=True)
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = trace_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    return str(path)


def _read_trace(trace_path) -> dict:
    raw = Path(trace_path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def kernel_census(trace_path: str, top: int = 25) -> List[Dict]:
    """Aggregate the durations of the trace's complete events by name."""
    trace = _read_trace(trace_path)
    duration = collections.Counter()
    count = collections.Counter()
    for event in trace.get("traceEvents", []):
        if event.get("ph") == "X" and "dur" in event:
            name = event.get("name", "?")
            duration[name] += event["dur"]
            count[name] += 1
    rows = [
        {"name": name, "total_ms": dur / 1e3, "count": count[name]}
        for name, dur in duration.most_common(top)
    ]
    return rows


def profile_projection_step(
    run: Callable[[], object], top: int = 25, device=None
) -> Tuple[List[Dict], str]:
    """Convenience wrapper: trace one call and return the census."""
    path = capture_trace(run, device=device)
    return kernel_census(path, top=top), path
