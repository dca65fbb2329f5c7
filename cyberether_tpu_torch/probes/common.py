"""Timing and card helpers shared by the probes."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict

import torch

from cyberether_tpu_torch.core.types import require_device

# the probes' working set: the channelizer's (M, 128) float32 rows
ROWS, WIDTH = 131072, 128
# the card spins this many clock cycles (a few ms) before a timed run, so
# that the host has queued every call of the run before the first starts
SPIN_CYCLES = 10_000_000


def require_card(device: "str | torch.device") -> torch.device:
    """``device`` as a CUDA device; raises without a card or for any other
    device: a probe measures the card and never falls back."""
    dev = require_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes measure a CUDA card; got {dev}")
    return dev


def card(device: torch.device) -> Dict[str, str]:
    """The card's name and power limit (``nvidia-smi``'s, or "not
    measured" where it cannot be read)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        limit = smi.stdout.strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        limit = "not measured"
    return {"name": torch.cuda.get_device_name(device), "power_limit": limit}


def chained(step: Callable, x) -> Callable[[], None]:
    """A call that applies ``step`` to the last call's output, starting
    from ``x``: a chain with a real data dependency from call to call."""
    state = [x]

    def call() -> None:
        state[0] = step(state[0])
    return call


def chain_ms(call: Callable[[], None], k: int = 33, reps: int = 5) -> float:
    """Device ms per ``call``, as the JAX stream probe's ``chain_time``
    takes it: the difference of runs of k and of 1 calls, over k - 1 (the
    median of ``reps`` runs each).  Each run is timed by CUDA events and
    queued behind a spin of the card, so the host's cost to issue a call
    stays off the clock.  Raises if the k-call run took no longer than
    the 1-call run: that is a failed measurement, not a rate."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(n: int) -> float:
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(n):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(1)
    run(k)
    t1 = statistics.median(run(1) for _ in range(reps))
    tk = statistics.median(run(k) for _ in range(reps))
    if tk <= t1:
        raise RuntimeError(f"chain_ms: {k} chained calls took {tk} ms, one "
                           f"took {t1} ms: no time per call to measure")
    return (tk - t1) / (k - 1)


def dispatch(call: Callable[[], None], n: int = 50) -> Dict[str, float]:
    """One call's dispatch floor: the host µs to issue it (the card not
    waited for), and the CUDA-event ms a call of ``n`` issued back to back
    on an idle card (each waits for the host to issue it)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return {"host_us": host_us, "event_ms": start.elapsed_time(end) / n}


def rate(nbytes: float, ms: float) -> float:
    """GB/s of ``nbytes`` moved in ``ms``."""
    return nbytes / ms / 1e6
