"""Tracing, profiling and timing utilities; counterpart of
``infinicube_tpu/utils/profiling.py``.

``profile_named`` writes a ``torch.profiler`` Chrome trace of the enclosed
region when ``PT_PROFILE`` is set (the reference's own switch, whose
``jax.profiler`` trace the JAX package gates by ``JAX_PROFILE``);
``annotate`` names a sub-region inside it (``record_function``);
``@mem_profile`` prints the card's allocated-memory delta of each call when
``MEM_PROFILE`` is set; the wall-clock ``Timer`` and ``TimerCollection`` and
the average meters carry over as they are."""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def profile_named(name: str, logdir: str = "traces"):
    """A Chrome trace (CPU and, where there is a card, CUDA activity) of
    the enclosed region at ``logdir/name.json`` when PT_PROFILE is set
    (view it in ui.perfetto.dev or chrome://tracing); the region alone
    otherwise."""
    if not os.environ.get("PT_PROFILE"):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def annotate(name: str):
    """Named sub-region inside an active trace (``record_function``)."""
    return torch.profiler.record_function(name)


def mem_profile(every: int = 1):
    """Decorator: print every ``every``-th call's change of the card's
    allocated memory when MEM_PROFILE is set."""
    def deco(fn):
        count = {"n": 0}

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not os.environ.get("MEM_PROFILE"):
                return fn(*a, **kw)
            count["n"] += 1
            if count["n"] % every or not torch.cuda.is_available():
                return fn(*a, **kw)
            before = torch.cuda.memory_allocated()
            out = fn(*a, **kw)
            after = torch.cuda.memory_allocated()
            print(f"[mem] {fn.__name__}: {(after - before) / 2 ** 20:+.1f} MiB"
                  f" (now {after / 2 ** 20:.1f} MiB)")
            return out
        return wrapper
    return deco


class Timer:
    """Wall-clock timer; on the card, call ``fence(x)`` on an output before
    reading to get the device's time."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def reset(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @staticmethod
    def fence(x):
        """Wait until the device of tensor ``x`` has finished its queued
        work; returns x."""
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x


class TimerCollection:
    """Named accumulating timers (exp.TimerCollections)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.n = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        self.acc[name] += time.perf_counter() - t0
        self.n[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": self.acc[k], "mean_s": self.acc[k] / self.n[k],
                    "count": self.n[k]} for k in self.acc}


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, v, n: int = 1):
        self.sum += float(v) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class RunningAverageMeter:
    def __init__(self, alpha: float = 0.95):
        self.alpha = alpha
        self.val: float | None = None

    def update(self, v):
        v = float(v)
        self.val = v if self.val is None else \
            self.alpha * self.val + (1 - self.alpha) * v
