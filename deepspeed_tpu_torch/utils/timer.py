"""Timers (the port of ``deepspeed_tpu/utils/timer.py``; reference
``deepspeed/utils/timer.py``).

``SynchronizedWallClockTimer`` (reference ``timer.py:44``) times each
start/stop span with two events of the accelerator (CUDA events on the
card, the host clock on the CPU) and reads them when asked, so a running
step is not synchronised by its timers.  ``wall_clock_breakdown`` turns it
on in the engine (forward, backward, step).
"""

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


class SynchronizedWallClockTimer:

    class Timer:

        def __init__(self, name, accelerator):
            self.name_ = name
            self._acc = accelerator
            self.started_ = False
            self._start = None
            self._spans = []     # (start, end) events not yet read
            self.elapsed_ = 0.0  # seconds read from finished spans
            self.records = []    # ms of each finished span

        def start(self, sync=False):
            assert not self.started_, f"{self.name_} timer already started"
            if sync:
                self._acc.synchronize()
            self._start = self._acc.Event(enable_timing=True)
            self._start.record()
            self.started_ = True

        def stop(self, reset=False, record=True, sync=False):
            assert self.started_, f"{self.name_} timer not started"
            end = self._acc.Event(enable_timing=True)
            end.record()
            if sync:
                end.synchronize()
            if reset:
                self._fold()
                self.elapsed_ = 0.0
            self._spans.append((self._start, end, record))
            self.started_ = False

        def _fold(self):
            for start, end, record in self._spans:
                end.synchronize()
                ms = start.elapsed_time(end)
                self.elapsed_ += ms / 1e3
                if record:
                    self.records.append(ms)
            self._spans = []

        def elapsed(self, reset=True):
            """Seconds over the finished spans (waits for their events)."""
            self._fold()
            elapsed = self.elapsed_
            if reset:
                self.elapsed_ = 0.0
            return elapsed

        def reset(self):
            self._spans = []
            self.elapsed_ = 0.0
            self.started_ = False

        def mean(self):
            self._fold()
            return (sum(self.records) / len(self.records)
                    if self.records else 0.0)

    def __init__(self, accelerator=None):
        if accelerator is None:
            from ..accelerator import get_accelerator
            accelerator = get_accelerator()
        self._acc = accelerator
        self.timers = {}

    def synchronize(self):
        self._acc.synchronize()

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self._acc)
        return self.timers[name]

    def get_timers(self):
        return self.timers

    def memory_usage(self):
        alloc = self._acc.memory_allocated() / (1024**3)
        peak = self._acc.max_memory_allocated() / (1024**3)
        return f"mem_alloc={alloc:.2f}GB peak={peak:.2f}GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False,
            ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1e3
                string += f" | {name}: {ms / normalizer:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])
        return string


class NoopTimer:
    """Reference ``timer.py:164``: the stand-in when timing is off."""

    class Timer:

        def start(self, **kwargs):
            ...

        def stop(self, **kwargs):
            ...

        def reset(self):
            ...

        def elapsed(self, **kwargs):
            return 0.0

        def mean(self):
            return 0.0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def get_timers(self):
        return {}

    def log(self, names, **kwargs):
        ...

