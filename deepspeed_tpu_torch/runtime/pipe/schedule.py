"""Pipeline schedules (the port of ``deepspeed_tpu/runtime/pipe/
schedule.py``; reference ``runtime/pipe/schedule.py``): the
``PipeInstruction`` taxonomy, ``TrainSchedule`` (1F1B),
``InferenceSchedule`` and ``DataParallelSchedule``.

Each stage's compute order is written down from the 1F1B invariants, and
a small dependency-driven clock simulation aligns the communication ticks
across stages: every Send is emitted on the producer in the same tick as
the consumer's Recv.  The JAX package keeps these streams as a parity
artifact beside its fused program; here they are what
``runtime/pipe/engine.py`` executes, one stage a process, each tick's
sends and receives batched into one exchange.  The file holds no
framework code and is a copy of the JAX one, so both give the same
streams.
"""


# --------------------------------------------------------------------------
# Instruction taxonomy (names are the reference's public vocabulary)
# --------------------------------------------------------------------------
class PipeInstruction:

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{self.name}({args})" if args else self.name

    def __eq__(self, other):
        return (self.__class__ == other.__class__
                and self.kwargs == other.kwargs)


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# --------------------------------------------------------------------------
# Per-stage compute orders
# --------------------------------------------------------------------------
def one_f1b_order(micro_batches, stages, stage_id):
    """The 1F1B compute order for one stage, from its defining invariants:

    * warmup: stage s starts with ``stages - 1 - s`` forwards so the last
      stage can begin alternating immediately (bounded in-flight work);
    * steady state: strictly alternate forward/backward;
    * drain: the backwards that warmup deferred.

    Returns a list of ("F"|"B", microbatch_id).
    """
    M = micro_batches
    warmup = min(stages - 1 - stage_id, M)
    order = [("F", m) for m in range(warmup)]
    for i in range(M - warmup):
        order.append(("F", warmup + i))
        order.append(("B", i))
    for m in range(M - warmup, M):
        order.append(("B", m))
    return order


def forward_order(micro_batches, stages, stage_id):
    """Forward-only streaming order (inference)."""
    return [("F", m) for m in range(micro_batches)]


def _simulate(orders, stages):
    """Greedy clock simulation of per-stage compute orders under the data
    dependencies F(m)@s ← F(m)@s-1 and B(m)@s ← B(m)@s+1 (+ F(m)@s).

    Returns ``done``: {(kind, m, stage): tick}, and the tick count.  Each
    stage runs at most one compute per tick, at the earliest tick whose
    dependencies completed on a *strictly earlier* tick.
    """
    cursor = [0] * stages           # next event index per stage
    done = {}
    tick = 0
    while any(cursor[s] < len(orders[s]) for s in range(stages)):
        progressed = False
        scheduled = []
        for s in range(stages):
            if cursor[s] >= len(orders[s]):
                continue
            kind, m = orders[s][cursor[s]]
            if kind == "F":
                dep = None if s == 0 else ("F", m, s - 1)
            else:
                dep = None if s == stages - 1 else ("B", m, s + 1)
            dep_ok = dep is None or done.get(dep, tick) < tick
            own_ok = kind != "B" or done.get(("F", m, s), tick) < tick
            if dep_ok and own_ok:
                scheduled.append((kind, m, s))
        for kind, m, s in scheduled:
            done[(kind, m, s)] = tick
            cursor[s] += 1
            progressed = True
        tick += 1
        if not progressed and tick > 4 * sum(map(len, orders)) + 8:
            raise RuntimeError("pipeline schedule deadlock (bug)")
    return done, tick


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------
class PipeSchedule:
    """Iterable of per-tick instruction lists for ``stage_id``."""

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id

    # -- geometry helpers
    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def num_pipe_buffers(self):
        """In-flight microbatches at this stage: a microbatch's buffer is
        live from its forward until its backward, and 1F1B keeps at most
        ``stages - stage_id`` in flight (≥2 for double-buffered comm)."""
        return max(2, min(self.stages - self.stage_id, self.micro_batches))

    def _buffer(self, m):
        return m % self.num_pipe_buffers()

    # -- stream construction
    def _orders(self):
        raise NotImplementedError

    def _tail(self):
        """Instructions appended after the final compute tick."""
        return []

    def steps(self):
        """Yield the per-tick instruction lists for this stage."""
        make_order = self._orders()
        orders = [make_order(s) for s in range(self.stages)]
        done, ticks = _simulate(orders, self.stages)
        by_tick = {}
        for (kind, m, s), t in done.items():
            by_tick.setdefault(t, []).append((kind, m, s))

        for t in range(ticks):
            cmds = []
            events = sorted(by_tick.get(t, []))
            mine = [(k, m) for (k, m, s) in events if s == self.stage_id]
            # comm first: a Recv on this stage pairs with the producer's Send
            # in the SAME tick (synchronous pairwise exchange)
            for kind, m, s in events:
                if kind == "F" and s == self.stage_id and s > 0:
                    cmds.append(RecvActivation(self._buffer(m)))
                if kind == "F" and s == self.stage_id + 1:
                    cmds.append(SendActivation(self._buffer(m)))
                if kind == "B" and s == self.stage_id and s < self.stages - 1:
                    cmds.append(RecvGrad(self._buffer(m)))
                if kind == "B" and s == self.stage_id - 1:
                    cmds.append(SendGrad(self._buffer(m)))
            for kind, m in mine:
                if kind == "F":
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(self._buffer(m)))
                    cmds.append(ForwardPass(self._buffer(m)))
                else:
                    cmds.append(BackwardPass(self._buffer(m)))
            if t == ticks - 1:
                cmds.extend(self._tail())
            yield cmds

    def __iter__(self):
        return iter(list(self.steps()))


class TrainSchedule(PipeSchedule):
    """1F1B training schedule."""

    def _orders(self):
        return lambda s: one_f1b_order(self.micro_batches, self.stages, s)

    def _tail(self):
        return [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]


class InferenceSchedule(PipeSchedule):
    """Forward-only streaming."""

    def _orders(self):
        return lambda s: forward_order(self.micro_batches, self.stages, s)

    def num_pipe_buffers(self):
        return min(2, self.micro_batches)


class DataParallelSchedule(PipeSchedule):
    """Single-stage degenerate schedule (gradient accumulation only)."""

    def steps(self):
        for m in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if m == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1
