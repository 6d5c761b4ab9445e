"""Comms logger (the port of ``deepspeed_tpu/utils/comms_logging.py``;
reference ``deepspeed/utils/comms_logging.py:67``): per-op counts, sizes
and latencies, with algorithmic and bus bandwidth.

A collective on the card is timed by two CUDA events recorded around its
launch; the elapsed time is read only when a summary is asked for
(:meth:`CommsLogger.resolve`), so logging adds no host sync to the step.
An async collective is recorded once, at its launch; its end event comes
when its handle is waited on.  On the CPU the events are the host clock's.

A collective the collectives engine (``comm/collectives``) ran on a
quantized or hierarchical variant is recorded as ``op[variant]`` with its
*wire* bytes (what the links carried) beside its message size; the
bandwidths are the wire's.  A flat op's wire is its message size.
"""

from .logging import log_dist, logger


def get_msg_size_from_args(x):
    try:
        return int(x.numel()) * x.element_size()
    except AttributeError:
        return 0


def calc_bw_log(comm_op, size, duration, n):
    """(algbw, busbw) in Gbps for ``size`` bytes in ``duration`` seconds
    over ``n`` ranks (nccl-tests' factors, as the reference's ``get_bw``)."""
    if duration <= 0:
        return 0.0, 0.0
    comm_op = comm_op.split("[", 1)[0]
    tput = size / duration
    if comm_op in ("all_to_all", "all_to_all_single", "all_gather",
                   "all_gather_into_tensor", "reduce_scatter",
                   "reduce_scatter_tensor"):
        busbw = tput * ((n - 1) / n)
    elif comm_op in ("all_reduce", "inference_all_reduce"):
        busbw = tput * (2 * (n - 1) / n)
    else:  # send/recv/broadcast/reduce/barrier
        busbw = tput
    return tput * 8 / 1e9, busbw * 8 / 1e9


class CommsLogger:

    def __init__(self, enabled=False, verbose=False, prof_all=True,
                 debug=False, prof_ops=None):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.prof_ops = prof_ops or []
        self.comms_dict = {}
        # [name, msg_size, world, start, end, wire, variant] events
        self._pending = []

    def configure(self, comms_config):
        self.enabled = comms_config.comms_logger_enabled
        if self.enabled:
            c = comms_config.comms_logger
            self.verbose = c.verbose
            self.prof_all = c.prof_all
            self.debug = c.debug
            self.prof_ops = list(c.prof_ops)

    def should_log(self, name):
        return self.enabled and (self.prof_all or name in self.prof_ops)

    def record(self, name, msg_size, world_size, start, end, wire_size=None,
               variant=None):
        """One collective, timed by two recorded events; its latency is
        read at the next :meth:`resolve`.  Returns the entry, whose ``end``
        (item 4; None for an async op not yet waited on) may be set
        later."""
        entry = [name, msg_size, world_size, start, end, wire_size, variant]
        self._pending.append(entry)
        return entry

    def resolve(self):
        """Fold the recorded events into the table (waits for each op's
        end event; an async op never waited on ends at its start)."""
        pending, self._pending = self._pending, []
        for name, msg_size, world, start, end, wire, variant in pending:
            end = start if end is None else end
            end.synchronize()
            self.append(name, name, start.elapsed_time(end) / 1e3, msg_size,
                        world, wire_size=wire, variant=variant)

    def reset(self):
        self.comms_dict = {}
        self._pending = []

    def append(self, raw_name, record_name, latency, msg_size, world_size,
               wire_size=None, variant=None):
        """One collective into the table: ``msg_size`` the logical bytes,
        ``wire_size`` the transported ones (the message size when None);
        entry slot 4 sums the row's wire bytes, each call once."""
        wire = wire_size if wire_size is not None else msg_size
        name = f"{record_name}[{variant}]" if variant else record_name
        raw = f"{raw_name}[{variant}]" if variant else raw_name
        algbw, busbw = calc_bw_log(raw, wire, latency, world_size)
        sizes = self.comms_dict.setdefault(name, {})
        if msg_size in sizes:
            entry = sizes[msg_size]
            entry[0] += 1
            entry[1].append(latency)
            entry[2].append(algbw)
            entry[3].append(busbw)
            entry[4] += wire
        else:
            sizes[msg_size] = [1, [latency], [algbw], [busbw], wire]
        if self.verbose:
            log_dist(f"comm op: {name} | time(ms): {latency * 1000:.2f} | "
                     f"msg size: {msg_size} | wire size: {wire} | "
                     f"algbw(Gbps): {algbw:.2f} | busbw(Gbps): {busbw:.2f}",
                     ranks=[0])

    def counts(self):
        """{op name: calls recorded}, pending ones included."""
        self.resolve()
        return {name: sum(e[0] for e in sizes.values())
                for name, sizes in self.comms_dict.items()}

    def log_all(self, print_log=True, show_straggler=False):
        self.resolve()
        lines = [f"{'Comm. Op (variant)':<28}{'Message Size':<16}"
                 f"{'Wire Size':<14}{'Count':<8}"
                 f"{'Total Latency(ms)':<20}{'Avg Latency(ms)':<18}"
                 f"{'tput_avg (Gbps)':<18}{'busbw_avg (Gbps)':<18}"]
        for record_name, sizes in sorted(self.comms_dict.items()):
            lines.append(record_name)
            for msg_size, (count, latencies, algbws, busbws,
                           wire_total) in sorted(sizes.items()):
                total = sum(latencies) * 1000
                lines.append(f"{'':<28}{msg_size:<16}"
                             f"{wire_total // count:<14}{count:<8}"
                             f"{total:<20.2f}{total / count:<18.2f}"
                             f"{sum(algbws) / len(algbws):<18.2f}"
                             f"{sum(busbws) / len(busbws):<18.2f}")
        if print_log:
            logger.info("\n".join(lines))
        return self.comms_dict

    def get_summary_dict(self):
        """The table as data (the JAX logger's keys): ``{"ops": {"op" or
        "op[variant]": {base_op, variant, count, total_latency_ms,
        avg_latency_ms, total_msg_bytes, total_wire_bytes, algbw_gbps_avg,
        busbw_gbps_avg, msg_sizes}}, "totals": {base op: {count,
        total_latency_ms, total_msg_bytes, total_wire_bytes,
        variants}}}``, each call counted once in its variant's row and
        once in its base op's total."""
        self.resolve()
        ops, totals = {}, {}
        for name, sizes in sorted(self.comms_dict.items()):
            if "[" in name and name.endswith("]"):
                base, variant = name[:-1].split("[", 1)
            else:
                base, variant = name, None
            op = {"base_op": base, "variant": variant, "count": 0,
                  "total_latency_ms": 0.0, "total_msg_bytes": 0,
                  "total_wire_bytes": 0, "msg_sizes": {}}
            alg_all, bus_all = [], []
            for msg_size, (count, latencies, algbws, busbws,
                           wire_total) in sorted(sizes.items()):
                total_ms = sum(latencies) * 1000
                op["msg_sizes"][int(msg_size)] = {
                    "count": count, "total_latency_ms": total_ms,
                    "avg_latency_ms": total_ms / count,
                    "wire_bytes_per_call": wire_total // count,
                    "algbw_gbps_avg": sum(algbws) / len(algbws),
                    "busbw_gbps_avg": sum(busbws) / len(busbws)}
                op["count"] += count
                op["total_latency_ms"] += total_ms
                op["total_msg_bytes"] += int(msg_size) * count
                op["total_wire_bytes"] += int(wire_total)
                alg_all += algbws
                bus_all += busbws
            op["avg_latency_ms"] = op["total_latency_ms"] / op["count"]
            op["algbw_gbps_avg"] = sum(alg_all) / len(alg_all)
            op["busbw_gbps_avg"] = sum(bus_all) / len(bus_all)
            ops[name] = op
            t = totals.setdefault(base, {"count": 0, "total_latency_ms": 0.0,
                                         "total_msg_bytes": 0,
                                         "total_wire_bytes": 0,
                                         "variants": []})
            for key in ("count", "total_latency_ms", "total_msg_bytes",
                        "total_wire_bytes"):
                t[key] += op[key]
            t["variants"].append(variant or "flat")
        return {"ops": ops, "totals": totals}
