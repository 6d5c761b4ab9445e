"""Deterministic fault injection for resilience testing (the port of
``deepspeed_tpu/utils/fault_injection.py``, the same spec parser and sites).

Production code is instrumented with named *fault points* — cheap no-ops
unless a fault is armed — and tests (in process, or in a subprocess via
an env var) arm handlers that kill a save mid-write, truncate a checkpoint
file, poison a loss, fail an FS write transiently, or stall a heartbeat.
This is how every recovery path in the resilience subsystem is proven
end-to-end instead of hoped-for.

Instrumented sites (grep for ``fault_point(`` to audit):

====================  =====================================================
site                  fires
====================  =====================================================
``ckpt.save_tree``    before each file of a tag is written (inside the
                      retry loop — a handler that raises tests
                      retry-with-backoff)
``ckpt.mid_write``    after each file of a tag is written, before the next
                      (kill here → partial tag, no manifest, stale latest)
``ckpt.committed``    after manifest + ``latest`` are durable (truncate here
                      → post-commit corruption the manifest check must catch)
====================  =====================================================

The port fires only the three checkpoint sites; ``poison_loss`` and
``stall_heartbeat`` still parse (a spec valid for the JAX package is valid
here) and arm ``engine.poison`` and ``heartbeat.beat``, which no port code
fires yet (the engine's poison hook and the watchdog are ROADMAP queue A
item 12).

Programmatic use (in-process tests)::

    from deepspeed_tpu_torch.utils import fault_injection as fi
    fi.inject("ckpt.save_tree", lambda ctx: ...)
    ...
    fi.clear()

Cross-process use (subprocess workers) via
``DS_TPU_FAULT_INJECT`` — ``;``-separated fault specs, each
``name:key=val,key=val``::

    DS_TPU_FAULT_INJECT="kill_save_mid_write:after=1"
    DS_TPU_FAULT_INJECT="fail_save:times=2;poison_loss:step=3"
    DS_TPU_FAULT_INJECT="truncate_ckpt:file=engine_state.json"
    DS_TPU_FAULT_INJECT="stall_heartbeat:after=2"

``kill_save_mid_write`` calls ``os._exit(17)`` — an un-catchable death that
leaves whatever bytes happen to be on disk, exactly like a preempted host.
"""

import os
import threading

from .logging import logger

#: exit code used by ``kill_save_mid_write`` so harnesses can tell an
#: injected death from an organic crash
KILLED_EXIT_CODE = 17


class FaultError(OSError):
    """Raised by injected transient failures (``fail_save``)."""


class FaultInjector:
    """Registry of site → handlers.  ``fire`` is the hot path: one dict
    lookup when nothing is armed."""

    def __init__(self):
        self._handlers = {}
        self._counts = {}
        self._lock = threading.Lock()
        self._env_spec_loaded = None

    # ------------------------------------------------------------- arming
    def inject(self, site, handler):
        """Arm ``handler(ctx: dict) -> result`` at ``site``.  A handler may
        raise, kill the process, mutate files named in ``ctx``, or return a
        value the instrumented site acts on (see module docstring)."""
        self._handlers.setdefault(site, []).append(handler)
        return handler

    def clear(self):
        """Disarm everything and reset per-site fire counters."""
        self._handlers.clear()
        self._counts.clear()
        self._env_spec_loaded = None

    def count(self, site):
        """How many times ``site`` fired since the last ``clear``."""
        return self._counts.get(site, 0)

    # ------------------------------------------------------------- firing
    def fire(self, site, **ctx):
        """Called from instrumented production code.  Returns the first
        non-None handler result (or None when nothing is armed)."""
        self._maybe_load_env()
        handlers = self._handlers.get(site)
        if not handlers:
            return None
        with self._lock:
            n = self._counts[site] = self._counts.get(site, 0) + 1
        ctx["call"] = n
        out = None
        for h in list(handlers):
            r = h(ctx)
            if out is None and r is not None:
                out = r
        return out

    # ------------------------------------------------------- env-var specs
    def _maybe_load_env(self):
        spec = os.environ.get("DS_TPU_FAULT_INJECT", "")
        if spec == self._env_spec_loaded:
            return
        # spec changed (or first fire): rebuild env-armed handlers; keep
        # programmatic ones (env handlers are tagged)
        for site, hs in list(self._handlers.items()):
            self._handlers[site] = [h for h in hs
                                    if not getattr(h, "_from_env", False)]
        self._env_spec_loaded = spec
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            name, _, argstr = part.partition(":")
            args = {}
            for kv in filter(None, (a.strip() for a in argstr.split(","))):
                k, _, v = kv.partition("=")
                args[k] = v
            try:
                self._install_env_fault(name.strip(), args)
            except KeyError:
                raise ValueError(
                    f"unknown fault {name!r} in DS_TPU_FAULT_INJECT "
                    f"(have: kill_save_mid_write, fail_save, truncate_ckpt, "
                    f"poison_loss, stall_heartbeat)") from None

    def _install_env_fault(self, name, args):
        def env(site, handler):
            handler._from_env = True
            self._handlers.setdefault(site, []).append(handler)

        if name == "kill_save_mid_write":
            after = int(args.get("after", 1))
            tag = args.get("tag")   # None = any tag

            def kill(ctx):
                if tag is not None and str(ctx.get("tag")) != tag:
                    return
                if ctx["call"] >= after:
                    logger.error(
                        "fault injection: dying mid checkpoint write "
                        "(tag=%s sub=%s)", ctx.get("tag"), ctx.get("sub"))
                    os._exit(KILLED_EXIT_CODE)
            env("ckpt.mid_write", kill)
        elif name == "fail_save":
            times = int(args.get("times", 1))

            def fail(ctx):
                if ctx["call"] <= times:
                    raise FaultError(
                        f"injected transient save failure "
                        f"{ctx['call']}/{times}")
            env("ckpt.save_tree", fail)
        elif name == "truncate_ckpt":
            fname = args.get("file", "engine_state.json")

            def truncate(ctx):
                truncate_file_in_tag(ctx["root"], fname)
            env("ckpt.committed", truncate)
        elif name == "poison_loss":
            step = int(args.get("step", 0))
            env("engine.poison", lambda ctx: ctx["step"] == step)
        elif name == "stall_heartbeat":
            after = int(args.get("after", 0))
            env("heartbeat.beat", lambda ctx: ctx["step"] >= after)
        else:
            raise KeyError(name)


def truncate_file_in_tag(root, name):
    """Chop the named checkpoint file (path relative to the tag root, or a
    bare filename searched for recursively) to half its size — the
    post-commit corruption shape (preempted flush, bit rot) manifest
    verification exists to catch."""
    path = os.path.join(root, name)
    if not os.path.exists(path):
        for dirpath, _, files in os.walk(root):
            if name in files:
                path = os.path.join(dirpath, name)
                break
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    logger.error("fault injection: truncated %s (%d → %d bytes)",
                 path, size, size // 2)
    return path


#: process-global injector — production fault points and tests share it
_INJECTOR = FaultInjector()


def fault_point(site, **ctx):
    """The production-side hook.  No-op (one dict lookup + env check) unless
    a fault is armed at ``site``."""
    return _INJECTOR.fire(site, **ctx)


def inject(site, handler):
    return _INJECTOR.inject(site, handler)


def clear():
    _INJECTOR.clear()


def fire_count(site):
    return _INJECTOR.count(site)
