"""Env-driven fault-injection harness (SURVEY §5.3 failure paths).

Hook points are compiled into the real code paths (parallel init, the
optimizer train step, the watchdog's heartbeat publisher) and stay ~free
when disarmed: `inject()` is a no-op unless a PADDLE_FI_* var is set.

Knobs (registered in testing.FI_ENV_VARS):

  PADDLE_FI_KILL_RANK=<r>       rank r hard-exits (os._exit(FI_EXIT_CODE))
  PADDLE_FI_HANG=<r>            rank r hangs (bounded sleep, supervisor's
                                problem) instead of exiting
  PADDLE_FI_AT_STEP=<n>         gate KILL/HANG to train-step n ("step"
                                hook); unset -> they fire at "init"
  PADDLE_FI_AT_POINT=<name>     target a NAMED hook point instead
                                ("init" | "step" | "collective" — the
                                flight-recorder choke point — or
                                "migration" — the router's live-slot
                                transfer, fired BETWEEN export and
                                import so the state is off the source
                                but on no target, the worst moment —
                                or "preempt" — the engine's QoS
                                preemption-to-host, fired AFTER the
                                slot is freed but BEFORE the parking-
                                lot insert, so the parked copy is lost
                                and the router's classic failover must
                                pick the stream up exactly-once);
                                KILL/HANG/RAISE fire at the AT_STEP-th
                                occurrence of that point (unset
                                AT_STEP = the first).
                                "collective" requires the flight
                                recorder to be enabled (the hook rides
                                its choke point) — the desync e2e's
                                lever: wedge one rank at its Nth
                                collective entry, BEFORE the entry is
                                recorded, so peers' dumps show the
                                collective in flight and the wedged
                                rank's shows it never entered
  PADDLE_FI_DROP_HEARTBEAT=<r>  rank r's heartbeat publisher goes dark
                                (the process stays alive: the watchdog on
                                the PEERS must convert this into a
                                PeerFailureError)
  PADDLE_FI_RAISE=<r>           rank r RAISES FaultInjected at the
                                point instead of exiting — the
                                in-process fault flavor (a single-
                                process cluster cannot os._exit to
                                simulate a peer dying mid-transfer;
                                the caller's abort path must handle
                                the exception exactly like a transport
                                error)
  PADDLE_FI_SLOW_MS=<ms>        GRAY-FAILURE flavor: the named point
                                (PADDLE_FI_SLOW_POINT, default "step")
                                sleeps <ms> on EVERY occurrence from
                                the PADDLE_FI_AT_STEP-th onward (unset
                                AT_STEP = from the first). Unlike
                                KILL/HANG/RAISE this is PERSISTENT —
                                a slow replica stays slow until the
                                env is cleared — because gray failure
                                is a condition, not an event. The
                                process stays alive and keeps beating
                                its heartbeat: the router's health
                                scoring / circuit breaker, not death
                                detection, must shed it.
  PADDLE_FI_SLOW_POINT=<name>   which hook point the slowness rides
                                (any inject() point name)
  PADDLE_FI_RPC_DELAY_MS=<ms>   flaky-transport: every rpc client
                                call sleeps <ms> before the wire
  PADDLE_FI_RPC_ERR_RATE=<f>    flaky-transport: fraction of rpc
                                client calls (deterministic
                                accumulator, not random) that raise
                                FaultInjected instead of sending —
                                the caller must treat it exactly like
                                a transport error (ReplicaError path)

Injections fire at most once per process (a restarted generation whose
env cleared the vars is unaffected; one that kept them re-injects —
companions gate on PADDLE_RESTART_COUNT to fault only generation 0).
The SLOW and RPC flavors are the exception: they model a *condition*
(degraded host, lossy link) and fire on every qualifying call.
"""
from __future__ import annotations

import os
import time

from . import FI_ENV_VARS

__all__ = ["inject", "heartbeat_dropped", "step_count", "reset",
           "slow_s", "rpc_flaky", "FaultInjected", "FI_EXIT_CODE",
           "HANG_BOUND_S"]

FI_EXIT_CODE = 43          # distinctive: never collides with signal codes
HANG_BOUND_S = 3600.0      # a "hang" is a bounded sleep, not a true wedge


class FaultInjected(RuntimeError):
    """Raised by the PADDLE_FI_RAISE flavor: an injected in-process
    failure the exercised code path must degrade from (e.g. a migration
    transfer dying mid-flight -> classic failover fallback)."""

_steps = 0                 # "step"-point calls observed in this process
_point_counts: dict = {}   # point -> calls observed (AT_POINT mode)
_slow_counts: dict = {}    # point -> calls observed (SLOW gating)
_fired = False
_rpc_calls = 0             # rpc client calls observed (flaky accounting)
_rpc_errs = 0              # flaky errors already raised


def reset():
    """Re-arm the harness (in-process tests; subprocesses never need it)."""
    global _steps, _fired, _rpc_calls, _rpc_errs
    _steps, _fired = 0, False
    _rpc_calls, _rpc_errs = 0, 0
    _point_counts.clear()
    _slow_counts.clear()


def step_count() -> int:
    return _steps


def _rank() -> str:
    return os.environ.get("PADDLE_TRAINER_ID", "0")


def _armed() -> bool:
    return any(os.environ.get(v) not in (None, "") for v in FI_ENV_VARS)


def heartbeat_dropped(rank=None) -> bool:
    """Consulted by the watchdog's publisher before every beat."""
    r = str(rank) if rank is not None else _rank()
    return os.environ.get("PADDLE_FI_DROP_HEARTBEAT") == r


def slow_s(point: str) -> float:
    """Seconds of injected slowness for THIS occurrence of `point`.

    Advances the point's private occurrence counter; returns 0.0 when
    disarmed or before the PADDLE_FI_AT_STEP-th occurrence. Persistent:
    every occurrence from the threshold onward is slowed (gray failure
    is a condition, not a one-shot event), so `_fired` is not consulted.
    """
    ms = os.environ.get("PADDLE_FI_SLOW_MS")
    if ms in (None, ""):
        return 0.0
    target = os.environ.get("PADDLE_FI_SLOW_POINT", "step") or "step"
    if point != target:
        return 0.0
    idx = _slow_counts.get(point, 0)
    _slow_counts[point] = idx + 1
    at = os.environ.get("PADDLE_FI_AT_STEP")
    if at not in (None, "") and idx < int(at):
        return 0.0
    return float(ms) / 1000.0


def rpc_flaky():
    """Flaky-transport hook: called by the rpc client before every call.

    Applies PADDLE_FI_RPC_DELAY_MS as a pre-wire sleep, then raises
    FaultInjected for a PADDLE_FI_RPC_ERR_RATE fraction of calls. The
    error schedule is a DETERMINISTIC accumulator (fire whenever the
    running error count falls behind rate * calls), not a coin flip —
    chaos drills must reproduce bit-for-bit across runs.
    """
    global _rpc_calls, _rpc_errs
    delay = os.environ.get("PADDLE_FI_RPC_DELAY_MS")
    rate = os.environ.get("PADDLE_FI_RPC_ERR_RATE")
    if delay in (None, "") and rate in (None, ""):
        return
    _rpc_calls += 1
    if delay not in (None, ""):
        time.sleep(float(delay) / 1000.0)
    if rate not in (None, ""):
        if _rpc_errs < int(float(rate) * _rpc_calls):
            _rpc_errs += 1
            raise FaultInjected(
                f"injected rpc transport error (call {_rpc_calls})")


def _should_fire(point: str) -> bool:
    """Gating + counter bookkeeping for one inject() call.

    PADDLE_FI_AT_POINT set: KILL/HANG target that named point, at its
    AT_STEP-th occurrence (unset AT_STEP = the first occurrence).
    Unset: legacy semantics — "step" fires at step AT_STEP, any other
    point fires iff AT_STEP is unset.
    """
    global _steps
    at_point = os.environ.get("PADDLE_FI_AT_POINT")
    at = os.environ.get("PADDLE_FI_AT_STEP")
    if at_point not in (None, ""):
        idx = _point_counts.get(point, 0)
        _point_counts[point] = idx + 1
        if point == "step":
            _steps += 1        # step_count() keeps counting in this mode
        return point == at_point and (at is None or idx == int(at))
    if point == "step":
        hit = at is not None and _steps == int(at)
        _steps += 1
        return hit
    return at is None


def inject(point: str, rank=None):
    """Run the injections registered for `point` ("init" | "step").

    The "step" point also advances the harness step counter, so
    PADDLE_FI_AT_STEP indexes optimizer steps 0, 1, 2, ... regardless of
    where the caller is in its own loop.
    """
    global _steps, _fired
    if not _armed():
        return
    d = slow_s(point)          # gray-failure flavor: slow, don't die
    if d > 0.0:
        time.sleep(d)
    hit = _should_fire(point)
    if not hit or _fired:
        return
    r = str(rank) if rank is not None else _rank()
    if os.environ.get("PADDLE_FI_RAISE") == r:
        _fired = True
        print(f"paddle_tpu_torch.testing.fault: rank {r} RAISING at {point}",
              flush=True)
        raise FaultInjected(f"injected fault at point {point!r}")
    if os.environ.get("PADDLE_FI_HANG") == r:
        _fired = True
        print(f"paddle_tpu_torch.testing.fault: rank {r} HANGING at {point} "
              f"(step {_steps - 1 if point == 'step' else '-'})", flush=True)
        time.sleep(HANG_BOUND_S)
        os._exit(FI_EXIT_CODE)   # the bound expired without a supervisor
    if os.environ.get("PADDLE_FI_KILL_RANK") == r:
        _fired = True
        print(f"paddle_tpu_torch.testing.fault: rank {r} KILLED at {point} "
              f"(step {_steps - 1 if point == 'step' else '-'})", flush=True)
        os._exit(FI_EXIT_CODE)
