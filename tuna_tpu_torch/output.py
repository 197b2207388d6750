"""Console logging, error handling and phase timers.

TPU-native counterpart of the reference logging/timer utilities
(/root/reference/TUNA/tuna_util.py:916-1271): a priority-gated logger driven
by the PRINTLEVEL / T / P / DEBUG keywords, a TunaError exception caught once
at top level, and a named-phase wall-clock timer registry.  Device work is
bracketed with jax.block_until_ready by callers so timings are honest.
"""

from __future__ import annotations

import sys
import time


class TunaError(Exception):
    """Fatal, user-facing calculation error."""


def error(message: str):
    raise TunaError(f"\nERROR: {message}")


def check(condition: bool, message: str):
    if not condition:
        error(message)


def warning(message: str, space: int = 0):
    print(" " * space + f"WARNING: {message}")


def _print_level(calculation) -> int:
    if calculation is None:
        return 2
    level = getattr(calculation, "print_level", 2)
    if getattr(calculation, "terse", False):
        level = min(level, 1)
    if getattr(calculation, "additional_print", False):
        level = max(level, 3)
    if getattr(calculation, "debug", False):
        level = 4
    return level


def log(message: str, calculation=None, priority: int = 1, *, silent: bool = False,
        end: str = "\n", colour: str | None = None):
    """Print `message` if the calculation's print level is >= priority."""
    if silent or (calculation is not None and getattr(calculation, "suppress_output", False)):
        return
    if _print_level(calculation) >= priority:
        print(message, end=end)
        sys.stdout.flush()


def log_spacer(calculation=None, priority: int = 1, *, silent: bool = False, start: str = "", space: str = " "):
    log(start + space + "~" * 53, calculation, priority, silent=silent)


def log_big_spacer(calculation=None, priority: int = 1, *, silent: bool = False, start: str = "", space: str = " "):
    log(start + space + "~" * 103, calculation, priority, silent=silent)


# --- Named-phase timer registry ------------------------------------------

_timer_starts: dict[str, float] = {}
_timer_totals: dict[str, float] = {}


def timer(name: str, action: int) -> None:
    """action 0 starts (or resumes) the named timer; 1 stops it."""
    if action == 0:
        _timer_starts[name] = time.perf_counter()
    else:
        start = _timer_starts.pop(name, None)
        if start is not None:
            _timer_totals[name] = _timer_totals.get(name, 0.0) + time.perf_counter() - start


def timer_table() -> list[tuple[str, float]]:
    return sorted(_timer_totals.items(), key=lambda kv: -kv[1])


def reset_timers() -> None:
    _timer_starts.clear()
    _timer_totals.clear()


def finish_calculation(calculation) -> None:
    """Print the sorted timing table and total elapsed time."""
    total = time.perf_counter() - getattr(calculation, "start_time", time.perf_counter())
    if _print_level(calculation) >= 3 and not getattr(calculation, "suppress_output", False):
        log_spacer(calculation, 3)
        log("                  Time Taken per Module", calculation, 3)
        log_spacer(calculation, 3)
        for name, elapsed in timer_table():
            log(f"  {name:<40s}{elapsed:10.3f} s", calculation, 3)
        log_spacer(calculation, 3)
    log(f"\n Calculation finished in {total:.2f} seconds.\n", calculation, 1)
