"""Transient-failure classification and retry (port of ``utils/retry.py``).

An error whose text carries one of ``TRANSIENT_SIGNATURES`` (a dropped
link to the device's runtime: "response body", ``UNAVAILABLE``,
"Connection reset", ...) is environmental, not a fault of the code, and
callers retry it.  Anything else re-raises at once.  The signatures and
the pauses are the JAX package's.
"""

from __future__ import annotations

import time

TRANSIENT_SIGNATURES = (
    "remote_compile", "response body", "INTERNAL", "UNAVAILABLE",
    "DEADLINE_EXCEEDED", "Connection reset", "Socket closed")


def is_transient(e: BaseException) -> bool:
    s = f"{type(e).__name__}: {e}"
    return any(t in s for t in TRANSIENT_SIGNATURES)


def run_with_retry(fn, attempts: int = 3, label: str = ""):
    """Call ``fn``; retry a transient error after a pause of 5 s times the
    attempt number, up to ``attempts`` calls in all."""
    for k in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered by is_transient
            if k + 1 >= attempts or not is_transient(e):
                raise
            import sys
            print(f"[bench] transient backend error in {label or 'step'} "
                  f"(attempt {k + 1}/{attempts}): {e}", file=sys.stderr)
            time.sleep(5.0 * (k + 1))
