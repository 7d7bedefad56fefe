"""The port's supervision modules (``utils/watchdog.py``, ``utils/retry.py``)
through the scenarios of ``tests/test_watchdog.py``, with short knobs and
shell children (which start in milliseconds): a hung child is killed and
retried, silence is judged against progress, the deadline yields to
progress up to the hard cap, the probe gate runs on every attempt, the
deadline grows when the flagship must be trained first.  The probe asks
the CUDA card: on a host without one it answers False.  ``is_transient``
answers as the JAX package's on the same exceptions, and
``run_with_retry`` retries only those.
"""

import time

import pytest

from rgbd_pifuhd_tpu.utils import retry as jretry
from rgbd_pifuhd_tpu_torch.utils import retry, watchdog


def _sh(script: str):
    return ["sh", "-c", script]


def test_kills_hung_child_and_retries(tmp_path, monkeypatch, capsys):
    marker = tmp_path / "ran"
    monkeypatch.setenv("BENCH_DEADLINE_S", "1")
    with pytest.raises(SystemExit) as ei:
        watchdog.run_watchdog(_sh(f"[ -e {marker} ] && exit 0; "
                                  f"touch {marker}; sleep 60"),
                              retry_sleep=0.0)
    assert ei.value.code == 0
    assert "backend hang" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ei:       # every attempt hangs
        watchdog.run_watchdog(_sh("sleep 60"), retry_sleep=0.0, attempts=2)
    assert "all attempts" in str(ei.value.code)
    with pytest.raises(SystemExit) as ei:       # the child's exit status
        watchdog.run_watchdog(_sh("exit 3"), retry_sleep=0.0)
    assert ei.value.code == 3


def test_silence_rule_is_progress_aware(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEADLINE_S", "60")
    monkeypatch.setenv("BENCH_SILENCE_S", "1.5")
    with pytest.raises(SystemExit) as ei:
        watchdog.run_watchdog(_sh(
            "for i in 1 2 3 4 5 6; do echo heartbeat $i; sleep 0.4; done; "
            "echo '{\"metric\": \"ok\"}'"), retry_sleep=0.0)
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert '{"metric": "ok"}' in out and "heartbeat 6" in out
    t0 = time.time()
    with pytest.raises(SystemExit) as ei:       # one line, then silence
        watchdog.run_watchdog(_sh("echo starting; sleep 60"),
                              retry_sleep=0.0, attempts=1)
    assert "all attempts" in str(ei.value.code)
    assert time.time() - t0 < 20                # not the 60 s deadline
    assert "silent for 2s" in capsys.readouterr().err


def test_deadline_yields_to_progress(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEADLINE_S", "1")
    monkeypatch.setenv("BENCH_SILENCE_S", "60")
    monkeypatch.setenv("BENCH_HARD_CAP_S", "3")
    t0 = time.time()
    with pytest.raises(SystemExit) as ei:
        watchdog.run_watchdog(_sh(
            "i=0; while [ $i -lt 100 ]; do echo beat $i; i=$((i+1)); "
            "sleep 0.2; done"), retry_sleep=0.0, attempts=1)
    assert "all attempts" in str(ei.value.code)
    err = capsys.readouterr().err
    assert "hard cap" in err and "stale" not in err
    assert time.time() - t0 > 3.0               # lived past the deadline


def test_wait_for_tunnel(monkeypatch, capsys):
    seq = iter([False, False, True])
    sleeps = []
    monkeypatch.setattr(watchdog, "tunnel_alive", lambda t=150.0: next(seq))
    monkeypatch.setattr(watchdog.time, "sleep", sleeps.append)
    watchdog.wait_for_tunnel(budget_s=1000.0, sleep_s=10.0)
    assert sleeps == [10.0, 10.0]
    assert "tunnel hung" in capsys.readouterr().err
    monkeypatch.setattr(watchdog, "tunnel_alive", lambda t=150.0: False)
    sleeps.clear()
    watchdog.wait_for_tunnel(budget_s=5.0, sleep_s=10.0)
    assert sleeps == []
    assert "proceeding under the attempt deadline" in \
        capsys.readouterr().err


def test_probe_gate_runs_per_attempt(tmp_path, monkeypatch):
    probes = []
    monkeypatch.setattr(watchdog, "wait_for_tunnel",
                        lambda budget_s, **k: probes.append(budget_s))
    monkeypatch.setenv("BENCH_PROBE_WAIT_S", "123")
    monkeypatch.setenv("BENCH_DEADLINE_S", "1")
    marker = tmp_path / "second"
    with pytest.raises(SystemExit) as ei:
        watchdog.run_watchdog(_sh(f"[ -e {marker} ] && exit 0; "
                                  f"touch {marker}; sleep 60"),
                              retry_sleep=0.0, probe=True)
    assert ei.value.code == 0
    assert probes == [123.0, 123.0]
    probes.clear()
    with pytest.raises(SystemExit):
        watchdog.run_watchdog(_sh("exit 0"), retry_sleep=0.0)
    assert probes == []


def test_probe_asks_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe answers True")
    assert watchdog.tunnel_alive(timeout_s=120.0) is False


def test_default_deadline_grows_when_training(tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("RGBD_PIFUHD_FLAGSHIP_CKPT", str(ckpt))
    monkeypatch.delenv("BENCH_TRAIN_FLAGSHIP", raising=False)
    assert watchdog.default_deadline_s() == 4200.0
    monkeypatch.setenv("BENCH_TRAIN_FLAGSHIP", "0")
    assert watchdog.default_deadline_s() == 2400.0
    monkeypatch.setenv("BENCH_TRAIN_FLAGSHIP", "1")
    ckpt.write_text("x")
    assert watchdog.default_deadline_s() == 2400.0


_ERRORS = [RuntimeError("read body: response body closed before all bytes"),
           RuntimeError("INTERNAL: remote_compile failed"),
           OSError("Connection reset by peer"), ValueError("shape mismatch"),
           RuntimeError("CUDA error: an illegal memory access"),
           TimeoutError("DEADLINE_EXCEEDED"), KeyError("UNAVAILABLE"),
           ZeroDivisionError("division by zero")]


def test_is_transient_matches_jax():
    assert retry.TRANSIENT_SIGNATURES == jretry.TRANSIENT_SIGNATURES
    got = [retry.is_transient(e) for e in _ERRORS]
    assert got == [jretry.is_transient(e) for e in _ERRORS]
    assert got == [True, True, True, False, False, True, True, False]


def test_run_with_retry(monkeypatch):
    sleeps = []
    monkeypatch.setattr(retry.time, "sleep", sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: socket")
        return "ok"

    assert retry.run_with_retry(flaky, label="x") == "ok"
    assert sleeps == [5.0, 10.0]
    calls.clear()
    with pytest.raises(ValueError):
        retry.run_with_retry(lambda: calls.append(1) or int("x"))
    assert len(calls) == 1                      # not transient: no retry
    with pytest.raises(RuntimeError):
        retry.run_with_retry(lambda: (_ for _ in ()).throw(
            RuntimeError("INTERNAL")), attempts=2)
