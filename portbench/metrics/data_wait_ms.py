"""Host ms per step that the loop blocked on its next batch (the
benchmark's span around the call into the data iterator)."""


def read(run):
    v = run.get("data_wait_s")
    return 1e3 * sum(v) / len(v) if v else None
