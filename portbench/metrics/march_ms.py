"""Host ms per mesh in the native marcher (``host_secs["march"]``)."""


def read(run):
    v = [r["host_secs"].get("march") for r in run.get("records", [])
         if r.get("host_secs")]
    v = [x for x in v if x is not None]
    return 1e3 * sum(v) / len(v) if v else None
