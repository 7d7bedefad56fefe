"""Mean of the single-subject replies' ``read_secs`` (the reader's decode
and resize of the subject), ms."""


def read(run):
    v = [r["read_secs"] for r in run.get("replies", []) if "read_secs" in r]
    return 1e3 * sum(v) / len(v) if v else None
