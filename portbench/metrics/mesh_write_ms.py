"""Host ms per mesh writing the OBJ (the pipeline's ``mesh_write`` span,
``native/meshio.cc``)."""


def read(run):
    v = [r["host_secs"].get("mesh_write") for r in run.get("records", [])
         if r.get("host_secs")]
    v = [x for x in v if x is not None]
    return 1e3 * sum(v) / len(v) if v else None
