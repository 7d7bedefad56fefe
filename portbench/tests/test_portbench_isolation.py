"""Nothing the benchmark runs loads JAX, flax or the JAX package: the
harness, every entry, every metric reader and the reference are imported
in a fresh process and the top-level names of ``sys.modules`` are
compared whole.  The reference alone also loads nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_ALL = r"""
import glob, json, os, sys
sys.path.insert(0, ROOT)
import portbench.run as R
for f in sorted(glob.glob(os.path.join(ROOT, "portbench", "entries", "*.py"))
                + glob.glob(os.path.join(ROOT, "portbench", "metrics", "*.py"))):
    R.load_module(f, "m_" + os.path.basename(f).replace(".", "_"))
import portbench.reference.model, portbench.reference.check_mesh
import portbench.reference.check_train, portbench.reference.checkpoint
import portbench.trace, portbench.flops, portbench.gen.subjects
import rgbd_pifuhd_tpu_torch.cli.serve, rgbd_pifuhd_tpu_torch.train.loop
import rgbd_pifuhd_tpu_torch.cli.common
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REF = r"""
import json, sys
sys.path.insert(0, ROOT)
import portbench.reference.model, portbench.reference.check_mesh
import portbench.reference.check_train, portbench.reference.checkpoint
import portbench.gen.subjects, portbench.flops
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + code],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, USE_FLAX="0"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(_ALL)
    assert "rgbd_pifuhd_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rgbd_pifuhd_tpu"}


def test_reference_loads_no_program():
    names = _top_level(_REF)
    assert not names & {"jax", "jaxlib", "flax", "rgbd_pifuhd_tpu",
                        "rgbd_pifuhd_tpu_torch"}
