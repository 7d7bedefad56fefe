"""``readings.py`` with the texture pass's faults (``faults_tex.py``) as
well as ``faults.py``'s:

    python3 portbench/tests/readings_tex.py <workload> <seconds> <seed>... \\
        [--control] [--fault <name>] [--colour-f32]

``--colour-f32`` builds the program's texture network at float32 compute
(its parameters are float32 already): a witness, not a fault.  Its
readings against the float32 reference show how much of the sound runs'
``tex_level_share2`` is the bf16 layers' rounding.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench.tests import faults_tex, readings  # noqa: E402


def colour_f32() -> None:
    """The program's netC at float32 compute, in this process."""
    import dataclasses

    from rgbd_pifuhd_tpu_torch.models.texture import TexPIFu

    orig = TexPIFu.__init__

    def init(self, cfg, *a, **kw):
        orig(self, dataclasses.replace(cfg, compute_dtype="float32"), *a,
             **kw)

    TexPIFu.__init__ = init


def main(argv) -> None:
    argv = list(argv)
    if "--colour-f32" in argv:
        argv.remove("--colour-f32")
        colour_f32()
    if "--fault" in argv:
        i = argv.index("--fault")
        if argv[i + 1] in faults_tex.TEX:
            faults_tex.apply(argv[i + 1])
            readings.main(argv[:i] + argv[i + 2:])
            return
    readings.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
