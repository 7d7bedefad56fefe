"""Faults planted in the texture pass underneath the timed path, for the
tests that see ``correct`` come out false and for the readings that set the
colour limits' upper ends (``readings_tex.py --fault <name>``).  Each
``apply(name)`` patches the program in this process and returns an undo
function."""

from __future__ import annotations

from portbench.tests.faults import _patch


def tex_half_chunks():
    """Half of each colour chunk's vertices left uncoloured (black)."""
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    orig = Reconstructor._tex_colors_one

    def half(self, verts, tex, calib):
        out = orig(self, verts, tex, calib).clone()
        out[len(out) // 2:] = 0
        return out

    return _patch(Reconstructor, "_tex_colors_one", half)


def tex_one_chunk():
    """The first 65,536-vertex colour chunk of each mesh left black: about
    2.6 % of a served mesh's vertices."""
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    orig = Reconstructor._tex_colors_one

    def first_black(self, verts, tex, calib):
        out = orig(self, verts, tex, calib)
        return out * 0 if self.color_calls == 1 else out

    return _patch(Reconstructor, "_tex_colors_one", first_black)


def tex_filter_zeroed():
    """netC's filter features zeroed where they are produced: the colours
    from netG's features and z alone."""
    import torch

    from rgbd_pifuhd_tpu_torch.models.texture import TexPIFu

    orig = TexPIFu.filter
    return _patch(TexPIFu, "filter",
                  lambda self, rgb: torch.zeros_like(orig(self, rgb)))


TEX = ("tex_half_chunks", "tex_one_chunk", "tex_filter_zeroed")


def apply(name: str, **kw):
    return globals()[name](**kw)
