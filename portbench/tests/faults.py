"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false and for the readings that set the limits' upper
ends (``readings.py --fault <name>``).  Each ``apply(name)`` patches the
program in this process and returns an undo function."""

from __future__ import annotations


def _patch(obj, attr, new):
    # a class keeps its raw descriptor (a staticmethod stays one)
    old = obj.__dict__[attr] if isinstance(obj, type) else getattr(obj, attr)
    setattr(obj, attr, new)
    return lambda: setattr(obj, attr, old)


def levels_altered():
    """Every third octree band's levels altered where they are produced."""
    from rgbd_pifuhd_tpu_torch.recon import grid

    orig = grid.three_phase_p3_band
    n = [0]

    def altered(*a, **kw):
        out = orig(*a, **kw)
        n[0] += 1
        return out ^ 0x33 if n[0] % 3 == 0 else out

    return _patch(grid, "three_phase_p3_band", altered)


def half_surface():
    """The marcher given half of each slab's cells."""
    from rgbd_pifuhd_tpu_torch.recon import marching

    orig = marching.IncrementalMarcher3.step
    return _patch(marching.IncrementalMarcher3, "step",
                  lambda self, cells: orig(self, cells[:(len(cells) + 1)
                                                       // 2]))


def vertex_moved():
    """Every seventh vertex moved a third of a voxel at 64^3 as it is
    written."""
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    orig = Reconstructor._write_obj_streamed

    def moved(save_path, verts, job, faces_blob):
        v = verts.copy()
        v[::7] += 0.3 * 2.0 / 64
        return orig(save_path, v, job, faces_blob)

    return _patch(Reconstructor, "_write_obj_streamed", staticmethod(moved))


def colours_zeroed():
    """The colour pass's normals zeroed where they are produced."""
    import torch

    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    orig = Reconstructor._normals_one
    return _patch(Reconstructor, "_normals_one",
                  lambda self, *a: torch.zeros_like(orig(self, *a)))


def no_escalation(cut: int = 1):
    """The octree keeps its first budgets (cut by ``cut``): active cells
    past them are not refined."""
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    orig = Reconstructor.budgets

    def budgets(self, res):
        cells, sub = orig(self, res)
        return max(1, cells // cut), max(8, sub // cut)

    u1 = _patch(Reconstructor, "escalate", lambda self, *a: None)
    u2 = _patch(Reconstructor, "budgets", budgets)
    return lambda: (u1(), u2())


def state_unchanged():
    """The optimiser's step leaves the parameters as they are."""
    from rgbd_pifuhd_tpu_torch.train import trainers

    def frozen(self, closure=None):
        self.count += 1

    return _patch(trainers.RMSprop, "step", frozen)


def half_points():
    """The loss taken over half of the batch's points."""
    from rgbd_pifuhd_tpu_torch.models import coarse, multires

    orig = coarse.custom_bce

    def half(pred, gt, gamma, w=None, **kw):
        n = pred.shape[1] // 2
        return orig(pred[:, :n], gt[:, :n], gamma, w, **kw)

    u1 = _patch(coarse, "custom_bce", half)
    u2 = _patch(multires, "custom_bce", half)
    return lambda: (u1(), u2())


def labels_flipped():
    """Every fiftieth sample's label flipped where the reader makes it."""
    from rgbd_pifuhd_tpu_torch.data import datasets

    orig = datasets.sample_occupancy_points

    def flipped(*a, **kw):
        pts, lab = orig(*a, **kw)
        lab = lab.copy()
        lab[::50] = 1 - lab[::50]
        return pts, lab

    return _patch(datasets, "sample_occupancy_points", flipped)


SERVE = ("levels_altered", "half_surface", "vertex_moved", "colours_zeroed",
         "no_escalation")
TRAIN = ("state_unchanged", "half_points", "labels_flipped")


def apply(name: str, **kw):
    return globals()[name](**kw)
