"""rgbd_pifuhd_tpu_torch — the PyTorch/CUDA port of ``rgbd_pifuhd_tpu``.

The JAX package stays the reference; this package re-implements its main
path (single-subject ``Reconstructor.gen_mesh``) for an NVIDIA H100:

    ops/       geometry, resize, and the fused field query (CUDA kernel +
               plain PyTorch version)
    models/    nn.Modules named after the flax parameter tree
    recon/     octree grid evaluation, marching, mesh IO, the pipeline
    utils/     options, flax-checkpoint reader, device selection
    native/    C++ host kernels (marching cubes, OBJ IO), built on first use
    data/      the synthetic capsule subject and its NumPy rasteriser
    csrc/      CUDA sources, built with nvcc on first use

Layouts at every public boundary follow the JAX package (NHWC images and
features, ``[N, 3]`` points).  Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``; without a CUDA device they raise.
The package imports neither JAX nor anything of ``rgbd_pifuhd_tpu``.
"""

__version__ = "0.1.0"
