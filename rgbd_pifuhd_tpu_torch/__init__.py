"""rgbd_pifuhd_tpu_torch — the PyTorch/CUDA port of ``rgbd_pifuhd_tpu``.

The JAX package stays the reference; this package re-implements its
inference (``Reconstructor.gen_mesh`` and the serving path) and its coarse
and fine training for an NVIDIA H100:

    ops/       geometry, resize, losses, and the fused field query and point
               MLP (CUDA kernels + plain PyTorch versions)
    models/    nn.Modules named after the flax parameter tree
    recon/     octree grid evaluation, marching, mesh IO, the pipeline
    train/     optimisers, train steps, the coarse and fine drivers
    utils/     options, flax checkpoints (read and written), device
               selection, PNG / JPEG codecs, OpenCV's image ops in NumPy
    native/    C++ host kernels (marching cubes, OBJ IO, the rasteriser),
               built on first use
    data/      readers (inference and training), synthetic training trees
    cli/       run_recon, serve, run_train
    csrc/      CUDA sources, built with nvcc on first use

Layouts at every public boundary follow the JAX package (NHWC images and
features, ``[N, 3]`` points).  Entry points run on ``cuda`` unless the
caller passes ``device='cpu'``; without a CUDA device they raise.
The package imports neither JAX nor anything of ``rgbd_pifuhd_tpu``.
"""

__version__ = "0.1.0"
