"""nn.Modules of the port, named after the flax parameter tree."""

from .blocks import ConvBlock, HGFilter, HourGlass
from .coarse import CoarseFeatures, CoarsePIFu, CoarseQueryOut
from .mlp import PointMLP
from .multires import FineFeatures, FineQueryOut, MultiResPIFu
from .pix2pix import GlobalGenerator
