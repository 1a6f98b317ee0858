from .color import (float32_to_uint8, quantize_uint8, rgb_to_ycbcr,
                    save_sequence)
from .degrade import bd_border_size, downsample_bd, imresize_matlab
from .resize import (
    apply_separable,
    get_upsampling_fn,
    resize_matrix,
    upsample_bilinear,
    upsample_tecogan_bicubic,
)
from .spatial import depth_to_space, space_to_depth
from .warp_cuda import warp_planes, warp_planes_reference

__all__ = [
    "apply_separable",
    "bd_border_size",
    "depth_to_space",
    "downsample_bd",
    "float32_to_uint8",
    "get_upsampling_fn",
    "imresize_matlab",
    "quantize_uint8",
    "resize_matrix",
    "rgb_to_ycbcr",
    "save_sequence",
    "space_to_depth",
    "upsample_bilinear",
    "upsample_tecogan_bicubic",
    "warp_planes",
    "warp_planes_reference",
]
