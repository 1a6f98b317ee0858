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
    "kernel_launches",
    "reset_kernel_launches",
    "warp_planes",
    "warp_planes_reference",
]


def kernel_launches() -> dict:
    """The kernels' launch counts in this process (K1 includes its
    band-mode launches, K3 those fused with K4): the warps, then K1's
    zero-padding instantiation and the DCN's column gather."""
    from . import dcn, warp_cuda, warp_phases, warp_vjp

    return {"K1": warp_cuda.warp_planes.launches,
            "K1 band": warp_cuda.warp_planes.band_launches,
            "K1 window": warp_cuda.warp_planes_window.launches,
            "K2": warp_cuda.warp_rgb.launches,
            "K3": warp_vjp.warp_dimage.launches,
            "K3+K4": warp_vjp.warp_dimage.dflow_launches,
            "K4": warp_vjp.warp_dflow.launches,
            "K5": warp_phases.warp_phases.launches,
            "K1 zero": warp_cuda.warp_zero.launches,
            "DCN": dcn.dcn_columns.launches}


def reset_kernel_launches() -> None:
    """Set every count ``kernel_launches`` reads to 0."""
    from . import dcn, warp_cuda, warp_phases, warp_vjp

    for fn in (warp_cuda.warp_planes, warp_cuda.warp_planes_window,
               warp_cuda.warp_rgb, warp_vjp.warp_dimage, warp_vjp.warp_dflow,
               warp_phases.warp_phases, warp_cuda.warp_zero,
               dcn.dcn_columns):
        fn.launches = 0
    warp_cuda.warp_planes.band_launches = 0
    warp_vjp.warp_dimage.dflow_launches = 0
