"""Counterpart of ``cvm_tpu.ops``: image ops, GT heatmap rendering, decoders,
SSIM and the two-frame warp, with the reference's package-level names
(``ops/cuda`` holds the hand-written kernels that replace
``cvm_tpu/ops/pallas``). The reference's ``bilinear_sample_mxu`` is a TPU
layout of ``bilinear_sample`` and is not ported (ROADMAP "Not to port")."""

from cvm_tpu_torch.ops.image import (  # noqa: F401
    Roi,
    letterbox_roi,
    sample_bilinear,
    sample_nearest,
    letterbox,
    normalize_imagenet,
    normalize_pm1,
    map_points_to_output,
    map_boxes_to_output,
)
from cvm_tpu_torch.ops.heatmap import (  # noqa: F401
    gaussian_radius,
    render_centernet_targets,
)
from cvm_tpu_torch.ops.decode import (  # noqa: F401
    decode_centernet,
    decode_centernet_3d,
    decode_centernet_with_extras,
    semseg_argmax,
    colorize_semseg,
    upsample_bilinear,
)
from cvm_tpu_torch.ops.image import chroma_roi, yuv_to_rgb  # noqa: F401
from cvm_tpu_torch.ops.ssim import ssim  # noqa: F401
from cvm_tpu_torch.ops.warp import (  # noqa: F401
    bilinear_sample,
    euler_to_matrix,
    scale_intrinsics,
    warp_frame,
)
